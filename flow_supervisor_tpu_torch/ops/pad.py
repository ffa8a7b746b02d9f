"""Padding and per-sample cropping (counterpart of pad_spec_for /
pad_to_multiple / unpad / crop_bboxes / pad_bboxes in
flow_supervisor_tpu/ops/pad.py).

- Evaluation-time replicate-edge padding to a multiple of 8: 'sintel' mode
  centres the pad both ways; 'kitti' mode puts the height pad at the bottom
  and centres the width pad.
- ``crop_bboxes`` / ``pad_bboxes``: crop a window from, or zero-pad into, a
  full-image frame at each sample's own (y, x) offset, the batch dimension
  written out where JAX has ``vmap``. Offsets are clamped as
  ``lax.dynamic_slice`` / ``dynamic_update_slice`` clamp them, so the window
  always lies inside the frame. Both are gathers / scatters on the offsets'
  device: no host synchronisation, differentiable.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_spec_for(ht: int, wd: int, mode: str = "sintel", multiple: int = 8):
    """((top, bottom), (left, right)) pad amounts to reach a multiple."""
    m = multiple
    pad_ht = (((ht // m) + 1) * m - ht) % m
    pad_wd = (((wd // m) + 1) * m - wd) % m
    if mode == "sintel":
        return (pad_ht // 2, pad_ht - pad_ht // 2), (pad_wd // 2, pad_wd - pad_wd // 2)
    return (0, pad_ht), (pad_wd // 2, pad_wd - pad_wd // 2)


def pad_to_multiple(x: torch.Tensor, mode: str = "sintel", multiple: int = 8):
    """Replicate-edge pad NHWC to a multiple; returns (padded, spec)."""
    spec = pad_spec_for(x.shape[1], x.shape[2], mode, multiple)
    (t, b), (l, r) = spec
    out = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b), mode="replicate")
    return out.permute(0, 2, 3, 1), spec


def unpad(x: torch.Tensor, spec) -> torch.Tensor:
    (t, b), (l, r) = spec
    return x[:, t : x.shape[1] - b, l : x.shape[2] - r]


def _window_index(offsets: torch.Tensor, size: tuple[int, int], frame: tuple[int, int], device):
    """(batch, rows, cols) index tensors of each sample's (h, w) window in an
    (H, W) frame. As in ``lax.dynamic_slice``, a negative start counts from
    the end, then the start is clamped to [0, H - h] x [0, W - w]."""
    (h, w), (fh, fw) = size, frame
    off = offsets.to(device=device, dtype=torch.long)
    dims = torch.tensor([fh, fw], device=device)
    off = torch.where(off < 0, off + dims, off)
    y0 = off[:, 0].clamp(0, fh - h)
    x0 = off[:, 1].clamp(0, fw - w)
    rows = y0[:, None, None] + torch.arange(h, device=device)[None, :, None]
    cols = x0[:, None, None] + torch.arange(w, device=device)[None, None, :]
    batch = torch.arange(off.shape[0], device=device)[:, None, None]
    return batch, rows, cols


def crop_bboxes(images: torch.Tensor, offsets: torch.Tensor, target_size: tuple[int, int]):
    """images [B, H, W, C], offsets [B, 2] int (y, x) -> [B, h, w, C]."""
    idx = _window_index(offsets, target_size, images.shape[1:3], images.device)
    return images[idx]


def pad_bboxes(images: torch.Tensor, offsets: torch.Tensor, target_size: tuple[int, int]):
    """images [B, ih, iw, C] zero-padded into a [B, h, w, C] canvas at offsets
    [B, 2] int (y, x)."""
    b, ih, iw, c = images.shape
    canvas = images.new_zeros((b, *target_size, c))
    idx = _window_index(offsets, (ih, iw), target_size, images.device)
    return canvas.index_put(idx, images)
