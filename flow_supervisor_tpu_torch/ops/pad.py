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
- ``central_pad`` / ``central_crop``: zero-pad to, or crop to, a size
  centred in the frame.
- ``create_outgoing_mask``: 1 where grid + flow stays inside the image.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from flow_supervisor_tpu_torch.ops.coords import coords_grid


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


def central_pad(images: torch.Tensor, target_size: tuple[int, int]) -> torch.Tensor:
    """Zero-pad NHWC to target_size, centred (the odd pixel after)."""
    h, w = target_size
    ih, iw = images.shape[1], images.shape[2]
    y, x = (h - ih) // 2, (w - iw) // 2
    return F.pad(images, (0, 0, x, w - x - iw, y, h - y - ih))


def central_crop(images: torch.Tensor, target_size: tuple[int, int]) -> torch.Tensor:
    h, w = target_size
    ih, iw = images.shape[1], images.shape[2]
    y, x = (ih - h) // 2, (iw - w) // 2
    return images[:, y : y + h, x : x + w]


def create_outgoing_mask(flow: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 1] mask, 1 where grid + flow stays inside the image."""
    h, w = flow.shape[-3], flow.shape[-2]
    pos = coords_grid(1, h, w, device=flow.device, dtype=flow.dtype)[0] + flow
    inside = (
        (pos[..., 0] >= 0.0)
        & (pos[..., 0] <= w - 1.0)
        & (pos[..., 1] >= 0.0)
        & (pos[..., 1] <= h - 1.0)
    )
    return inside.to(flow.dtype)[..., None]
