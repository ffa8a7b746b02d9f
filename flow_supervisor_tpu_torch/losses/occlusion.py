"""Occlusion estimation: forward-backward (brox) and range map (wang)
(counterpart of flow_supervisor_tpu/losses/occlusion.py). Flow channels are
(x, y) throughout.

- ``compute_range_map``: bilinear splat of how often each target pixel is
  sampled, out-of-bounds corners dropped (weight 0). One scatter-add per
  corner; on the card ``scatter_add`` sums in an order that changes from
  run to run, which only the clip of wang reads.
- brox: occluded where |f + b(w(f))|^2 > 0.01 (|f|^2 + |b(w(f))|^2) + 0.5,
  a hard threshold.
- wang: non-occluded weight = clip(range_map(backward_flow), 0, 1).
- ``compute_occlusions`` returns the NON-occlusion mask (1 = visible).
"""
from __future__ import annotations

import torch

from flow_supervisor_tpu_torch.ops.resampler import resampler
from flow_supervisor_tpu_torch.ops.warp import flow_to_warp


def mask_invalid(coords: torch.Tensor, pad_x=0, pad_y=0) -> torch.Tensor:
    """1 where (x, y) coords [B, H, W, 2] land inside [pad, size - 1], both
    bounds inclusive; pads are scalars or per sample [B]."""
    h, w = coords.shape[-3], coords.shape[-2]
    px = torch.as_tensor(pad_x, dtype=torch.float32, device=coords.device).reshape(-1, 1, 1)
    py = torch.as_tensor(pad_y, dtype=torch.float32, device=coords.device).reshape(-1, 1, 1)
    mask = (
        (coords[..., 0] >= px)
        & (coords[..., 0] <= w - 1)
        & (coords[..., 1] >= py)
        & (coords[..., 1] <= h - 1)
    )
    return mask.float()[..., None]


def compute_range_map(flow: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 2] flow -> [B, H, W, 1] sample-count map."""
    b, h, w, _ = flow.shape
    warp = flow_to_warp(flow.float())
    x, y = warp[..., 0], warp[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    counts = torch.zeros((b, h * w), dtype=torch.float32, device=flow.device)
    for cy in (0, 1):
        for cx in (0, 1):
            xi, yi = x0 + cx, y0 + cy
            wgt = (dx if cx else (1.0 - dx)) * (dy if cy else (1.0 - dy))
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (torch.clamp(yi, 0, h - 1).long() * w
                   + torch.clamp(xi, 0, w - 1).long()).reshape(b, -1)
            vals = torch.where(valid, wgt, torch.zeros_like(wgt)).reshape(b, -1)
            counts = counts.scatter_add(1, idx, vals)
    return counts.reshape(b, h, w, 1)


def compute_occlusions_brox(forward_flow: torch.Tensor, backward_flow: torch.Tensor):
    bwd_resampled = resampler(backward_flow, flow_to_warp(forward_flow))
    fb_sq_diff = torch.sum((forward_flow + bwd_resampled) ** 2, dim=-1, keepdim=True)
    fb_sum_sq = torch.sum(forward_flow**2 + bwd_resampled**2, dim=-1, keepdim=True)
    return (fb_sq_diff > 0.01 * fb_sum_sq + 0.5).float()


def compute_occlusions_wang(backward_flow: torch.Tensor):
    return 1.0 - torch.clamp(compute_range_map(backward_flow), 0.0, 1.0)


def compute_occlusions(forward_flow: torch.Tensor, backward_flow: torch.Tensor,
                       occlusion_estimation: str = "wang") -> torch.Tensor:
    """The non-occlusion mask [B, H, W, 1] (1 = visible) under wang | brox | none."""
    if occlusion_estimation == "none":
        return torch.ones_like(forward_flow[..., :1])
    if occlusion_estimation == "brox":
        occ = compute_occlusions_brox(forward_flow, backward_flow)
    elif occlusion_estimation == "wang":
        occ = compute_occlusions_wang(backward_flow)
    else:
        raise ValueError(f"unknown occlusion_estimation: {occlusion_estimation}")
    return 1.0 - occ
