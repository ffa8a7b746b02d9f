"""Flow-based warping (counterpart of flow_supervisor_tpu/ops/warp.py).

``flow_to_warp`` turns a flow field into absolute sample coordinates
(grid + flow); ``warp_image`` backward-warps an image by a forward flow,
warped(p) = image(p + flow(p)), then applies the outgoing mask: 'zero'
zeroes pixels whose flow leaves the image, 'input' keeps the input image
there.
"""
from __future__ import annotations

import torch

from flow_supervisor_tpu_torch.ops.coords import coords_grid
from flow_supervisor_tpu_torch.ops.pad import create_outgoing_mask
from flow_supervisor_tpu_torch.ops.resampler import resampler


def flow_to_warp(flow: torch.Tensor) -> torch.Tensor:
    """Absolute (x, y) sample coordinates for a [B, H, W, 2] flow field."""
    b, h, w, _ = flow.shape
    return coords_grid(b, h, w, device=flow.device, dtype=flow.dtype) + flow


def warp_image(image: torch.Tensor, flow: torch.Tensor, occlusion: str = "zero") -> torch.Tensor:
    """Backward-warp ``image`` [B, H, W, C] by ``flow`` [B, H, W, 2] (x, y)."""
    warped = resampler(image, flow_to_warp(flow))
    mask = create_outgoing_mask(flow)
    if occlusion == "zero":
        return warped * mask
    if occlusion == "input":
        return warped * mask + image * (1.0 - mask)
    raise ValueError(f"unknown occlusion mode: {occlusion}")
