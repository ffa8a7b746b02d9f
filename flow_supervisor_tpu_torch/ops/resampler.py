"""Safe bilinear resampler (counterpart of flow_supervisor_tpu/ops/resampler.py).

Each of the four corner taps contributes 0 when it lies outside the image,
so samples fade linearly to zero across the border instead of clamping (the
edge semantics of ``tfa.image.resampler``). Warp coordinates are
channel-last (x, y): x indexes width, y height. The four taps are explicit
gathers over the flattened spatial axis; the floor and the indices carry no
gradient, the tap weights do (as in JAX). Computed in fp32, returned in the
data's dtype.
"""
from __future__ import annotations

import torch


def resampler(data: torch.Tensor, warp: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``data`` [B, H, W, C] at ``warp`` [B, ..., 2] (x, y)
    -> [B, ..., C]; out-of-bounds corner taps contribute zero."""
    b, h, w, c = data.shape
    out_shape = warp.shape[:-1] + (c,)
    q = warp.reshape(b, -1, 2).float()
    x, y = q[..., 0], q[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    flat = data.reshape(b, h * w, c)

    def tap(xi, yi, wgt):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = torch.clamp(yi, 0, h - 1).long() * w + torch.clamp(xi, 0, w - 1).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
        return vals.float() * wgt[..., None]

    out = (
        tap(x0, y0, (1.0 - dx) * (1.0 - dy))
        + tap(x0 + 1.0, y0, dx * (1.0 - dy))
        + tap(x0, y0 + 1.0, (1.0 - dx) * dy)
        + tap(x0 + 1.0, y0 + 1.0, dx * dy)
    )
    return out.to(data.dtype).reshape(out_shape)
