"""Convex upsampling of a low-resolution flow with a learned 9-neighbour mask
(counterpart of flow_supervisor_tpu/ops/upsample.py).

The mask has 9*scale^2 channels laid out neighbour-major: channel n*scale^2 + g
with n = (row_shift+1)*3 + (col_shift+1) and g = sub_row*scale + sub_col.
Neighbours come from zero-padded 3x3 shifts; the softmax and the weighted sum
run in fp32; the result is cropped to ``out_size``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_convex(
    x: torch.Tensor,
    mask: torch.Tensor,
    out_size: tuple[int, int] | None = None,
    scale: int = 8,
    pre_padded: bool = False,
) -> torch.Tensor:
    """x: [B, H, W, C] low-res field; mask: [B, H, W, 9*scale^2] logits.

    Returns [B, out_h, out_w, C], out defaulting to (H*scale, W*scale).

    ``pre_padded``: x is [B, H+2, W+2, C] and already carries its 1-px halo
    (a crop window of a larger field with its true neighbours), so it is not
    zero-padded again."""
    if pre_padded:
        b, hp, wp, c = x.shape
        h, w = hp - 2, wp - 2
        xp = x.float()
    else:
        b, h, w, c = x.shape
        xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    s2 = scale * scale
    m = torch.softmax(mask.reshape(b, h, w, 9, s2).float(), dim=3)
    p = torch.stack(
        [xp[:, i : i + h, j : j + w] for i in range(3) for j in range(3)], dim=3
    )  # [B, H, W, 9, C]
    up = torch.einsum("bhwns,bhwnc->bhwsc", m, p)
    up = up.reshape(b, h, w, scale, scale, c).permute(0, 1, 3, 2, 4, 5)
    up = up.reshape(b, h * scale, w * scale, c)
    if out_size is not None:
        up = up[:, : out_size[0], : out_size[1]]
    return up.to(x.dtype)
