"""Coordinate grids and flow resizing (counterpart of flow_supervisor_tpu/ops/coords.py).

Grids are channel-last [B, H, W, 2] with channel 0 = x (column) and
channel 1 = y (row); flows are (u, v) in the same order.
"""
from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, device=None, dtype=torch.float32,
                row0: int = 0):
    """[batch, ht, wd, 2] grid with g[..., 0] = x (col) and g[..., 1] = y (row),
    the rows starting at ``row0`` (a space shard's first row,
    parallel/spatial.py ``first_row``: query positions stay absolute)."""
    y, x = torch.meshgrid(
        torch.arange(row0, row0 + ht, device=device), torch.arange(wd, device=device),
        indexing="ij",
    )
    g = torch.stack([x, y], dim=-1).to(dtype)
    return g[None].expand(batch, ht, wd, 2)


def downsample_shape(size: int, factor: int = 8) -> int:
    """Spatial size at 1/factor resolution via repeated ceil-div by 2."""
    s, f = size, factor
    while f > 1:
        s = -(-s // 2)
        f //= 2
    return s


def initialize_coords(batch: int, ht: int, wd: int, device=None, dtype=torch.float32):
    """(coords0, coords1) at 1/8 of an (ht, wd) image; flow = coords1 - coords0."""
    c = coords_grid(batch, downsample_shape(ht), downsample_shape(wd), device, dtype)
    return c, c


def _resample_axis(im: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """TF half-pixel bilinear sampling along one axis, edge-clamped, with no
    antialiasing (tf.image.resize(method='bilinear', antialias=False))."""
    in_size = im.shape[axis]
    scale = in_size / out_size
    pos = (torch.arange(out_size, dtype=torch.float32, device=im.device) + 0.5) * scale - 0.5
    lo = torch.clamp(torch.floor(pos), 0, in_size - 1).long()
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    w = torch.clamp(pos - lo.float(), 0.0, 1.0)
    a = torch.index_select(im, axis, lo).float()
    b = torch.index_select(im, axis, hi).float()
    shape = [1] * im.dim()
    shape[axis] = out_size
    w = w.reshape(shape)
    return a * (1.0 - w) + b * w


def resize_image(im: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Resize NHWC to (H, W) with TF-exact half-pixel bilinear (no antialias)."""
    if im.shape[1] == size[0] and im.shape[2] == size[1]:
        return im
    out = _resample_axis(im, 1, size[0])
    out = _resample_axis(out, 2, size[1])
    return out.to(im.dtype)


def resize_flow(flow: torch.Tensor, size: tuple[int, int], scaling: bool = True) -> torch.Tensor:
    """Bilinearly resize a flow field [B, H, W, 2], optionally scaling the
    vectors by the resize ratio."""
    h, w = flow.shape[1], flow.shape[2]
    out = resize_image(flow, size)
    if scaling:
        scale = torch.tensor(
            [size[1] / float(w), size[0] / float(h)], dtype=flow.dtype, device=flow.device
        )
        out = out * scale
    return out
