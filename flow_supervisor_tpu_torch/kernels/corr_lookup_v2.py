"""Support-patch window lookup from materialized planes: kernel K10,
counterpart of flow_supervisor_tpu/kernels/corr_lookup_v2.py
(``corr_pyramid_lookup_v2``, the ``"pallas"`` lookup backend).

The planes are the plain per-level [BQ, h2_l, w2_l] planes of
``corr_plane.build_plane_pyramid``; the TPU's bottom padding to the band
height, 128-query padding and 16-lane support width are not needed. Per
level, ``level_support`` writes each query's (2r+2)^2 support patch at
coords / 2^l in fp32, out-of-bounds taps 0 (csrc/corr_window.cu, replaces
``_window_kernel`` behind ``_level_support``). The 4-tap bilinear combine,
the dx-major reorder and the level concat stay plain PyTorch, as in the JAX
package.

The wrapper takes the plain PyTorch version (a gather with a validity mask,
``ops.corr.window_support``) only for CPU tensors; for CUDA tensors it
launches the kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from flow_supervisor_tpu_torch.kernels import _build
from flow_supervisor_tpu_torch.ops.corr import combine_support, window_support

launches = 0


def level_support(plane: torch.Tensor, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """K10: plane [BQ, h2, w2], coords [BQ, 2] fp32 at the level's scale ->
    [BQ, 2r+2, 2r+2] fp32 support patches [y, x]."""
    global launches
    if plane.dim() != 3 or not plane.is_contiguous() or plane.numel() == 0:
        raise ValueError(f"level_support: plane must be a non-empty contiguous [BQ, h2, w2], "
                         f"got {tuple(plane.shape)}")
    _build.dtype_code(plane)
    bq, h2, w2 = plane.shape
    if coords.shape != (bq, 2) or coords.dtype != torch.float32 or not coords.is_contiguous():
        raise ValueError(f"level_support: coords must be contiguous float32 [{bq}, 2], got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    if radius < 0:
        raise ValueError(f"level_support: radius must be >= 0, got {radius}")
    if not _build.uses_kernel("level_support", plane, coords):
        return window_support(plane, coords, radius)
    sup = 2 * radius + 2
    out = torch.empty((bq, sup, sup), dtype=torch.float32, device=plane.device)
    with torch.cuda.device(plane.device):
        rc = _build.lib().fst_corr_window(
            plane.data_ptr(), h2, w2, coords.data_ptr(), out.data_ptr(), bq, radius,
            _build.dtype_code(plane), _build.stream_of(plane),
        )
    _build.check(rc, "level_support")
    launches += 1
    return out


def corr_pyramid_lookup_v2(
    planes: list[torch.Tensor], coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """coords [B, h1, w1, 2] -> [B, h1, w1, L * (2r+1)^2] fp32 (dx-major per
    level): K10 per level, then the combine in PyTorch."""
    b, h1, w1, _ = coords.shape
    flat = coords.reshape(b * h1 * w1, 2).float()
    outs = []
    for lvl, plane in enumerate(planes):
        c = (flat * (1.0 / 2.0 ** lvl)).contiguous()
        outs.append(combine_support(level_support(plane, c, radius), c, radius))
    return torch.cat(outs, dim=1).reshape(b, h1, w1, -1)
