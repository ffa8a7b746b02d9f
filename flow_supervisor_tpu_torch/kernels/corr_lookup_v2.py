"""Window lookup of the pallas backend from materialized planes: kernel K10,
counterpart of flow_supervisor_tpu/kernels/corr_lookup_v2.py
(``corr_pyramid_lookup_v2``, the ``"pallas"`` lookup backend).

The planes are the plain per-level [BQ, h2_l, w2_l] planes of
``corr_plane.build_plane_pyramid``; the TPU's bottom padding to the band
height, 128-query padding and 16-lane support width are not needed. The TPU
kernel writes each level's (2r+2)^2 support patches at coords / 2^l and XLA
fuses the 4-tap bilinear combine, the dx-major reorder and the level concat
behind it; here ``corr_pyramid_lookup_v2`` is one launch for all of that, all
levels, fp32 out (csrc/corr_window.cu in window mode, replaces
``_window_kernel``; the body is csrc/window.cuh's, shared with K1 and K11).
``level_support``, the TPU kernel's own output for one level, is the same
body in support mode.

``corr_pyramid_lookup_v2`` is differentiable in the planes, as JAX's custom
VJP makes it: the backward is K12 (``corr_plane.lookup_bwd``, fp32
cotangent in, the planes' dtype out), coords get no gradient.

The wrappers take the plain PyTorch versions (``ops.corr.window_support``, a
gather with a validity mask, and ``combine_support``) only for CPU tensors;
for CUDA tensors they launch the kernel or raise. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from flow_supervisor_tpu_torch.kernels import _build
from flow_supervisor_tpu_torch.kernels.corr_plane import (
    PlaneLookup,
    _check_args,
    corr_lookup_plain,
    level_arrays,
    window_fits,
)
from flow_supervisor_tpu_torch.ops.corr import window_support

launches = 0


def level_support(plane: torch.Tensor, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """K10 in support mode: plane [BQ, h2, w2], coords [BQ, 2] fp32 at the
    level's scale -> [BQ, 2r+2, 2r+2] fp32 support patches [y, x]."""
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
    """K10 in window mode: coords [B, h1, w1, 2] -> [B, h1, w1, L * (2r+1)^2]
    fp32 (dx-major per level), one launch for all levels; differentiable in
    the planes (backward K12)."""
    b, h1, w1, _ = coords.shape
    flat = coords.reshape(b * h1 * w1, 2).float().contiguous()
    _check_args(planes, flat, radius)
    if not window_fits(len(planes), radius):
        raise ValueError(f"corr_pyramid_lookup_v2: radius {radius} at {len(planes)} levels "
                         f"needs more shared memory than a block has")
    out = PlaneLookup.apply(_lookup_k10, flat, radius, torch.float32, *planes)
    return out.reshape(b, h1, w1, -1)


def _lookup_k10(planes, flat, radius, out_dtype):
    global launches
    if not _build.uses_kernel("corr_pyramid_lookup_v2", flat, *planes):
        return corr_lookup_plain(planes, flat, radius)
    bq, nl = flat.shape[0], len(planes)
    out = torch.empty((bq, nl * (2 * radius + 1) ** 2), dtype=torch.float32, device=flat.device)
    with torch.cuda.device(flat.device):
        rc = _build.lib().fst_corr_window_lookup(
            *level_arrays(planes), nl, flat.data_ptr(), out.data_ptr(), bq, radius,
            _build.dtype_code(planes[0]), _build.stream_of(flat),
        )
    _build.check(rc, "corr_pyramid_lookup_v2")
    launches += 1
    return out
