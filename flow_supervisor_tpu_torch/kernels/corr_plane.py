"""Correlation lookup from materialized per-level planes: kernel K1,
counterpart of flow_supervisor_tpu/kernels/corr_plane.py
(``build_packed_pyramid`` / ``corr_pyramid_lookup_plane``).

The pyramid is built once per forward as plain per-level planes
[BQ, h2_l, w2_l] (BQ = B * h1 * w1 queries; the TPU's 128-lane group packing,
row padding and index planes are not needed on the GPU). Each lookup samples,
for every query and level, the (2r+1)^2 bilinear window at coords / 2^l with
out-of-bounds taps reading 0, channels dx-major: [BQ, L * (2r+1)^2] in the
requested dtype (csrc/corr_plane.cu, replaces ``_plane_kernel``).

The wrapper takes the plain PyTorch version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from flow_supervisor_tpu_torch.kernels import _build
from flow_supervisor_tpu_torch.ops.corr import (
    build_corr_pyramid_from_fmaps,
    combine_support,
    window_support,
)

launches = 0

MAX_LEVELS = 8  # csrc/corr_plane.cu kMaxLevels


def build_plane_pyramid(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4,
    out_dtype=torch.float32,
) -> list[torch.Tensor]:
    """Per-level planes [B*h1*w1, h2_l, w2_l] from NHWC feature maps."""
    vols = build_corr_pyramid_from_fmaps(fmap1, fmap2, num_levels, out_dtype)
    return [v.reshape(-1, v.shape[3], v.shape[4]).contiguous() for v in vols]


def corr_lookup_plain(
    planes: list[torch.Tensor], coords: torch.Tensor, radius: int = 4,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch K1: planes [BQ, h2, w2] per level, coords [BQ, 2] fp32
    (x, y) at level 0 -> [BQ, L * (2r+1)^2] in out_dtype."""
    outs = []
    for lvl, plane in enumerate(planes):
        c = coords.float() * (1.0 / 2.0 ** lvl)
        outs.append(combine_support(window_support(plane, c, radius), c, radius))
    return torch.cat(outs, dim=1).to(out_dtype)


def _check_args(planes, coords, radius):
    if not 1 <= len(planes) <= MAX_LEVELS:
        raise ValueError(f"corr_lookup: 1..{MAX_LEVELS} levels, got {len(planes)}")
    if coords.dim() != 2 or coords.shape[1] != 2 or coords.dtype != torch.float32 \
            or not coords.is_contiguous() or coords.shape[0] == 0:
        raise ValueError(
            f"corr_lookup: coords must be contiguous float32 [BQ, 2], got "
            f"{coords.dtype} {tuple(coords.shape)}"
        )
    bq = coords.shape[0]
    for p in planes:
        if p.dim() != 3 or p.shape[0] != bq or not p.is_contiguous() \
                or p.dtype != planes[0].dtype:
            raise ValueError(
                f"corr_lookup: planes must be contiguous [{bq}, h2, w2] of one dtype, "
                f"got {p.dtype} {tuple(p.shape)}"
            )
        _build.dtype_code(p)
    if radius < 0:
        raise ValueError(f"corr_lookup: radius must be >= 0, got {radius}")


def corr_lookup(
    planes: list[torch.Tensor], coords: torch.Tensor, radius: int = 4,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """K1: window lookup over all levels -> [BQ, L * (2r+1)^2] in out_dtype."""
    global launches
    _check_args(planes, coords, radius)
    if not _build.uses_kernel("corr_lookup", coords, *planes):
        return corr_lookup_plain(planes, coords, radius, out_dtype)
    bq, nl = coords.shape[0], len(planes)
    k2 = (2 * radius + 1) ** 2
    out = torch.empty((bq, nl * k2), dtype=out_dtype, device=coords.device)
    ptrs = (ctypes.c_void_p * nl)(*[p.data_ptr() for p in planes])
    h2s = (ctypes.c_int * nl)(*[p.shape[1] for p in planes])
    w2s = (ctypes.c_int * nl)(*[p.shape[2] for p in planes])
    with torch.cuda.device(coords.device):
        rc = _build.lib().fst_corr_plane_lookup(
            ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(h2s, ctypes.c_void_p),
            ctypes.cast(w2s, ctypes.c_void_p), nl, coords.data_ptr(), out.data_ptr(),
            bq, radius, _build.dtype_code(planes[0]), _build.dtype_code(out),
            _build.stream_of(coords),
        )
    _build.check(rc, "corr_lookup")
    launches += 1
    return out


def corr_pyramid_lookup_plane(
    planes: list[torch.Tensor], coords: torch.Tensor, radius: int = 4,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """coords [B, h1, w1, 2] -> [B, h1, w1, L * (2r+1)^2] (dx-major per level)."""
    b, h1, w1, _ = coords.shape
    flat = coords.reshape(b * h1 * w1, 2).float().contiguous()
    return corr_lookup(planes, flat, radius, out_dtype).reshape(b, h1, w1, -1)
