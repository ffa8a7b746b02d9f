"""Volume-free correlation lookup from the feature-map factors: kernels K6
and K7, counterpart of flow_supervisor_tpu/kernels/corr_fused.py
(``build_fused_pyramid`` / ``corr_pyramid_lookup_fused``).

The pyramid is kept as its factors: f1 [B, Q, C] (Q = h1 * w1 queries) and,
per level l, f2 average-pooled by 2^l as plain NHWC [B, h2_l, w2_l, C].
Nothing of size [B * Q, h2, w2] is ever stored. A lookup computes, for every
query and level, only the (2r+2)^2 correlations <f1[q], f2_l> / sqrt(C) at
the support of the window at coords / 2^l (fp32, never rounded to the compute
dtype), and their (2r+1)^2 bilinear window, out-of-bounds taps reading 0,
channels dx-major in level-major stripes: [B * Q, L * (2r+1)^2] in the
requested dtype (csrc/corr_fused.cu).

- B == 1: one launch for all levels (``corr_fused_all``, K6, replaces
  ``_fused_all_kernel``);
- B > 1: one launch per level, each writing its channel stripe
  (``corr_fused_level``, K7, replaces ``_fused_level_kernel``).

The TPU layout (grouped f2 factors, 128-lane and query padding, SMEM index
planes, one-hot combine matrices) and its VMEM-budget fallback are not
carried over.

Each wrapper takes the plain PyTorch version (``corr_fused_plain``: per-level
fp32 volumes by ``torch.matmul`` over chunks of queries, looked up by
``corr_plane.corr_lookup_plain``) only for CPU tensors; for CUDA tensors it
launches the kernel or raises. ``all_launches`` / ``level_launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from flow_supervisor_tpu_torch.kernels import _build
from flow_supervisor_tpu_torch.kernels.corr_plane import MAX_LEVELS, corr_lookup_plain
from flow_supervisor_tpu_torch.ops.corr import _avg_pool_fmap_same

all_launches = 0
level_launches = 0

PLAIN_CHUNK = 2048  # queries per plain matmul chunk: bounds its fp32 volume


class FusedPyramid(NamedTuple):
    """f1 [B, Q, C] and per level the pooled f2 [B, h2_l, w2_l, C], one dtype."""

    f1: torch.Tensor
    f2s: list[torch.Tensor]


def build_fused_pyramid(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4
) -> FusedPyramid:
    """Factors of the pyramid from NHWC feature maps: level l pools fmap2 by
    2^l (SAME, count-aware, cast back to the fmap dtype)."""
    b, h1, w1, c = fmap1.shape
    f2s = [fmap2.contiguous()]
    for lvl in range(1, num_levels):
        f2s.append(_avg_pool_fmap_same(fmap2, 2 ** lvl).contiguous())
    return FusedPyramid(fmap1.reshape(b, h1 * w1, c).contiguous(), f2s)


def corr_fused_plain(
    f1: torch.Tensor, f2s: list[torch.Tensor], coords: torch.Tensor, radius: int = 4,
    out_dtype=torch.float32, first_level: int = 0,
) -> torch.Tensor:
    """Plain K6/K7: f1 [B, Q, C], f2s[i] the pooled f2 of level first_level + i,
    coords [B * Q, 2] fp32 at level 0 -> [B * Q, len(f2s) * (2r+1)^2]."""
    b, q, c = f1.shape
    coords = coords.float() * (1.0 / 2.0 ** first_level)
    root_c = torch.sqrt(torch.tensor(float(c)))
    outs = []
    for bi in range(b):
        cols = [f2[bi].reshape(-1, c).float().t() for f2 in f2s]
        for q0 in range(0, q, PLAIN_CHUNK):
            rows = f1[bi, q0 : q0 + PLAIN_CHUNK].float()
            planes = [
                (torch.matmul(rows, col) / root_c).reshape(rows.shape[0], f2.shape[1], f2.shape[2])
                for col, f2 in zip(cols, f2s)
            ]
            cq = coords[bi * q + q0 : bi * q + q0 + rows.shape[0]]
            outs.append(corr_lookup_plain(planes, cq, radius, torch.float32))
    return torch.cat(outs, dim=0).to(out_dtype)


def _check_args(what, f1, f2s, coords, radius):
    if f1.dim() != 3 or not f1.is_contiguous() or f1.numel() == 0:
        raise ValueError(f"{what}: f1 must be a non-empty contiguous [B, Q, C], got {tuple(f1.shape)}")
    _build.dtype_code(f1)
    b, q, c = f1.shape
    for f2 in f2s:
        if f2.dim() != 4 or f2.shape[0] != b or f2.shape[3] != c or f2.numel() == 0 \
                or not f2.is_contiguous() or f2.dtype != f1.dtype:
            raise ValueError(
                f"{what}: f2 levels must be non-empty contiguous [{b}, h2, w2, {c}] {f1.dtype}, "
                f"got {f2.dtype} {tuple(f2.shape)}"
            )
    if coords.shape != (b * q, 2) or coords.dtype != torch.float32 or not coords.is_contiguous():
        raise ValueError(
            f"{what}: coords must be contiguous float32 [{b * q}, 2], got "
            f"{coords.dtype} {tuple(coords.shape)}"
        )
    if radius < 0:
        raise ValueError(f"{what}: radius must be >= 0, got {radius}")


def corr_fused_all(
    f1: torch.Tensor, f2s: list[torch.Tensor], coords: torch.Tensor, radius: int = 4,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """K6: all levels in one launch -> [B * Q, L * (2r+1)^2] in out_dtype."""
    global all_launches
    _check_args("corr_fused_all", f1, f2s, coords, radius)
    if not 1 <= len(f2s) <= MAX_LEVELS:
        raise ValueError(f"corr_fused_all: 1..{MAX_LEVELS} levels, got {len(f2s)}")
    if not _build.uses_kernel("corr_fused_all", f1, coords, *f2s):
        return corr_fused_plain(f1, f2s, coords, radius, out_dtype)
    b, q, c = f1.shape
    nl = len(f2s)
    out = torch.empty((b * q, nl * (2 * radius + 1) ** 2), dtype=out_dtype, device=f1.device)
    ptrs = (ctypes.c_void_p * nl)(*[f2.data_ptr() for f2 in f2s])
    h2s = (ctypes.c_int * nl)(*[f2.shape[1] for f2 in f2s])
    w2s = (ctypes.c_int * nl)(*[f2.shape[2] for f2 in f2s])
    with torch.cuda.device(f1.device):
        rc = _build.lib().fst_corr_fused_all(
            f1.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(h2s, ctypes.c_void_p),
            ctypes.cast(w2s, ctypes.c_void_p), nl, coords.data_ptr(), out.data_ptr(),
            b * q, q, c, radius, _build.dtype_code(f1), _build.dtype_code(out),
            _build.stream_of(f1),
        )
    _build.check(rc, "corr_fused_all")
    all_launches += 1
    return out


def corr_fused_level(
    f1: torch.Tensor, f2: torch.Tensor, level: int, coords: torch.Tensor, radius: int,
    out: torch.Tensor,
) -> None:
    """K7: level ``level`` (f2 pooled by 2^level) into channels
    [level * (2r+1)^2, (level+1) * (2r+1)^2) of out [B * Q, >= that]."""
    global level_launches
    _check_args("corr_fused_level", f1, [f2], coords, radius)
    k2 = (2 * radius + 1) ** 2
    if not 0 <= level < MAX_LEVELS or out.dim() != 2 or out.shape[0] != coords.shape[0] \
            or out.shape[1] < (level + 1) * k2 or not out.is_contiguous():
        raise ValueError(
            f"corr_fused_level: level {level} needs out contiguous [{coords.shape[0]}, "
            f">= {(level + 1) * k2}], got {tuple(out.shape)}"
        )
    _build.dtype_code(out)
    if not _build.uses_kernel("corr_fused_level", f1, f2, coords, out):
        out[:, level * k2 : (level + 1) * k2] = corr_fused_plain(
            f1, [f2], coords, radius, out.dtype, first_level=level
        )
        return
    b, q, c = f1.shape
    with torch.cuda.device(f1.device):
        rc = _build.lib().fst_corr_fused_level(
            f1.data_ptr(), f2.data_ptr(), f2.shape[1], f2.shape[2], level, coords.data_ptr(),
            out.data_ptr(), out.shape[1], b * q, q, c, radius, _build.dtype_code(f1),
            _build.dtype_code(out), _build.stream_of(f1),
        )
    _build.check(rc, "corr_fused_level")
    level_launches += 1


def corr_pyramid_lookup_fused(
    pyramid: FusedPyramid, coords: torch.Tensor, radius: int = 4, out_dtype=torch.float32,
) -> torch.Tensor:
    """coords [B, h1, w1, 2] -> [B, h1, w1, L * (2r+1)^2]: K6 at B == 1, K7
    per level at B > 1 (the JAX package's dispatch)."""
    b, h1, w1, _ = coords.shape
    flat = coords.reshape(b * h1 * w1, 2).float().contiguous()
    if b == 1:
        out = corr_fused_all(pyramid.f1, pyramid.f2s, flat, radius, out_dtype)
    else:
        k2 = (2 * radius + 1) ** 2
        out = torch.empty((flat.shape[0], len(pyramid.f2s) * k2), dtype=out_dtype, device=flat.device)
        for lvl, f2 in enumerate(pyramid.f2s):
            corr_fused_level(pyramid.f1, f2, lvl, flat, radius, out)
    return out.reshape(b, h1, w1, -1)
