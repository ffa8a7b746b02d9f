"""Correlation lookup from materialized per-level planes: kernel K1,
counterpart of flow_supervisor_tpu/kernels/corr_plane.py
(``build_packed_pyramid`` / ``corr_pyramid_lookup_plane``).

The pyramid is built once per forward as plain per-level planes
[BQ, h2_l, w2_l] (BQ = B * h1 * w1 queries; the TPU's 128-lane group packing,
row padding and index planes are not needed on the GPU). Each lookup samples,
for every query and level, the (2r+1)^2 bilinear window at coords / 2^l with
out-of-bounds taps reading 0, channels dx-major: [BQ, L * (2r+1)^2] in the
requested dtype (csrc/corr_plane.cu, replaces ``_plane_kernel``; the body
is csrc/window.cuh's, shared with K10 and K11).

The lookup is differentiable in the planes (``corr_lookup`` is a
``torch.autograd.Function``, JAX's custom VJP ``_lookup``): its backward is
``lookup_bwd``, kernel K12 (csrc/corr_plane_bwd.cu), which writes every
query's plane cotangent, zero but at its support taps, and gives coords no
gradient (they are detached at every call site). Nothing plane-sized is kept
for the backward: only coords and the planes' shapes and dtype. The plane
build's ``torch.matmul`` carries the cotangent on to the feature maps.
K10's lookup (kernels/corr_lookup_v2.py) takes the same backward.

The wrappers take the plain PyTorch versions only for CPU tensors; for CUDA
tensors they launch the kernel or raise. ``launches`` counts K1's launches,
``bwd_launches`` K12's.
"""
from __future__ import annotations

import ctypes

import torch

from flow_supervisor_tpu_torch.kernels import _build
from flow_supervisor_tpu_torch.ops.corr import (
    build_corr_pyramid_from_fmaps,
    combine_support,
    lookup_vjp_dvols,
    window_support,
)

launches = 0
bwd_launches = 0

MAX_LEVELS = 8  # csrc/window.cuh kMaxLevels
WARPS = 8  # csrc/window.cuh kWarps: queries per block
# shared memory a block may opt in to on sm_90, the library's only target
SMEM_OPTIN_BYTES = 227 * 1024


def window_fits(levels: int, radius: int) -> bool:
    """Whether a window-mode launch of csrc/window.cuh (K1, K10, K11) finds
    room for its blocks' supports: 8 warps x levels x (2r+2) x (2r+3) fp32."""
    s = 2 * radius + 2
    return WARPS * levels * s * (s + 1) * 4 <= SMEM_OPTIN_BYTES


def level_arrays(planes: list[torch.Tensor]):
    """The per-level arguments of window.cuh's C entries: (plane pointers,
    h2s, w2s) as ctypes arrays of [BQ, h2, w2] tensors (a volume [B, h1, w1,
    h2, w2] is read as one)."""
    nl = len(planes)
    ptrs = (ctypes.c_void_p * nl)(*[p.data_ptr() for p in planes])
    h2s = (ctypes.c_int * nl)(*[p.shape[-2] for p in planes])
    w2s = (ctypes.c_int * nl)(*[p.shape[-1] for p in planes])
    return tuple(ctypes.cast(a, ctypes.c_void_p) for a in (ptrs, h2s, w2s))


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


def bwd_fits(levels: int, radius: int) -> bool:
    """Whether K12 finds room for its blocks' support cotangents: 8 warps x
    levels x (2r+2)^2 fp32."""
    s = 2 * radius + 2
    return WARPS * levels * s * s * 4 <= SMEM_OPTIN_BYTES


def lookup_bwd(
    g: torch.Tensor, coords: torch.Tensor, shapes, radius: int = 4, out_dtype=torch.float32,
) -> list[torch.Tensor]:
    """K12: the planes' cotangent of a window lookup. g [BQ, L * (2r+1)^2]
    (fp32 or bf16, dx-major), coords [BQ, 2] fp32 at level 0, shapes [(h2,
    w2)] per level -> d_plane [BQ, h2, w2] per level in out_dtype (the plain
    version is ``ops.corr.lookup_vjp_dvols``, whose dtype rule it follows)."""
    global bwd_launches
    nl, k2 = len(shapes), (2 * radius + 1) ** 2
    if not 1 <= nl <= MAX_LEVELS:
        raise ValueError(f"lookup_bwd: 1..{MAX_LEVELS} levels, got {nl}")
    if radius < 0 or not bwd_fits(nl, radius):
        raise ValueError(f"lookup_bwd: radius {radius} at {nl} levels does not fit a block")
    if coords.dim() != 2 or coords.shape[1] != 2 or coords.dtype != torch.float32 \
            or not coords.is_contiguous() or coords.shape[0] == 0:
        raise ValueError(f"lookup_bwd: coords must be contiguous float32 [BQ, 2], got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    bq = coords.shape[0]
    if g.shape != (bq, nl * k2) or not g.is_contiguous():
        raise ValueError(f"lookup_bwd: g must be contiguous [{bq}, {nl * k2}], got "
                         f"{tuple(g.shape)}")
    _build.dtype_code(g)
    if not _build.uses_kernel("lookup_bwd", coords, g):
        return lookup_vjp_dvols(g, coords, shapes, radius, out_dtype)
    outs = [torch.empty((bq, h2, w2), dtype=out_dtype, device=g.device) for h2, w2 in shapes]
    with torch.cuda.device(g.device):
        rc = _build.lib().fst_corr_plane_bwd(
            *level_arrays(outs), nl, coords.data_ptr(), g.data_ptr(), bq, radius,
            _build.dtype_code(g), _build.dtype_code(outs[0]), _build.stream_of(g),
        )
    _build.check(rc, "lookup_bwd")
    bwd_launches += 1
    return outs


class PlaneLookup(torch.autograd.Function):
    """A window lookup differentiable in its planes: ``forward_fn(planes,
    coords, radius, out_dtype)`` forward (K1 or K10), K12 backward; coords
    get no gradient. Residuals: coords, the planes' shapes and dtype."""

    @staticmethod
    def forward(ctx, forward_fn, coords, radius, out_dtype, *planes):
        ctx.save_for_backward(coords)
        ctx.radius = radius
        ctx.shapes = [tuple(p.shape[1:]) for p in planes]
        ctx.plane_dtype = planes[0].dtype
        return forward_fn(list(planes), coords, radius, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        g = g.reshape(coords.shape[0], -1).contiguous()
        d_planes = lookup_bwd(g, coords, ctx.shapes, ctx.radius, ctx.plane_dtype)
        return (None, None, None, None, *d_planes)


def corr_lookup(
    planes: list[torch.Tensor], coords: torch.Tensor, radius: int = 4,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """K1: window lookup over all levels -> [BQ, L * (2r+1)^2] in out_dtype;
    differentiable in the planes (backward K12)."""
    _check_args(planes, coords, radius)
    return PlaneLookup.apply(_lookup_k1, coords, radius, out_dtype, *planes)


def _lookup_k1(planes, coords, radius, out_dtype):
    global launches
    if not _build.uses_kernel("corr_lookup", coords, *planes):
        return corr_lookup_plain(planes, coords, radius, out_dtype)
    bq, nl = coords.shape[0], len(planes)
    k2 = (2 * radius + 1) ** 2
    out = torch.empty((bq, nl * k2), dtype=out_dtype, device=coords.device)
    with torch.cuda.device(coords.device):
        rc = _build.lib().fst_corr_plane_lookup(
            *level_arrays(planes), nl, coords.data_ptr(), out.data_ptr(),
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
