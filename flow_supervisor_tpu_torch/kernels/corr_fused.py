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

Both take the queries as their (h1, w1) grid, cut into tiles of
TILE_Y x TILE_X neighbours; a block takes one tile at one level, stages the
tile's f1 rows and, pass by pass, the f2 rows of the bounding box of the
tile's valid support taps, and takes their dense product (on the tensor
cores for bf16 f1), from which each query picks its support; a tile whose
box exceeds ``MAX_BOX_TAPS`` computes per query instead. ``lookup_tiles``
gives each tile's box and path by the kernels' rule.

The TPU layout (grouped f2 factors, 128-lane and query padding, SMEM index
planes, one-hot combine matrices) and its VMEM-budget fallback are not
carried over.

The lookup is a ``torch.autograd.Function`` whose backward is volume-free
too (csrc/corr_fused_bwd.cu), at any batch: each query's window cotangent
becomes its masked support cotangent / sqrt(C), then

- ``bwd_df1`` (K8, replaces ``_bwd_df1_kernel``): d_f1[q] = sum over levels
  and support taps of d_sup * f2_l[tap]. A block takes a tile of
  neighbouring queries (the forward's tiles) and 256 channels, and per level
  the dense cotangent over the box of the tile's valid taps times the box's
  f2 rows (on the tensor cores for bf16, with the cotangent as a bf16 high
  and low part); a level whose box exceeds ``MAX_BOX_TAPS`` goes per query.
  One launch: a block sums all levels in registers in level order and
  writes its d_f1 once, so no atomics: the same inputs give the same bits;
- ``bwd_df2`` (K9, replaces ``_bwd_df2_kernel``): d_f2_l[tap] += d_sup *
  f1[q], one launch for all levels. A block takes a tile of neighbouring
  queries at one level (the forward's tiles), contracts their dense
  cotangent over the bounding box of their valid taps with the tile's f1 in
  shared memory (the TPU kernel's ``f1^T . slab``; on the tensor cores for
  bf16 f1, with the cotangent as a bf16 high and low part), and adds the box
  into fp32 accumulators with one atomic per tap and 4 channels; a tile
  whose box exceeds ``MAX_BOX_TAPS`` adds per query and tap instead.

Each wrapper takes the plain PyTorch version (``corr_fused_plain``: per-level
fp32 volumes by ``torch.matmul`` over chunks of queries, looked up by
``corr_plane.corr_lookup_plain``; ``bwd_df1_plain`` / ``bwd_df2_plain``: the
cotangent volume of a chunk of queries by scatter, then the two factor
products) only for CPU tensors; for CUDA tensors it launches the kernel or
raises. ``all_launches`` / ``level_launches`` / ``bwd_df1_launches`` /
``bwd_df2_launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from flow_supervisor_tpu_torch.kernels import _build
from flow_supervisor_tpu_torch.kernels.corr_plane import MAX_LEVELS, corr_lookup_plain
from flow_supervisor_tpu_torch.ops.corr import (
    _avg_pool_fmap_same,
    support_cotangent,
    support_index,
)

all_launches = 0
level_launches = 0
bwd_df1_launches = 0
bwd_df2_launches = 0

PLAIN_CHUNK = 2048  # queries per plain matmul chunk: bounds its fp32 volume
# the tiles of K6 / K7, K8 and K9 (csrc/tiles.cuh kTileY, kTileX, kMaxBoxTaps)
TILE_Y, TILE_X = 8, 8
MAX_BOX_TAPS = 1024


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
    """K6: all levels in one launch -> [B * Q, L * (2r+1)^2] in out_dtype. The
    queries' grid is the level-0 map f2s[0] when it holds the Q queries, else
    one row."""
    global all_launches
    _check_args("corr_fused_all", f1, f2s, coords, radius)
    if not 1 <= len(f2s) <= MAX_LEVELS:
        raise ValueError(f"corr_fused_all: 1..{MAX_LEVELS} levels, got {len(f2s)}")
    if not _build.uses_kernel("corr_fused_all", f1, coords, *f2s):
        return corr_fused_plain(f1, f2s, coords, radius, out_dtype)
    b, q, c = f1.shape
    nl = len(f2s)
    out = torch.empty((b * q, nl * (2 * radius + 1) ** 2), dtype=out_dtype, device=f1.device)
    with torch.cuda.device(f1.device):
        rc = _build.lib().fst_corr_fused_all(
            f1.data_ptr(), *_level_arrays([f2.data_ptr() for f2 in f2s], f2s), nl,
            f2s[0].shape[1], f2s[0].shape[2], coords.data_ptr(), out.data_ptr(), b * q, q, c,
            radius, _build.dtype_code(f1), _build.dtype_code(out), _build.stream_of(f1),
        )
    _build.check(rc, "corr_fused_all")
    all_launches += 1
    return out


def corr_fused_level(
    f1: torch.Tensor, f2: torch.Tensor, level: int, coords: torch.Tensor, radius: int,
    out: torch.Tensor, query_hw: tuple[int, int] | None = None,
) -> None:
    """K7: level ``level`` (f2 pooled by 2^level) into channels
    [level * (2r+1)^2, (level+1) * (2r+1)^2) of out [B * Q, >= that].
    query_hw: the queries' (h1, w1) grid, the level-0 map; None, or a grid
    that does not hold the Q queries, takes them as one row (right, but its
    tiles share fewer support taps)."""
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
    h1, w1 = query_hw or (1, q)
    with torch.cuda.device(f1.device):
        rc = _build.lib().fst_corr_fused_level(
            f1.data_ptr(), f2.data_ptr(), f2.shape[1], f2.shape[2], level, h1, w1,
            coords.data_ptr(), out.data_ptr(), out.shape[1], b * q, q, c, radius,
            _build.dtype_code(f1), _build.dtype_code(out), _build.stream_of(f1),
        )
    _build.check(rc, "corr_fused_level")
    level_launches += 1


def _dvol_chunks(f1, f2s, coords, g, radius):
    """The plain backward's transient: for each sample, chunk of queries and
    level, (sample, first query, level, d_vol [n, h2 * w2] fp32) where d_vol
    holds each query's masked support cotangent / sqrt(C) at its support taps
    (the closed form of the JAX package's ``lookup_vjp_dvols``)."""
    b, q, c = f1.shape
    k2 = (2 * radius + 1) ** 2
    gq = g.reshape(b * q, len(f2s), k2)
    for bi in range(b):
        for q0 in range(0, q, PLAIN_CHUNK):
            n = min(PLAIN_CHUNK, q - q0)
            rows = slice(bi * q + q0, bi * q + q0 + n)
            for lvl, f2 in enumerate(f2s):
                h2, w2 = f2.shape[1], f2.shape[2]
                cl = coords[rows].float() * (1.0 / 2.0 ** lvl)
                idx, valid = support_index(cl, radius, h2, w2)
                dsup = torch.where(valid, support_cotangent(gq[rows, lvl], cl, radius), 0.0)
                dvol = torch.zeros((n, h2 * w2), dtype=torch.float32, device=f1.device)
                dvol.scatter_add_(1, idx, dsup.reshape(n, -1) / c ** 0.5)
                yield bi, q0, lvl, dvol


def bwd_df1_plain(f1, f2s, coords, g, radius: int = 4) -> torch.Tensor:
    """Plain K8: d_f1 [B, Q, C] = sum over levels of d_vol x f2_l, in fp32,
    returned in f1's dtype."""
    d_f1 = torch.zeros(f1.shape, dtype=torch.float32, device=f1.device)
    for bi, q0, lvl, dvol in _dvol_chunks(f1, f2s, coords, g, radius):
        cols = f2s[lvl][bi].reshape(-1, f1.shape[2]).float()
        d_f1[bi, q0 : q0 + dvol.shape[0]] += dvol @ cols
    return d_f1.to(f1.dtype)


def bwd_df2_plain(f1, f2s, coords, g, radius: int = 4) -> list[torch.Tensor]:
    """Plain K9: per level d_f2_l [B, h2, w2, C] = d_vol^T x f1, in fp32,
    returned in f2_l's dtype."""
    d_f2s = [torch.zeros(f2.shape, dtype=torch.float32, device=f2.device) for f2 in f2s]
    for bi, q0, lvl, dvol in _dvol_chunks(f1, f2s, coords, g, radius):
        rows = f1[bi, q0 : q0 + dvol.shape[0]].float()
        d_f2s[lvl][bi] += (dvol.t() @ rows).reshape(d_f2s[lvl].shape[1:])
    return [d.to(f2.dtype) for d, f2 in zip(d_f2s, f2s)]


class TileBoxes(NamedTuple):
    """The tiles of K6 / K7 and K9 at one level, each field [B, tiles_y, tiles_x]: the box
    [x0, x1) x [y0, y1) of the valid support taps of the tile's queries,
    clipped to the map (0 where no query has a valid tap), the number of
    those queries, and whether the tile takes the shared-memory path (it has
    a query and its box holds at most ``MAX_BOX_TAPS`` taps); the others go
    per query."""

    x0: torch.Tensor
    y0: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    queries: torch.Tensor
    tile_path: torch.Tensor


def lookup_tiles(f1, f2s, coords, radius: int = 4) -> list[TileBoxes]:
    """Each level's tiles of K6 / K7, K8 and K9 (TILE_Y x TILE_X queries of
    one sample, the last ones ragged) by the kernels' rule, for f1 [B, Q, C],
    the pooled f2s and coords [B * Q, 2] at level 0."""
    b, q, _ = f1.shape
    h0, w0 = f2s[0].shape[1], f2s[0].shape[2]
    qh, qw = (h0, w0) if h0 * w0 == q else (1, q)  # the level-0 map, else one row
    nty, ntx = -(-qh // TILE_Y), -(-qw // TILE_X)
    sup = 2 * radius + 2
    big = 2 ** 31 - 1
    out = []
    for lvl, f2 in enumerate(f2s):
        h2, w2 = f2.shape[1], f2.shape[2]
        fl = torch.floor(coords.float() * (1.0 / 2.0 ** lvl))
        bx = torch.clamp(fl[:, 0] - radius, -sup, w2).long()
        by = torch.clamp(fl[:, 1] - radius, -sup, h2).long()
        x0, x1 = bx.clamp(min=0), (bx + sup).clamp(max=w2)
        y0, y1 = by.clamp(min=0), (by + sup).clamp(max=h2)
        valid = (x0 < x1) & (y0 < y1)

        def tiled(v, fill):
            grid = torch.full((b, nty * TILE_Y, ntx * TILE_X), fill, dtype=torch.long,
                              device=coords.device)
            grid[:, :qh, :qw] = torch.where(valid, v, fill).reshape(b, qh, qw)
            return grid.reshape(b, nty, TILE_Y, ntx, TILE_X)

        n = tiled(torch.ones_like(bx), 0).sum(dim=(2, 4))
        box = [tiled(x0, big).amin(dim=(2, 4)), tiled(y0, big).amin(dim=(2, 4)),
               tiled(x1, -big).amax(dim=(2, 4)), tiled(y1, -big).amax(dim=(2, 4))]
        box = [torch.where(n > 0, v, 0) for v in box]
        area = (box[2] - box[0]) * (box[3] - box[1])
        out.append(TileBoxes(*box, n, (n > 0) & (area <= MAX_BOX_TAPS)))
    return out


def _check_bwd_args(what, f1, f2s, coords, g, radius):
    _check_args(what, f1, f2s, coords, radius)
    if not 1 <= len(f2s) <= MAX_LEVELS:
        raise ValueError(f"{what}: 1..{MAX_LEVELS} levels, got {len(f2s)}")
    k2 = (2 * radius + 1) ** 2
    shape = (coords.shape[0], len(f2s) * k2)
    if tuple(g.shape) != shape or not g.is_contiguous():
        raise ValueError(f"{what}: g must be contiguous {list(shape)}, got {tuple(g.shape)}")
    _build.dtype_code(g)


def _level_arrays(ptrs, f2s):
    """ctypes arrays of per-level pointers, heights and widths (each cast keeps
    its array alive)."""
    nl = len(f2s)
    return (
        ctypes.cast((ctypes.c_void_p * nl)(*ptrs), ctypes.c_void_p),
        ctypes.cast((ctypes.c_int * nl)(*[f2.shape[1] for f2 in f2s]), ctypes.c_void_p),
        ctypes.cast((ctypes.c_int * nl)(*[f2.shape[2] for f2 in f2s]), ctypes.c_void_p),
    )


def bwd_df1(f1, f2s, coords, g, radius: int = 4) -> torch.Tensor:
    """K8: d_f1 [B, Q, C] in f1's dtype from the lookup's output cotangent g
    [B * Q, L * (2r+1)^2], all levels in one launch."""
    global bwd_df1_launches
    _check_bwd_args("bwd_df1", f1, f2s, coords, g, radius)
    if not _build.uses_kernel("bwd_df1", f1, coords, g, *f2s):
        return bwd_df1_plain(f1, f2s, coords, g, radius)
    b, q, c = f1.shape
    d_f1 = torch.empty_like(f1)
    with torch.cuda.device(f1.device):
        rc = _build.lib().fst_corr_fused_bwd_df1(
            *_level_arrays([f2.data_ptr() for f2 in f2s], f2s), len(f2s), coords.data_ptr(),
            g.data_ptr(), d_f1.data_ptr(), b * q, q, c, radius, _build.dtype_code(f1),
            _build.dtype_code(g), _build.stream_of(f1),
        )
    _build.check(rc, "bwd_df1")
    bwd_df1_launches += 1
    return d_f1


def bwd_df2(f1, f2s, coords, g, radius: int = 4) -> list[torch.Tensor]:
    """K9: per level d_f2_l [B, h2, w2, C] in f2_l's dtype, all levels in one
    launch: each tile's box (``lookup_tiles``) is summed in shared memory
    and added with atomics into fp32 buffers that this wrapper zeroes (the
    order of the sums changes from run to run)."""
    global bwd_df2_launches
    _check_bwd_args("bwd_df2", f1, f2s, coords, g, radius)
    if not _build.uses_kernel("bwd_df2", f1, coords, g, *f2s):
        return bwd_df2_plain(f1, f2s, coords, g, radius)
    b, q, c = f1.shape
    accs = [torch.zeros(f2.shape, dtype=torch.float32, device=f2.device) for f2 in f2s]
    with torch.cuda.device(f1.device):
        rc = _build.lib().fst_corr_fused_bwd_df2(
            f1.data_ptr(), *_level_arrays([a.data_ptr() for a in accs], f2s), len(f2s),
            coords.data_ptr(), g.data_ptr(), b * q, q, c, radius, _build.dtype_code(f1),
            _build.dtype_code(g), _build.stream_of(f1),
        )
    _build.check(rc, "bwd_df2")
    bwd_df2_launches += 1
    return [a.to(f2.dtype) for a, f2 in zip(accs, f2s)]


class _FusedLookup(torch.autograd.Function):
    """Forward K6 (B == 1) or K7 (B > 1); backward K8 (d_f1) and K9 (d_f2 per
    level), the volume-free backward of the JAX package's ``_try_bwd_kernel``.
    coords get no gradient: the model detaches them every iteration, as JAX's
    ``stop_gradient`` does."""

    @staticmethod
    def forward(ctx, flat, radius, out_dtype, batch, f1, *f2s):
        ctx.radius = radius
        ctx.save_for_backward(flat, f1, *f2s)
        if batch == 1:
            return corr_fused_all(f1, list(f2s), flat, radius, out_dtype)
        k2 = (2 * radius + 1) ** 2
        out = torch.empty((flat.shape[0], len(f2s) * k2), dtype=out_dtype, device=flat.device)
        for lvl, f2 in enumerate(f2s):
            corr_fused_level(f1, f2, lvl, flat, radius, out, tuple(f2s[0].shape[1:3]))
        return out

    @staticmethod
    def backward(ctx, g):
        flat, f1, *f2s = ctx.saved_tensors
        g = g.contiguous()
        d_f1 = bwd_df1(f1, f2s, flat, g, ctx.radius) if ctx.needs_input_grad[4] else None
        d_f2s = (
            bwd_df2(f1, f2s, flat, g, ctx.radius) if any(ctx.needs_input_grad[5:])
            else [None] * len(f2s)
        )
        return (None, None, None, None, d_f1, *d_f2s)


def corr_pyramid_lookup_fused(
    pyramid: FusedPyramid, coords: torch.Tensor, radius: int = 4, out_dtype=torch.float32,
) -> torch.Tensor:
    """coords [B, h1, w1, 2] -> [B, h1, w1, L * (2r+1)^2]: K6 at B == 1, K7
    per level at B > 1 (the JAX package's dispatch); differentiable in the
    factors (K8 / K9), not in coords."""
    b, h1, w1, _ = coords.shape
    flat = coords.detach().reshape(b * h1 * w1, 2).float().contiguous()
    out = _FusedLookup.apply(flat, radius, out_dtype, b, pyramid.f1, *pyramid.f2s)
    return out.reshape(b, h1, w1, -1)
