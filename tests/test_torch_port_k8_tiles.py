"""K8's tile algorithm (csrc/corr_fused_bwd.cu), replayed in PyTorch on the CPU.

The kernel has no CPU mode, so this file holds its arithmetic: each level's
tiles of 8x8 neighbouring queries (``corr_fused.lookup_tiles``), the dense
cotangent D [tile queries, box taps] of a tile that takes the tile path and
its product D . f2_box, the per-query sums of a tile whose box is too large,
and the fixed order of the levels: each level is added into one fp32
accumulator in turn. The replay must equal ``bwd_df1_plain`` up to fp32
sums in another order: atol 1e-5 at 13x21; at 40x48, where level 0 and 1
boxes go per query, 1e-5 plus 1e-6 of the largest value. With bf16-rounded
f2 and fp32 sums, D split into a bf16 high part and the bf16 rest (the
tensor-core body's operand) must land at least 16 times closer to the plain
value than D rounded to bf16 alone, and its bf16-rounded d_f1 within 2^-8
of the plain value (the GPU checks' limit, at most one bf16 ulp), which D in
bf16 alone exceeds. Queries with no valid tap at any level get zero rows.
No JAX: the plain version is held against the JAX package in
tests/test_torch_train_kernels.py.
"""
import numpy as np
import pytest
import torch

from flow_supervisor_tpu_torch.kernels import corr_fused
from flow_supervisor_tpu_torch.ops.corr import support_cotangent, support_index

R = 4
LEVELS = 4
FAR = [(1e9, -1e9), (-3e38, 3e38), (5e5, 7.5), (-2.5, -4e6)]


def _inputs(b, h, w, c, kind, seed, r=R):
    """f1 [B, h*w, C], pooled-size f2s, coords [B*h*w, 2] and g from numpy.
    kind: identity; smooth (identity + N(0, 2 px)); random (uniform over the
    map and 20 px beyond); far (random with the first rows far out)."""
    rng = np.random.default_rng(seed)
    f1 = torch.from_numpy(rng.normal(0, 1, (b, h * w, c)).astype(np.float32))
    f2s = [torch.from_numpy(rng.normal(0, 1, (b, -(-h // 2 ** l), -(-w // 2 ** l), c))
                            .astype(np.float32)) for l in range(LEVELS)]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.broadcast_to(np.stack([xs, ys], -1), (b, h, w, 2)).reshape(-1, 2).astype(np.float64)
    if kind == "identity":
        coords = grid
    elif kind == "smooth":
        coords = grid + rng.normal(0, 2, grid.shape)
    else:
        n = len(grid)
        coords = np.stack([rng.uniform(-20, w + 20, n), rng.uniform(-20, h + 20, n)], 1)
        if kind == "far":
            coords[: len(FAR)] = FAR
    g = torch.from_numpy(rng.normal(0, 1, (b * h * w, LEVELS * (2 * r + 1) ** 2)).astype(np.float32))
    return f1, f2s, torch.from_numpy(coords.astype(np.float32)), g


def _level_supports(f1, f2, coords, g, lvl, r=R):
    """Window bases (bx, by) [BQ], valid taps [BQ, SUP, SUP] and d_sup / sqrt(C)
    at level lvl, radius r (SUP = 2r + 2)."""
    h2, w2 = f2.shape[1], f2.shape[2]
    cl = coords * (1.0 / 2.0 ** lvl)
    _, valid = support_index(cl, r, h2, w2)
    gl = g.reshape(-1, LEVELS, (2 * r + 1) ** 2)[:, lvl]
    dsup = torch.where(valid, support_cotangent(gl, cl, r), 0.0) / f1.shape[2] ** 0.5
    fl = torch.floor(cl)
    bx = torch.clamp(fl[:, 0] - r, -(2 * r + 2), w2).long()
    by = torch.clamp(fl[:, 1] - r, -(2 * r + 2), h2).long()
    return bx, by, valid, dsup


def _tile_queries(b, h, w, bi, tyi, txi):
    """Rows (into B*Q) of tile (tyi, txi) of sample bi, in tile order."""
    ys = torch.arange(tyi * corr_fused.TILE_Y, min((tyi + 1) * corr_fused.TILE_Y, h))
    xs = torch.arange(txi * corr_fused.TILE_X, min((txi + 1) * corr_fused.TILE_X, w))
    return (bi * h * w + ys[:, None] * w + xs[None, :]).reshape(-1)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _replay(f1, f2s, coords, g, operand="fp32", r=R):
    """d_f1 [B, Q, C] fp32 by the kernel's algorithm: each level's tile
    products added into one accumulator in level order. operand: D on the
    tile path as fp32, "hilo" (a bf16 high part plus the bf16 rest) or "hi"
    (bf16 alone); the per-query path keeps fp32. r: the radius."""
    b, q, c = f1.shape
    h, w = f2s[0].shape[1], f2s[0].shape[2]
    sup = 2 * r + 2
    uu, vv = torch.meshgrid(torch.arange(sup), torch.arange(sup), indexing="ij")
    acc = torch.zeros(b * q, c)
    tiles = corr_fused.lookup_tiles(f1, f2s, coords, r, query_hw=(h, w))
    for lvl, (f2, tb) in enumerate(zip(f2s, tiles)):
        h2, w2 = f2.shape[1], f2.shape[2]
        bx, by, valid, dsup = _level_supports(f1, f2, coords, g, lvl, r)
        for bi, tyi, txi in np.ndindex(*tb.queries.shape):
            qs = _tile_queries(b, h, w, bi, tyi, txi)
            m = valid[qs]
            assert int(m.flatten(1).any(1).sum()) == int(tb.queries[bi, tyi, txi])
            if int(tb.queries[bi, tyi, txi]) == 0:
                continue
            if tb.tile_path[bi, tyi, txi]:
                x0, y0 = int(tb.x0[bi, tyi, txi]), int(tb.y0[bi, tyi, txi])
                bw, bh = int(tb.x1[bi, tyi, txi]) - x0, int(tb.y1[bi, tyi, txi]) - y0
                d = torch.zeros(len(qs), bh, bw)
                t = torch.arange(len(qs))[:, None, None].expand_as(m)
                d[t[m], (by[qs, None, None] - y0 + uu)[m], (bx[qs, None, None] - x0 + vv)[m]] = \
                    dsup[qs][m]
                d = d.reshape(len(qs), -1)
                if operand == "hilo":
                    d = _bf16(d) + _bf16(d - _bf16(d))
                elif operand == "hi":
                    d = _bf16(d)
                contrib = d @ f2[bi, y0 : y0 + bh, x0 : x0 + bw].reshape(-1, c)
            else:
                contrib = torch.zeros(len(qs), c)
                for i, qi in enumerate(qs.tolist()):
                    mq = valid[qi]
                    rows = f2[bi, (by[qi] + uu)[mq], (bx[qi] + vv)[mq]]
                    contrib[i] = (dsup[qi][mq][:, None] * rows).sum(0)
            acc[qs] += contrib
    return acc.reshape(b, q, c)


CASES = [(b, kind, (13, 21), c) for b in (1, 2) for kind in ("identity", "smooth", "random", "far")
         for c in (8, 36)]
# 40x48 with random coords: level-0 and level-1 boxes exceed MAX_BOX_TAPS
CASES += [(1, "random", (40, 48), 8), (2, "far", (40, 48), 36), (1, "smooth", (40, 48), 36),
          (2, "identity", (40, 48), 8)]


def _seed(b, kind, hw, c):
    return b + 10 * len(kind) + hw[0] + c


def _check(got, want, hw):
    atol = 1e-5 if hw == (13, 21) else 1e-5 + 1e-6 * float(want.abs().max())
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("b,kind,hw,c", CASES)
def test_k8_tile_replay_matches_plain(b, kind, hw, c):
    f1, f2s, coords, g = _inputs(b, *hw, c=c, kind=kind, seed=_seed(b, kind, hw, c))
    _check(_replay(f1, f2s, coords, g), corr_fused.bwd_df1_plain(f1, f2s, coords, g, R), hw)
    tiles = corr_fused.lookup_tiles(f1, f2s, coords, R, query_hw=hw)
    if hw == (40, 48) and kind in ("random", "far"):  # both paths run
        assert not tiles[0].tile_path[tiles[0].queries > 0].all()
        assert tiles[3].tile_path.any()
    elif kind in ("identity", "smooth"):  # every box fits
        assert all(bool(t.tile_path[t.queries > 0].all()) for t in tiles)


# radius 3, the small model's (SUP = 8): the tile path (13x21) and both
# paths (40x48 random)
@pytest.mark.parametrize("b,kind,hw,c", [(2, "smooth", (13, 21), 36), (1, "far", (13, 21), 8),
                                         (1, "random", (40, 48), 8)])
def test_k8_tile_replay_matches_plain_at_radius_3(b, kind, hw, c):
    f1, f2s, coords, g = _inputs(b, *hw, c=c, kind=kind, seed=_seed(b, kind, hw, c) + 3, r=3)
    _check(_replay(f1, f2s, coords, g, r=3), corr_fused.bwd_df1_plain(f1, f2s, coords, g, 3), hw)
    tiles = corr_fused.lookup_tiles(f1, f2s, coords, 3, query_hw=hw)
    if kind == "random":
        assert not tiles[0].tile_path[tiles[0].queries > 0].all()
    assert any(bool(t.tile_path.any()) for t in tiles)


# f2 rounded to bf16 (the tensor-core body's input), sums in fp32: the error
# left by D's high and low bf16 parts against that of D in bf16 alone
@pytest.mark.parametrize("b,kind,hw,c", [(2, "smooth", (13, 21), 36), (1, "identity", (40, 48), 8)])
def test_k8_high_low_split_of_d_keeps_about_16_bits(b, kind, hw, c):
    f1, f2s, coords, g = _inputs(b, *hw, c=c, kind=kind, seed=_seed(b, kind, hw, c) + 1)
    f2s = [_bf16(f) for f in f2s]
    want = corr_fused.bwd_df1_plain(f1, f2s, coords, g, R)
    err_split = float((_replay(f1, f2s, coords, g, operand="hilo") - want).abs().max())
    err_hi = float((_replay(f1, f2s, coords, g, operand="hi") - want).abs().max())
    assert err_hi > 0 and 16 * err_split <= err_hi, (err_split, err_hi)


# the GPU checks' limit on bf16 d_f1 (chip_smoke.check_ulp): within 2^-8 of
# the plain fp32 value plus atol 1e-4. D's high and low parts keep it; D in
# bf16 alone breaks it where the sum cancels to a small value
@pytest.mark.parametrize("b,kind,hw,c", [(1, "smooth", (13, 21), 36), (2, "identity", (13, 21), 8),
                                         (2, "far", (40, 48), 36), (1, "smooth", (40, 48), 8)])
def test_k8_bf16_result_within_one_ulp_only_with_the_low_part_of_d(b, kind, hw, c):
    f1, f2s, coords, g = _inputs(b, *hw, c=c, kind=kind, seed=_seed(b, kind, hw, c) + 2)
    f2s = [_bf16(f) for f in f2s]
    want = corr_fused.bwd_df1_plain(f1, f2s, coords, g, R)

    def over(operand):
        got = _bf16(_replay(f1, f2s, coords, g, operand=operand))
        return int(((got - want).abs() > 1e-4 + 2.0 ** -8 * want.abs()).sum())

    assert over("hilo") == 0
    assert over("hi") > 0


# a query with no valid tap at any level (far out of the map) gets a zero
# row, in tiles whose other queries take the tile path
@pytest.mark.parametrize("b,hw,c", [(1, (13, 21), 8), (2, (13, 21), 36), (1, (40, 48), 8),
                                    (2, (40, 48), 36), (2, (16, 24), 8), (1, (9, 17), 36)])
def test_k8_queries_without_a_valid_tap_get_zero_rows(b, hw, c):
    f1, f2s, coords, g = _inputs(b, *hw, c=c, kind="smooth", seed=_seed(b, "far", hw, c))
    far = torch.arange(0, b * hw[0] * hw[1], 7)
    moved = coords.clone()
    moved[far] = torch.tensor([1e9, -1e9])
    got = _replay(f1, f2s, moved, g).reshape(-1, c)
    assert torch.equal(got[far], torch.zeros(len(far), c))
    _check(got.reshape(b, -1, c), corr_fused.bwd_df1_plain(f1, f2s, moved, g, R), hw)
