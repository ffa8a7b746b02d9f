"""The tile algorithm of K6 / K7 (csrc/corr_fused.cu), replayed in PyTorch on the CPU.

The kernels have no CPU mode, so this file holds their arithmetic: each
level's tiles of 8x8 neighbouring queries (``corr_fused.lookup_tiles``, the
rule K9 shares), the dense product S = f1_tile . f2_box^T over the box of a
tile that takes the shared-memory path, each query's pick of its support taps
out of S, the per-query dot products of a tile whose box is too large, and
the bilinear combine of every query's support. The replay must equal
``corr_fused_plain`` up to fp32 sums in another order (atol 1e-5 on values
of order 1), and every valid support tap of a tile-path query must lie in its
tile's box, which lies inside the map; at radius 4 (RAFT, GMA) and 3 (the
small model). No JAX: the plain version is held
against the JAX package's Pallas kernel in tests/test_torch_port_kernels.py.
"""
import numpy as np
import pytest
import torch

from flow_supervisor_tpu_torch.kernels import corr_fused

R = 4
LEVELS = 4
FAR = [(1e9, -1e9), (-3e38, 3e38), (5e5, 7.5), (-2.5, -4e6)]


def _inputs(b, h, w, c, kind, seed):
    """f1 [B, h*w, C], pooled-size f2s and coords [B*h*w, 2] from numpy.
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
    return f1, f2s, torch.from_numpy(coords.astype(np.float32))


def _windows(coords, lvl, h2, w2, r=R):
    """Window bases (bx, by) [BQ] (clamped as the kernels clamp), fractional
    parts (fx, fy) [BQ] and valid support taps [BQ, SUP, SUP] at level lvl,
    radius r (SUP = 2r + 2)."""
    sup = 2 * r + 2
    cl = coords * (1.0 / 2.0 ** lvl)
    fl = torch.floor(cl)
    bx = torch.clamp(fl[:, 0] - r, -sup, w2).long()
    by = torch.clamp(fl[:, 1] - r, -sup, h2).long()
    u = torch.arange(sup)
    ys = by[:, None, None] + u[None, :, None]
    xs = bx[:, None, None] + u[None, None, :]
    valid = (ys >= 0) & (ys < h2) & (xs >= 0) & (xs < w2)
    return bx, by, cl[:, 0] - fl[:, 0], cl[:, 1] - fl[:, 1], valid


def _tile_queries(b, h, w, bi, tyi, txi):
    """Rows (into B*Q) of tile (tyi, txi) of sample bi, in tile order."""
    ys = torch.arange(tyi * corr_fused.TILE_Y, min((tyi + 1) * corr_fused.TILE_Y, h))
    xs = torch.arange(txi * corr_fused.TILE_X, min((txi + 1) * corr_fused.TILE_X, w))
    return (bi * h * w + ys[:, None] * w + xs[None, :]).reshape(-1)


def _combine(sup, fx, fy):
    """[n, SUP, SUP] supports / sqrt(C) -> [n, K * K] bilinear outputs, dx-major."""
    K = sup.shape[1] - 1
    fx, fy = fx[:, None, None], fy[:, None, None]
    win = ((1 - fy) * (1 - fx) * sup[:, :K, :K] + (1 - fy) * fx * sup[:, :K, 1:]
           + fy * (1 - fx) * sup[:, 1:, :K] + fy * fx * sup[:, 1:, 1:])  # [n, dy, dx]
    return win.transpose(1, 2).reshape(len(sup), K * K)


def _replay(f1, f2s, coords, r=R, query_hw=None):
    """[B*Q, L * K^2] by the kernels' algorithm at radius r over the query
    grid query_hw (default the level-0 map); also the number of tiles on
    each path."""
    SUP, K = 2 * r + 2, 2 * r + 1
    b, q, c = f1.shape
    h, w = query_hw or (f2s[0].shape[1], f2s[0].shape[2])
    rows = f1.reshape(b * q, c)
    out = torch.zeros(b * q, LEVELS * K * K)
    paths = {"tile": 0, "per_query": 0}
    tiles = corr_fused.lookup_tiles(f1, f2s, coords, r, query_hw=(h, w))
    for lvl, (f2, tb) in enumerate(zip(f2s, tiles)):
        h2, w2 = f2.shape[1], f2.shape[2]
        bx, by, fx, fy, valid = _windows(coords, lvl, h2, w2, r)
        for bi, tyi, txi in np.ndindex(*tb.queries.shape):
            qs = _tile_queries(b, h, w, bi, tyi, txi)
            m = valid[qs]
            assert int(m.flatten(1).any(1).sum()) == int(tb.queries[bi, tyi, txi])
            sup = torch.zeros(len(qs), SUP, SUP)
            t = torch.arange(len(qs))[:, None, None].expand_as(m)
            if tb.tile_path[bi, tyi, txi]:
                paths["tile"] += 1
                x0, y0 = int(tb.x0[bi, tyi, txi]), int(tb.y0[bi, tyi, txi])
                bw, bh = int(tb.x1[bi, tyi, txi]) - x0, int(tb.y1[bi, tyi, txi]) - y0
                box = f2[bi, y0 : y0 + bh, x0 : x0 + bw].reshape(bh * bw, c)
                s = rows[qs] @ box.t()  # [queries, box taps]
                ys = (by[qs, None, None] - y0 + torch.arange(SUP)[None, :, None]).expand_as(m)[m]
                xs = (bx[qs, None, None] - x0 + torch.arange(SUP)[None, None, :]).expand_as(m)[m]
                assert bool((ys >= 0).all() and (ys < bh).all() and (xs >= 0).all() and (xs < bw).all())
                sup[m] = s[t[m], ys * bw + xs]
            elif int(tb.queries[bi, tyi, txi]) > 0:
                paths["per_query"] += 1
                for i, qi in enumerate(qs.tolist()):
                    ys = (by[qi] + torch.arange(SUP)[:, None]).expand(SUP, SUP)[m[i]]
                    xs = (bx[qi] + torch.arange(SUP)[None, :]).expand(SUP, SUP)[m[i]]
                    sup[i][m[i]] = f2[bi, ys, xs] @ rows[qi]
            sup = sup / torch.sqrt(torch.tensor(float(c)))
            out[qs, lvl * K * K : (lvl + 1) * K * K] = _combine(sup, fx[qs], fy[qs])
    return out, paths


CASES = [(b, kind, (13, 21)) for b in (1, 2) for kind in ("identity", "smooth", "random", "far")]
# a 40x48 map with random coords: level-0 and level-1 boxes exceed MAX_BOX_TAPS
CASES += [(1, "random", (40, 48)), (2, "far", (40, 48))]
# radius 3, the small model's (SUP = 8): smaller boxes, picks and combine
R3_CASES = [(2, "smooth", (13, 21)), (1, "far", (13, 21)), (1, "random", (40, 48))]


def _check_replay(b, kind, hw, r):
    f1, f2s, coords = _inputs(b, *hw, c=16, kind=kind, seed=b + 10 * len(kind) + hw[0])
    want = corr_fused.corr_fused_plain(f1, f2s, coords, r)
    got, paths = _replay(f1, f2s, coords, r)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert paths["tile"] > 0
    if hw == (40, 48):  # windows that scatter: both paths run
        assert paths["per_query"] > 0
    else:  # 13x21: every box fits (far queries have no valid tap and leave it)
        assert paths["per_query"] == 0


@pytest.mark.parametrize("b,kind,hw", CASES)
def test_k7_tile_replay_matches_plain(b, kind, hw):
    _check_replay(b, kind, hw, R)


@pytest.mark.parametrize("b,kind,hw", R3_CASES)
def test_k7_tile_replay_matches_plain_at_radius_3(b, kind, hw):
    _check_replay(b, kind, hw, 3)


def _check_boxes(b, kind, hw, r):
    f1, f2s, coords = _inputs(b, *hw, c=16, kind=kind, seed=b + 10 * len(kind) + hw[0])
    h, w = hw
    SUP = 2 * r + 2
    tiles = corr_fused.lookup_tiles(f1, f2s, coords, r, query_hw=(h, w))
    for lvl, (f2, tb) in enumerate(zip(f2s, tiles)):
        h2, w2 = f2.shape[1], f2.shape[2]
        bx, by, _, _, valid = _windows(coords, lvl, h2, w2, r)
        some = tb.queries > 0
        assert bool((tb.x0[some] >= 0).all() and (tb.y0[some] >= 0).all())
        assert bool((tb.x1[some] <= w2).all() and (tb.y1[some] <= h2).all())
        area = (tb.x1 - tb.x0) * (tb.y1 - tb.y0)
        assert bool((tb.tile_path == some & (area <= corr_fused.MAX_BOX_TAPS)).all())
        for bi, tyi, txi in zip(*torch.nonzero(some, as_tuple=True)):
            qs = _tile_queries(b, h, w, int(bi), int(tyi), int(txi))
            m = valid[qs]
            ys = (by[qs, None, None] + torch.arange(SUP)[None, :, None]).expand_as(m)[m]
            xs = (bx[qs, None, None] + torch.arange(SUP)[None, None, :]).expand_as(m)[m]
            # the box is the tight bounding box of the tile's valid taps
            assert int(ys.min()) == int(tb.y0[bi, tyi, txi]) and int(ys.max()) + 1 == int(tb.y1[bi, tyi, txi])
            assert int(xs.min()) == int(tb.x0[bi, tyi, txi]) and int(xs.max()) + 1 == int(tb.x1[bi, tyi, txi])


@pytest.mark.parametrize("b,kind,hw", CASES)
def test_k7_tile_boxes_hold_every_tap_and_stay_in_the_map(b, kind, hw):
    _check_boxes(b, kind, hw, R)


@pytest.mark.parametrize("b,kind,hw", R3_CASES)
def test_k7_tile_boxes_hold_every_tap_and_stay_in_the_map_at_radius_3(b, kind, hw):
    _check_boxes(b, kind, hw, 3)


@pytest.mark.parametrize("b,kind", [(1, "smooth"), (2, "random")])
def test_k7_tile_replay_of_a_space_shard(b, kind):
    """A space shard's queries (rows 8-15 of a 16x21 map, models/raft.py
    under parallel/spatial.py) against the whole pooled f2: the tiles are
    8x8 of the shard's own (8, 21) grid, every query's support comes from
    its coords, and the shard's outputs are the whole map's rows."""
    h, w = 16, 21
    f1, f2s, coords = _inputs(b, h, w, c=16, kind=kind, seed=3 + b)
    rows = slice(8 * w, 16 * w)
    f1s = f1[:, rows].contiguous()
    cs = coords.reshape(b, h * w, 2)[:, rows].reshape(-1, 2).contiguous()
    tiles = corr_fused.lookup_tiles(f1s, f2s, cs, R, query_hw=(8, w))
    assert tiles[0].queries.shape == (b, 1, 3)
    got, paths = _replay(f1s, f2s, cs, R, (8, w))
    want = corr_fused.corr_fused_plain(f1s, f2s, cs, R)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    whole = corr_fused.corr_fused_plain(f1, f2s, coords, R).reshape(b, h * w, -1)[:, rows]
    torch.testing.assert_close(want, whole.reshape(want.shape), atol=1e-5, rtol=0)
    assert paths["tile"] > 0
