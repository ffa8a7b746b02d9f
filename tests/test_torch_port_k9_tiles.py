"""K9's tile algorithm (csrc/corr_fused_bwd.cu), replayed in PyTorch on the CPU.

The kernel has no CPU mode, so this file holds its arithmetic: each level's
tiles of 8x8 neighbouring queries (``corr_fused.bwd_df2_tiles``), the dense
cotangent D [queries, box taps] of a tile that takes the shared-memory path
and its product D^T . f1_tile added over the box, and the per-query adds of a
tile whose box is too large. The replay must equal ``bwd_df2_plain`` up to
fp32 sums in another order: atol 1e-5 at 13x21; at 40x48, where a level-3
tap sums a few thousand products and the thread count alone moves the
plain version's sums, 1e-5 plus 1e-6 of the level's largest value (about
8 fp32 ulps of it). The
box itself must hold every valid tap of the tile's queries and stay inside
the map. No JAX: the plain version is held against the JAX package in
tests/test_torch_train_kernels.py.
"""
import numpy as np
import pytest
import torch

from flow_supervisor_tpu_torch.kernels import corr_fused
from flow_supervisor_tpu_torch.ops.corr import support_cotangent, support_index

R = 4
SUP = 2 * R + 2
K2 = (2 * R + 1) ** 2
LEVELS = 4
FAR = [(1e9, -1e9), (-3e38, 3e38), (5e5, 7.5), (-2.5, -4e6)]


def _inputs(b, h, w, c, kind, seed):
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
    g = torch.from_numpy(rng.normal(0, 1, (b * h * w, LEVELS * K2)).astype(np.float32))
    return f1, f2s, torch.from_numpy(coords.astype(np.float32)), g


def _level_supports(f1, f2, coords, g, lvl):
    """Window bases (bx, by) [BQ], valid taps [BQ, SUP, SUP] and d_sup / sqrt(C)
    at level lvl."""
    h2, w2 = f2.shape[1], f2.shape[2]
    cl = coords * (1.0 / 2.0 ** lvl)
    _, valid = support_index(cl, R, h2, w2)
    gl = g.reshape(-1, LEVELS, K2)[:, lvl]
    dsup = torch.where(valid, support_cotangent(gl, cl, R), 0.0) / f1.shape[2] ** 0.5
    fl = torch.floor(cl)
    bx = torch.clamp(fl[:, 0] - R, -SUP, w2).long()
    by = torch.clamp(fl[:, 1] - R, -SUP, h2).long()
    return bx, by, valid, dsup


def _tile_queries(b, h, w, bi, tyi, txi):
    """Rows (into B*Q) of tile (tyi, txi) of sample bi, in tile order."""
    ys = torch.arange(tyi * corr_fused.TILE_Y, min((tyi + 1) * corr_fused.TILE_Y, h))
    xs = torch.arange(txi * corr_fused.TILE_X, min((txi + 1) * corr_fused.TILE_X, w))
    return (bi * h * w + ys[:, None] * w + xs[None, :]).reshape(-1)


def _replay(f1, f2s, coords, g):
    """d_f2 per level in fp32 by the kernel's algorithm."""
    b, q, c = f1.shape
    h, w = f2s[0].shape[1], f2s[0].shape[2]
    rows = f1.reshape(b * q, c)
    uu, vv = torch.meshgrid(torch.arange(SUP), torch.arange(SUP), indexing="ij")
    out = []
    for lvl, (f2, tb) in enumerate(zip(f2s, corr_fused.bwd_df2_tiles(f1, f2s, coords, R))):
        h2, w2 = f2.shape[1], f2.shape[2]
        acc = torch.zeros(f2.shape, dtype=torch.float32)
        bx, by, valid, dsup = _level_supports(f1, f2, coords, g, lvl)
        for bi, tyi, txi in np.ndindex(*tb.queries.shape):
            qs = _tile_queries(b, h, w, bi, tyi, txi)
            qs = qs[valid[qs].flatten(1).any(1)]
            assert len(qs) == int(tb.queries[bi, tyi, txi])
            if len(qs) == 0:
                continue
            m = valid[qs]
            if tb.tile_path[bi, tyi, txi]:
                x0, y0 = int(tb.x0[bi, tyi, txi]), int(tb.y0[bi, tyi, txi])
                bw, bh = int(tb.x1[bi, tyi, txi]) - x0, int(tb.y1[bi, tyi, txi]) - y0
                d = torch.zeros(len(qs), bh, bw)
                t = torch.arange(len(qs))[:, None, None].expand_as(m)
                ys = (by[qs, None, None] - y0 + uu)[m]
                xs = (bx[qs, None, None] - x0 + vv)[m]
                d[t[m], ys, xs] = dsup[qs][m]
                out_box = d.reshape(len(qs), -1).t() @ rows[qs]
                acc[bi, y0 : y0 + bh, x0 : x0 + bw] += out_box.reshape(bh, bw, c)
            else:
                for qi in qs.tolist():
                    mq = valid[qi]
                    ys, xs = (by[qi] + uu)[mq], (bx[qi] + vv)[mq]
                    acc[bi].reshape(h2 * w2, c).index_add_(
                        0, ys * w2 + xs, dsup[qi][mq][:, None] * rows[qi][None, :])
        out.append(acc)
    return out


CASES = [(b, kind, (13, 21)) for b in (1, 2) for kind in ("identity", "smooth", "random", "far")]
# a 40x48 map with random coords: level-0 and level-1 boxes exceed MAX_BOX_TAPS
CASES += [(1, "random", (40, 48)), (2, "far", (40, 48))]


@pytest.mark.parametrize("b,kind,hw", CASES)
def test_k9_tile_replay_matches_plain(b, kind, hw):
    f1, f2s, coords, g = _inputs(b, *hw, c=8, kind=kind, seed=b + 10 * len(kind) + hw[0])
    want = corr_fused.bwd_df2_plain(f1, f2s, coords, g, R)
    got = _replay(f1, f2s, coords, g)
    for lvl, (a, wl) in enumerate(zip(got, want)):
        atol = 1e-5 if hw == (13, 21) else 1e-5 + 1e-6 * float(wl.abs().max())
        torch.testing.assert_close(a, wl, atol=atol, rtol=0, msg=f"level {lvl}")
    tiles = corr_fused.bwd_df2_tiles(f1, f2s, coords, R)
    if hw == (40, 48):  # both paths run
        assert not tiles[0].tile_path[tiles[0].queries > 0].all()
        assert tiles[3].tile_path.any()
    elif kind != "far":  # 13x21: every box fits
        assert all(bool(t.tile_path[t.queries > 0].all()) for t in tiles)


@pytest.mark.parametrize("b,kind,hw", CASES)
def test_k9_tile_boxes_hold_every_tap_and_stay_in_the_map(b, kind, hw):
    f1, f2s, coords, g = _inputs(b, *hw, c=8, kind=kind, seed=b + 10 * len(kind) + hw[0])
    h, w = hw
    for lvl, (f2, tb) in enumerate(zip(f2s, corr_fused.bwd_df2_tiles(f1, f2s, coords, R))):
        h2, w2 = f2.shape[1], f2.shape[2]
        bx, by, valid, _ = _level_supports(f1, f2, coords, g, lvl)
        some = tb.queries > 0
        assert bool((tb.x0[some] >= 0).all() and (tb.y0[some] >= 0).all())
        assert bool((tb.x1[some] <= w2).all() and (tb.y1[some] <= h2).all())
        assert bool((tb.x0[some] < tb.x1[some]).all() and (tb.y0[some] < tb.y1[some]).all())
        for bi, tyi, txi in zip(*torch.nonzero(tb.tile_path, as_tuple=True)):
            qs = _tile_queries(b, h, w, int(bi), int(tyi), int(txi))
            m = valid[qs]
            ys = (by[qs, None, None] + torch.arange(SUP)[None, :, None]).expand_as(m)[m]
            xs = (bx[qs, None, None] + torch.arange(SUP)[None, None, :]).expand_as(m)[m]
            assert bool((ys >= tb.y0[bi, tyi, txi]).all() and (ys < tb.y1[bi, tyi, txi]).all())
            assert bool((xs >= tb.x0[bi, tyi, txi]).all() and (xs < tb.x1[bi, tyi, txi]).all())
