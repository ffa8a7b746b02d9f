"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Skips without a CUDA device (the kernels have no CPU mode). This file imports
no JAX, so it also runs on a GPU machine without JAX, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

fp32 comparisons run with TF32 off; bf16 ones allow 1 bf16 ulp (rtol 1e-2),
except K4's, which must give the plain version's bits in both dtypes.
"""
import numpy as np
import pytest
import torch

from flow_supervisor_tpu_torch.kernels import (
    conv3x3, corr_fused, corr_lookup, corr_lookup_v2, corr_plane, norm, update_epilogue,
)
from flow_supervisor_tpu_torch.ops.corr import (
    build_corr_pyramid_from_fmaps, combine_support, corr_pyramid_lookup, window_support,
)

R = 4


def _lookup_inputs(b, h8, w8, c, seed):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)
    coords = np.stack(
        [rng.uniform(-15, w8 + 15, (b, h8, w8)), rng.uniform(-15, h8 + 15, (b, h8, w8))], -1
    ).astype(np.float32)
    return f1, f2, coords


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _k1_case(dev, dtype, levels, seed):
    """B=2 at 5x9 (90 queries: the last block of 8 is partly filled), coords
    up to 15 px out of bounds and two far out (to 3e38)."""
    f1, f2, coords = _lookup_inputs(b=2, h8=5, w8=9, c=64, seed=seed)
    coords[0, 0, 0] = (1e9, -1e9)
    coords[1, 4, 8] = (-3e38, 3e38)
    planes = corr_plane.build_plane_pyramid(
        torch.from_numpy(f1).to(dev), torch.from_numpy(f2).to(dev), levels, dtype
    )
    return planes, torch.from_numpy(coords).reshape(-1, 2).to(dev)


# radius 4 runs the body with the radius fixed at compile time, the others
# the body that takes it as an argument
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("radius", [0, 1, 3, 4, 8])
def test_cuda_k1_matches_plain(cuda, dtype, levels, radius):
    planes, c = _k1_case(cuda, dtype, levels, seed=20 + radius)
    got = corr_plane.corr_lookup(planes, c, radius, dtype)
    want = corr_plane.corr_lookup_plain(planes, c, radius, torch.float32)
    assert got.shape == (90, levels * (2 * radius + 1) ** 2) and got.dtype == dtype
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(got.float(), want, **tol)
    assert torch.all(got[0] == 0) and torch.all(got[-1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k1_is_bit_identical_across_launches(cuda, dtype):
    planes, c = _k1_case(cuda, dtype, 4, seed=30)
    first = corr_plane.corr_lookup(planes, c, R, dtype)
    assert torch.equal(corr_plane.corr_lookup(planes, c, R, dtype), first)


@pytest.mark.cuda
def test_cuda_k1_refuses_a_radius_beyond_shared_memory(cuda):
    """Radius 32: 8 warps of 4 levels' 66x67 fp32 supports need 566 KB of
    shared memory; the launcher refuses, the wrapper raises, counts nothing,
    and the next launch is unaffected."""
    planes, c = _k1_case(cuda, torch.bfloat16, 4, seed=31)
    before = corr_plane.launches
    with pytest.raises(RuntimeError, match="corr_lookup"):
        corr_plane.corr_lookup(planes, c, 32, torch.bfloat16)
    assert corr_plane.launches == before
    got = corr_plane.corr_lookup(planes, c, R, torch.float32)
    torch.testing.assert_close(got, corr_plane.corr_lookup_plain(planes, c, R), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 20, 40, 64, 64), (1, 11, 90, 128, 128)])
def test_cuda_k2_matches_plain(cuda, dtype, shape):
    b, h, w, c, co = shape
    g = torch.Generator().manual_seed(10)
    x = torch.randn(b, h, w, c, generator=g).to(cuda, dtype)
    k = (0.1 * torch.randn(3, 3, c, co, generator=g)).to(cuda, dtype)
    bias = (0.1 * torch.randn(co, generator=g)).to(cuda, dtype)
    y, st = conv3x3.conv3x3_stats(x, k, bias)
    y_ref, st_ref = conv3x3.conv3x3_stats_plain(x, k, bias)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_cuda_k3_k4_match_plain(cuda, dtype, relu):
    g = torch.Generator().manual_seed(11)
    x = (3 * torch.randn(2, 37, 50, 96, generator=g) + 1.5).to(cuda, dtype)
    st = norm.instance_norm_stats(x)
    st_ref = norm.instance_norm_stats_plain(x)
    torch.testing.assert_close(st, st_ref, rtol=1e-5, atol=1e-5)
    y = norm.instance_norm_apply(x, st_ref, relu)
    assert torch.equal(y, norm.instance_norm_apply_plain(x, st_ref, relu))


# the fnet's norm shapes (the stem's at full size), M not a multiple of a
# block's rows, C = 36 (the scalar body), B = 20 (the chairs batch's 20
# images), M = 1, and channel groups beyond one block (scalar C = 530: two
# K3 blocks across the channels, three K4 ones; fp32 C = 2052 on the vector
# body: 513 groups of 4)
NORM_SHAPES = [(2, 224, 512, 64), (2, 14, 32, 96), (2, 7, 16, 128), (1, 55, 127, 64),
               (2, 46, 62, 36), (20, 46, 62, 128), (3, 1, 1, 64), (2, 1, 1, 36), (1, 5, 7, 530),
               (1, 3, 4, 2052)]


def _norm_input(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return (3 * torch.randn(*shape, generator=g) + 1.5).to(dev, dtype)


# K4 repeats the plain version's arithmetic ((x - mean) * r rounded twice,
# relu, a round-to-nearest cast), so its output has the same bits
@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=[str(s) for s in NORM_SHAPES])
def test_cuda_k4_gives_the_plain_bits(cuda, shape, dtype, relu):
    x = _norm_input(shape, dtype, cuda, 70)
    st = norm.instance_norm_stats_plain(x)
    assert torch.equal(norm.instance_norm_apply(x, st, relu), norm.instance_norm_apply_plain(x, st, relu))


# fp32 sums over H*W in another order: atol 1e-5 (rtol 0) on (mean, r) of
# x ~ 3 N(0, 1) + 1.5; a fixed order of sums, so two launches give the same bits
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=[str(s) for s in NORM_SHAPES])
def test_cuda_k3_matches_plain_and_repeats(cuda, shape, dtype):
    x = _norm_input(shape, dtype, cuda, 71)
    st = norm.instance_norm_stats(x)
    torch.testing.assert_close(st, norm.instance_norm_stats_plain(x), rtol=0, atol=1e-5)
    assert torch.equal(norm.instance_norm_stats(x), st)


# a space shard's encoder norms (models/layers.py ``global_instance_stats``):
# each rank's rows of the fnet's three stages at 448x1024 over 2 ranks, and
# C = 36; on the vector body, and on the scalar one (x one element off a
# 16-byte boundary). K3's partial sums summed in PyTorch against the plain
# fp32 sums, within 1e-5 of the sums of |x| and x^2 (another order only)
SHARD_NORM_SHAPES = [(2, 112, 512, 64), (2, 56, 256, 96), (2, 28, 128, 128), (2, 28, 128, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHARD_NORM_SHAPES, ids=[str(s) for s in SHARD_NORM_SHAPES])
def test_cuda_k3_sums_of_a_space_shard_match_plain(cuda, shape, dtype, offset):
    n = int(np.prod(shape))
    x = _norm_input((n + offset,), dtype, cuda, 73)[offset:].view(shape)
    counts = (norm.stats_launches, norm.vector_launches)
    got = norm.instance_norm_sums(x)
    assert (norm.stats_launches, norm.vector_launches) == (
        counts[0] + 1, counts[1] + norm.vector_body(x))
    assert norm.vector_body(x) == (offset == 0 and shape[3] % (16 // x.element_size()) == 0)
    want = norm.instance_norm_sums_plain(x)
    scale = norm.instance_norm_sums_plain(x.abs())
    assert got.shape == want.shape == (shape[0], 2, shape[3]) and got.dtype == torch.float32
    rel = float(((got - want).abs() / scale).max())
    assert rel <= 1e-5, rel


# K5 on a space shard's rows plus its 1-row halo (models/encoders.py): the
# fnet stages' convs at 448x1024 over 2 ranks, 112, 56 and 28 rows + 2
SHARD_CONV_SHAPES = [(2, 114, 512, 64, 64), (2, 58, 256, 96, 96), (2, 30, 128, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHARD_CONV_SHAPES)
def test_cuda_k5_of_a_space_shard_matches_plain(cuda, shape, dtype):
    x, k, bias = _conv_inputs(shape, dtype, cuda, 24)
    n, tc = conv3x3.bare_launches, conv3x3.tc_launches
    y = conv3x3.conv3x3_bare(x, k, bias)
    assert conv3x3.bare_launches == n + 1
    assert conv3x3.tc_launches == tc + (dtype == torch.bfloat16)
    y_ref = conv3x3.conv3x3_bare_plain(x, k, bias)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=rtol, atol=1e-5)


# vector body: C a multiple of 8 (bf16) or 4 (fp32) channels and x 16-byte
# aligned; x offset by one element from an allocation takes the scalar body
@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype,offset,vec", [
    (64, torch.bfloat16, 0, True), (96, torch.bfloat16, 0, True), (36, torch.bfloat16, 0, False),
    (4, torch.bfloat16, 0, False), (64, torch.bfloat16, 1, False), (36, torch.float32, 0, True),
    (4, torch.float32, 0, True), (6, torch.float32, 0, False), (64, torch.float32, 1, False),
])
def test_cuda_norm_body_counter_follows_the_rule(cuda, c, dtype, offset, vec):
    shape = (2, 9, 11, c)
    n = 2 * 9 * 11 * c
    flat = _norm_input((n + offset,), dtype, cuda, 72)
    x = flat[offset:].view(shape)
    assert norm.vector_body(x) == vec
    counts = (norm.stats_launches, norm.apply_launches, norm.vector_launches)
    st = norm.instance_norm_stats(x)
    y = norm.instance_norm_apply(x, st, True)
    assert (norm.stats_launches, norm.apply_launches, norm.vector_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 2 * vec)
    torch.testing.assert_close(st, norm.instance_norm_stats_plain(x), rtol=0, atol=1e-5)
    assert torch.equal(y, norm.instance_norm_apply_plain(x, st, True))
    if not vec:  # the launchers refuse the vector body where the rule does
        lib = norm._build.lib()
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fst_instance_norm_apply(x.data_ptr(), st.data_ptr(), y.data_ptr(), 2, 99, c,
                                         norm._build.dtype_code(x), 1, 0, stream)
        assert rc != 0


def _fused_inputs(b, c, dtype, dev, seed):
    f1, f2, coords = _lookup_inputs(b=b, h8=7, w8=11, c=c, seed=seed)
    coords[0, 0, 0] = (1e9, -1e9)  # far out of bounds: reads 0, no overflow
    pyr = corr_fused.build_fused_pyramid(
        torch.from_numpy(f1).to(dev, dtype), torch.from_numpy(f2).to(dev, dtype), 4
    )
    return pyr, torch.from_numpy(coords).reshape(-1, 2).to(dev)


def _grid(pyr):
    """The queries' grid of these cases: the whole level-0 map."""
    return tuple(pyr.f2s[0].shape[1:3])


# C=64: 16-byte loads; C=36: the scalar path (C % 8 != 0); C=320: two 256-channel chunks
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 2])
def test_cuda_k6_k7_of_a_space_shard_match_plain(cuda, dtype, batch):
    """A space shard's queries (the last 8 of 16 rows at 1/8) looked up in
    the whole pooled f2 on the shard's own (8, 24) query grid: K6 at B=1,
    K7 a level at B=2, against the plain version, with smooth coords (the
    tile path) at the queries' absolute rows."""
    rng = np.random.default_rng(7)
    h, w, c = 16, 24, 64
    f1 = torch.from_numpy(rng.normal(0, 1, (batch, 8, w, c)).astype(np.float32)).to(cuda, dtype)
    f2 = torch.from_numpy(rng.normal(0, 1, (batch, h, w, c)).astype(np.float32)).to(cuda, dtype)
    pyr = corr_fused.build_fused_pyramid(f1, f2, 4)
    ys, xs = np.meshgrid(np.arange(8, 16), np.arange(w), indexing="ij")
    grid = np.broadcast_to(np.stack([xs, ys], -1), (batch, 8, w, 2))
    coords = torch.from_numpy((grid + rng.normal(0, 2, grid.shape)).astype(np.float32)).to(cuda)
    got = corr_fused.corr_pyramid_lookup_fused(pyr, coords, R, torch.float32)
    want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords.reshape(-1, 2), R, torch.float32)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(got.reshape(want.shape), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 36, 320])
def test_cuda_k6_matches_plain(cuda, dtype, c):
    pyr, coords = _fused_inputs(1, c, dtype, cuda, 12)
    got = corr_fused.corr_fused_all(pyr.f1, pyr.f2s, coords, R, dtype,
                                        query_hw=_grid(pyr)).float()
    want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, R, torch.float32)
    # fp32: only the summation order of C products differs
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(got, want, **tol)
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 36, 320])
def test_cuda_k7_matches_plain(cuda, dtype, c):
    pyr, coords = _fused_inputs(2, c, dtype, cuda, 13)
    k2 = (2 * R + 1) ** 2
    got = torch.full((coords.shape[0], 4 * k2), float("nan"), device=cuda, dtype=dtype)
    for lvl, f2 in enumerate(pyr.f2s):
        corr_fused.corr_fused_level(pyr.f1, f2, lvl, coords, R, got)
    want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, R, torch.float32)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(got.float(), want, **tol)


def _tile_case(b, c, dtype, dev, coords_kind, seed):
    """A 50x90 query grid (ragged 8x8 tiles) and its pyramid; coords smooth
    (the pixel grid plus N(0, 2 px): every tile takes the box path), random
    (uniform over the map and 15 px beyond: level-0 boxes exceed
    MAX_BOX_TAPS and go per query), far (random, some queries far out) or
    mixed (smooth, with queries far out and six a sample 20 px off, some of
    whose tiles go per query)."""
    h8, w8 = 50, 90
    f1, f2, coords = _lookup_inputs(b=b, h8=h8, w8=w8, c=c, seed=seed)
    pyr = corr_fused.build_fused_pyramid(
        torch.from_numpy(f1).to(dev, dtype), torch.from_numpy(f2).to(dev, dtype), 4
    )
    coords = torch.from_numpy(coords).reshape(-1, 2).to(dev)
    if coords_kind in ("smooth", "mixed"):
        coords = _smooth_coords(b, h8, w8, seed, dev)
    if coords_kind in ("far", "mixed"):
        coords[::997] = torch.tensor([1e9, -1e9], device=dev)
        coords[-1] = torch.tensor([-3e38, 3e38], device=dev)
    if coords_kind == "mixed":
        diverging = [bi * h8 * w8 + qy * w8 + qx
                     for bi in range(b) for qy in (12, 24) for qx in (10, 40, 60)]
        coords[diverging] += 20.0
    return pyr, coords.contiguous()


# K6 (B=1, one launch) and K7 (B=2 and 8, one launch per level) on both
# paths; C=36: the CUDA-core body with scalar loads, C=256: bf16 on the
# tensor cores, fp32 on the CUDA cores, C=320: two channel chunks. fp32:
# sums of C products in another order (rtol 1e-5, atol 1e-5); bf16: within
# 1 bf16 ulp of the plain fp32 value
@pytest.mark.cuda
@pytest.mark.parametrize("coords_kind", ["smooth", "random", "far", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("c", [36, 256, 320])
def test_cuda_k6_k7_tile_and_per_query_paths_match_plain(cuda, coords_kind, dtype, b, c):
    pyr, coords = _tile_case(b, c, dtype, cuda, coords_kind, 50 + b + c)
    tile, per_query = _paths(pyr, coords)
    assert tile > 0 and (per_query > 0) == (coords_kind != "smooth")
    k2 = (2 * R + 1) ** 2
    if b == 1:
        got = corr_fused.corr_fused_all(pyr.f1, pyr.f2s, coords, R, dtype,
                                        query_hw=_grid(pyr))
    else:
        got = torch.full((coords.shape[0], 4 * k2), float("nan"), device=cuda, dtype=dtype)
        for lvl, f2 in enumerate(pyr.f2s):
            corr_fused.corr_fused_level(pyr.f1, f2, lvl, coords, R, got, (50, 90))
    want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, R, torch.float32)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
def test_cuda_fused_lookup_launches_k7_per_level_on_the_query_grid(cuda):
    pyr, coords = _tile_case(2, 64, torch.float32, cuda, "smooth", 60)
    n6, n7 = corr_fused.all_launches, corr_fused.level_launches
    out = corr_fused.corr_pyramid_lookup_fused(pyr, coords.reshape(2, 50, 90, 2), R)
    assert (corr_fused.all_launches - n6, corr_fused.level_launches - n7) == (0, 4)
    want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, R, torch.float32)
    torch.testing.assert_close(out.reshape(want.shape), want, atol=1e-5, rtol=1e-5)


def _bwd_inputs(b, c, dtype, dev, seed, coords_kind="random"):
    """7x11 maps; coords random (up to 15 px out, one far out) or smooth:
    the pixel grid plus N(0, 2 px), one far out (every K9 tile takes the
    shared-memory path at this size)."""
    pyr, coords = _fused_inputs(b, c, dtype, dev, seed)
    if coords_kind == "smooth":
        coords = _smooth_coords(b, 7, 11, seed, dev)
        coords[0] = torch.tensor([1e9, -1e9])
    g = torch.randn(coords.shape[0], 4 * (2 * R + 1) ** 2, generator=torch.Generator().manual_seed(seed))
    return pyr, coords, g.to(dev, dtype)


def _smooth_coords(b, h8, w8, seed, dev, sigma=2.0):
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h8), np.arange(w8), indexing="ij")
    grid = np.broadcast_to(np.stack([xs, ys], -1), (b, h8, w8, 2)).reshape(-1, 2)
    return torch.from_numpy((grid + rng.normal(0, sigma, grid.shape)).astype(np.float32)).to(dev)


def _check_k9(pyr, coords, g, dtype):
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    got = corr_fused.bwd_df2(pyr.f1, pyr.f2s, coords, g, R)
    want = corr_fused.bwd_df2_plain(pyr.f1.float(), [f.float() for f in pyr.f2s], coords, g, R)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w, **tol)


# B=2 exercises b = q // q_per_b; C=36 the scalar path; C=320 two chunks.
# fp32: sums of <= 400 products in another order (K9: in an order that
# changes from run to run, by atomics), so rtol 1e-5 of the result plus atol
# 1e-5; bf16: within 1 bf16 ulp of the plain fp32-accumulated value
@pytest.mark.cuda
@pytest.mark.parametrize("coords_kind", ["random", "smooth"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c", [(1, 64), (2, 64), (2, 36), (1, 320)])
def test_cuda_k8_k9_match_plain(cuda, dtype, b, c, coords_kind):
    pyr, coords, g = _bwd_inputs(b, c, dtype, cuda, 15, coords_kind)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    got = corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, R)
    want = corr_fused.bwd_df1_plain(pyr.f1.float(), [f.float() for f in pyr.f2s], coords, g, R)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want, **tol)
    assert torch.all(got.reshape(-1, c)[0] == 0)  # the far-out query reads nothing
    _check_k9(pyr, coords, g, dtype)


def _k9_inputs_50x90(b, dtype, dev, seed, coords, c=64):
    """50x90 maps (the supervised crop's level 0) of C channels at coords."""
    rng = np.random.default_rng(seed)
    f1 = torch.from_numpy(rng.normal(0, 1, (b, 50, 90, c)).astype(np.float32)).to(dev, dtype)
    f2 = torch.from_numpy(rng.normal(0, 1, (b, 50, 90, c)).astype(np.float32)).to(dev, dtype)
    pyr = corr_fused.build_fused_pyramid(f1, f2, 4)
    g = torch.from_numpy(rng.normal(0, 1, (b * 4500, 4 * (2 * R + 1) ** 2)).astype(np.float32))
    return pyr, coords, g.to(dev, dtype)


def _paths(pyr, coords):
    """(tiles on the shared-memory path, tiles adding per query) over all levels."""
    tiles = corr_fused.lookup_tiles(pyr.f1, pyr.f2s, coords, R, query_hw=_grid(pyr))
    return (sum(int(t.tile_path.sum()) for t in tiles),
            sum(int(((t.queries > 0) & ~t.tile_path).sum()) for t in tiles))


# 50x90 (the supervised crop's level 0), smooth coords, B=2: tiles at the
# ragged edges and on both samples; queries far out (they leave their tile's
# box) and queries 20 px off (their tile's box exceeds MAX_BOX_TAPS), so both
# paths run in one launch
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k9_mixed_tile_and_per_query_paths_match_plain(cuda, dtype):
    coords = _smooth_coords(2, 50, 90, 40, cuda)
    coords[::997] = torch.tensor([1e9, -1e9], device=cuda)
    diverging = [bi * 4500 + qy * 90 + qx for bi in (0, 1) for qy in (12, 24) for qx in (10, 40, 60)]
    coords[diverging] += 20.0
    pyr, coords, g = _k9_inputs_50x90(2, dtype, cuda, 41, coords)
    tile, per_query = _paths(pyr, coords)
    assert tile > 0 and per_query > 0
    _check_k9(pyr, coords, g, dtype)


# uniform coords over the map and beyond: every level-0 and level-1 tile's
# box (the whole map) exceeds MAX_BOX_TAPS and adds per query
@pytest.mark.cuda
def test_cuda_k9_box_beyond_the_limit_adds_per_query(cuda):
    rng = np.random.default_rng(42)
    coords = torch.from_numpy(np.stack([rng.uniform(-20, 110, 4500), rng.uniform(-20, 70, 4500)], 1)
                              .astype(np.float32)).to(cuda)
    pyr, coords, g = _k9_inputs_50x90(1, torch.float32, cuda, 43, coords)
    tiles = corr_fused.lookup_tiles(pyr.f1, pyr.f2s, coords, R, query_hw=_grid(pyr))
    assert not bool(tiles[0].tile_path.any()) and not bool(tiles[1].tile_path.any())
    _check_k9(pyr, coords, g, torch.float32)


def _k8_inputs_50x90(b, c, dtype, dev, seed, coords_kind):
    """C channels; coords smooth (the pixel grid plus N(0, 2 px): every tile
    takes the tile path) or mixed: queries far out (they leave their tile's
    box) and queries 20 px off (their tile's level-0 box exceeds
    MAX_BOX_TAPS and goes per query)."""
    coords = _smooth_coords(b, 50, 90, seed, dev)
    if coords_kind == "mixed":
        coords[::997] = torch.tensor([1e9, -1e9], device=dev)
        diverging = [bi * 4500 + qy * 90 + qx for bi in range(b) for qy in (12, 24)
                     for qx in (10, 40, 60)]
        coords[diverging] += 20.0
    return _k9_inputs_50x90(b, dtype, dev, seed + 1, coords, c)


def _check_k8(got, want, dtype):
    """fp32: sums of <= 400 products in another order (rtol 1e-5, atol 1e-4);
    bf16: within 2^-8 of the plain fp32 value (one bf16 ulp at most: the
    rounding of an exact sum is within half an ulp) plus 1e-4 for the
    cotangent's bf16 high and low parts (about 16 bits) over those sums."""
    assert got.dtype == dtype
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)


# K8's tile design at 50x90: B=1 and 2 (84 and 168 blocks), B=8 (672); B=2
# puts tiles at the ragged edges and on both samples; mixed coords run the
# tile and the per-query bodies in one launch; C = 36 the CUDA-core body with
# scalar loads, 256 one slice, 320 a ragged second slice. Two launches must
# give the same bits (no atomics, a fixed order of sums)
@pytest.mark.cuda
@pytest.mark.parametrize("coords_kind", ["smooth", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c", [(1, 256), (2, 256), (8, 256), (2, 36), (8, 36), (1, 320)])
def test_cuda_k8_tile_and_per_query_paths_match_plain(cuda, coords_kind, dtype, b, c):
    pyr, coords, g = _k8_inputs_50x90(b, c, dtype, cuda, 50 + b + c, coords_kind)
    tile, per_query = _paths(pyr, coords)
    assert tile > 0 and (per_query > 0) == (coords_kind == "mixed")
    got = corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, R)
    want = corr_fused.bwd_df1_plain(pyr.f1.float(), [f.float() for f in pyr.f2s], coords, g, R)
    _check_k8(got, want, dtype)
    assert torch.equal(corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, R), got)


# uniform coords over the map and beyond: every level-0 and level-1 tile's
# box (the whole map) exceeds MAX_BOX_TAPS, so those levels go per query and
# levels 2-3 take the tile path, into one accumulator
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k8_box_beyond_the_limit_goes_per_query(cuda, dtype):
    rng = np.random.default_rng(42)  # K9's coords: no level-0 or level-1 tile on the tile path
    coords = torch.from_numpy(np.stack([rng.uniform(-20, 110, 4500), rng.uniform(-20, 70, 4500)], 1)
                              .astype(np.float32)).to(cuda)
    pyr, coords, g = _k9_inputs_50x90(1, dtype, cuda, 45, coords)
    tiles = corr_fused.lookup_tiles(pyr.f1, pyr.f2s, coords, R, query_hw=_grid(pyr))
    assert not bool(tiles[0].tile_path.any()) and bool(tiles[3].tile_path.any())
    got = corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, R)
    want = corr_fused.bwd_df1_plain(pyr.f1.float(), [f.float() for f in pyr.f2s], coords, g, R)
    _check_k8(got, want, dtype)


# K8's per-query body at more shapes: uniform coords over the map and 20 px
# beyond send every level-0 tile per query (its box is the whole map, over
# MAX_BOX_TAPS): the chairs level 0 (46x62) at B=2, C = 36 (the CUDA-core body
# with scalar loads) and C = 320 (a ragged second channel slice) at B=1;
# two launches give the same bits
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h8,w8,c", [(2, 46, 62, 256), (1, 37, 53, 36), (1, 64, 64, 320)])
def test_cuda_k8_per_query_body_at_more_shapes(cuda, dtype, b, h8, w8, c):
    rng = np.random.default_rng(60 + c)
    q = b * h8 * w8
    coords = torch.from_numpy(np.stack([rng.uniform(-20, w8 + 20, q), rng.uniform(-20, h8 + 20, q)], 1)
                              .astype(np.float32)).to(cuda)
    f1 = torch.from_numpy(rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)).to(cuda, dtype)
    f2 = torch.from_numpy(rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)).to(cuda, dtype)
    pyr = corr_fused.build_fused_pyramid(f1, f2, 4)
    g = torch.from_numpy(rng.normal(0, 1, (q, 4 * (2 * R + 1) ** 2)).astype(np.float32)).to(cuda, dtype)
    tiles = corr_fused.lookup_tiles(pyr.f1, pyr.f2s, coords, R, query_hw=_grid(pyr))
    assert not bool(tiles[0].tile_path.any())
    got = corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, R)
    want = corr_fused.bwd_df1_plain(pyr.f1.float(), [f.float() for f in pyr.f2s], coords, g, R)
    _check_k8(got, want, dtype)
    assert torch.equal(corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, R), got)


@pytest.mark.cuda
def test_cuda_fused_lookup_backward_launches_k8_k9(cuda):
    pyr, coords, g = _bwd_inputs(1, 64, torch.float32, cuda, 16)
    f1 = pyr.f1.clone().requires_grad_()
    f2s = [f.clone().requires_grad_() for f in pyr.f2s]
    n1, n2 = corr_fused.bwd_df1_launches, corr_fused.bwd_df2_launches
    out = corr_fused.corr_pyramid_lookup_fused(
        corr_fused.FusedPyramid(f1, f2s), coords.reshape(1, 7, 11, 2), R)
    out.backward(g.reshape(out.shape))
    assert (corr_fused.bwd_df1_launches - n1, corr_fused.bwd_df2_launches - n2) == (1, 1)
    torch.testing.assert_close(
        f1.grad, corr_fused.bwd_df1_plain(pyr.f1, pyr.f2s, coords, g, R), atol=1e-5, rtol=1e-5)


def _window_case(dev, dtype, b, h8, w8, seed):
    """Planes of B samples at h8 x w8 (5x9: the last block of 8 queries
    partly filled; 55x127: ragged pooled sizes), coords up to 15 px out of
    bounds and four far out (+-1e9, +-3e38)."""
    f1, f2, coords = _lookup_inputs(b=b, h8=h8, w8=w8, c=64, seed=seed)
    far = [(1e9, -1e9), (-3e38, 3e38), (-1e9, 2.5), (3.5, 3e38)]
    coords.reshape(-1, 2)[:4] = far
    coords.reshape(-1, 2)[-1] = (-3e38, -1e9)
    planes = corr_plane.build_plane_pyramid(
        torch.from_numpy(f1).to(dev), torch.from_numpy(f2).to(dev), 4, dtype)
    return planes, torch.from_numpy(coords).to(dev)


# K10 and K11 run csrc/window.cuh's body, as K1 does: radius 4 the compiled
# body, 3 the one that takes the radius as an argument
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("hw", [(5, 9), (55, 127)])
def test_cuda_k10_matches_plain(cuda, dtype, radius, hw):
    """Support mode, one level a launch: a copy of plane values (bf16 -> fp32
    is exact), so the plain version's bits."""
    planes, c = _window_case(cuda, dtype, 2, *hw, seed=14)
    c = c.reshape(-1, 2)
    for lvl, plane in enumerate(planes):
        cl = (c / 2.0 ** lvl).contiguous()
        n = corr_lookup_v2.launches
        got = corr_lookup_v2.level_support(plane, cl, radius)
        assert corr_lookup_v2.launches == n + 1 and got.dtype == torch.float32
        assert torch.equal(got, window_support(plane, cl, radius))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("hw", [(5, 9), (55, 127)])
def test_cuda_k10_window_mode_matches_plain_composition(cuda, dtype, radius, hw):
    """Window mode, all levels in one launch, fp32 out: the plain support,
    combine (the same order and rounding) and level concat; two launches
    give the same bits."""
    planes, c = _window_case(cuda, dtype, 2, *hw, seed=15)
    flat = c.reshape(-1, 2)
    n = corr_lookup_v2.launches
    got = corr_lookup_v2.corr_pyramid_lookup_v2(planes, c, radius)
    assert corr_lookup_v2.launches == n + 1
    k2 = (2 * radius + 1) ** 2
    assert got.shape == (2, *hw, 4 * k2) and got.dtype == torch.float32
    want = torch.cat([combine_support(window_support(p, flat / 2.0 ** i, radius),
                                      flat / 2.0 ** i, radius) for i, p in enumerate(planes)], 1)
    torch.testing.assert_close(got.reshape(-1, 4 * k2), want, atol=1e-6, rtol=0)
    assert torch.all(got.reshape(-1, 4 * k2)[:4] == 0) and torch.all(got[-1, -1, -1] == 0)
    assert torch.equal(corr_lookup_v2.corr_pyramid_lookup_v2(planes, c, radius), got)


# K5: a width that is not a multiple of the 128-pixel tile, Cout not a
# multiple of the 32-channel tile; fp32: summation order of 9*C terms only
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 20, 40, 64, 64), (1, 11, 90, 128, 72)])
def test_cuda_k5_matches_plain(cuda, dtype, relu, shape):
    b, h, w, c, co = shape
    g = torch.Generator().manual_seed(17)
    x = torch.randn(b, h, w, c, generator=g).to(cuda, dtype)
    k = (0.1 * torch.randn(3, 3, c, co, generator=g)).to(cuda, dtype)
    bias = (0.1 * torch.randn(co, generator=g)).to(cuda, dtype)
    n = conv3x3.bare_launches
    y = conv3x3.conv3x3_fused(x, k, bias, relu)
    assert conv3x3.bare_launches == n + 1 and y.dtype == dtype
    y_ref = conv3x3.conv3x3_bare_plain(x, k, bias, relu)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=rtol, atol=1e-4)
    if relu:
        assert float(y.min()) == 0.0


# The conv's tensor-core body (bf16): ragged widths (the KITTI fnet's 155,
# 90, the chairs Baseline's 248) at small H, where there are fewer 64-pixel
# row tiles than warpgroups on the card; C = 96 with Cout = 72 (two parts of
# 48 channels); B = 2; and the 128-channel stage of a 448x1024 forward, which
# runs one warpgroup an SM
TC_SHAPES = [(2, 6, 155, 64, 64), (2, 5, 90, 96, 72), (1, 7, 248, 128, 128),
             (2, 9, 155, 96, 96), (2, 56, 128, 128, 128)]


def _conv_inputs(shape, dtype, dev, seed):
    b, h, w, c, co = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g).to(dev, dtype)
    k = (torch.randn(3, 3, c, co, generator=g) * (2.0 / (9 * co)) ** 0.5).to(dev, dtype)
    bias = (0.1 * torch.randn(co, generator=g)).to(dev, dtype)
    return x, k, bias


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_cuda_k2_tensor_cores_match_plain(cuda, shape):
    x, k, bias = _conv_inputs(shape, torch.bfloat16, cuda, 21)
    n = conv3x3.tc_launches
    y, st = conv3x3.conv3x3_stats(x, k, bias)
    assert conv3x3.tc_launches == n + 1
    y_ref, st_ref = conv3x3.conv3x3_stats_plain(x, k, bias)
    # y: 1 bf16 ulp of the fp32-accumulated value; the statistics come from
    # the same fp32 sums in another order
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=1e-2, atol=1e-5)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_cuda_k5_tensor_cores_match_plain(cuda, shape, relu):
    x, k, bias = _conv_inputs(shape, torch.bfloat16, cuda, 22)
    n = conv3x3.tc_launches
    y = conv3x3.conv3x3_fused(x, k, bias, relu)
    assert conv3x3.tc_launches == n + 1
    y_ref = conv3x3.conv3x3_bare_plain(x, k, bias, relu)
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=1e-2, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 155, 96, 72), (2, 56, 128, 128, 128)])
def test_cuda_k2_tensor_core_stats_are_bit_identical(cuda, shape):
    x, k, bias = _conv_inputs(shape, torch.bfloat16, cuda, 23)
    y1, st1 = conv3x3.conv3x3_stats(x, k, bias)
    y2, st2 = conv3x3.conv3x3_stats(x, k, bias)
    assert torch.equal(st1, st2) and torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("c,co,dtype,tc", [
    (64, 64, torch.bfloat16, True), (96, 96, torch.bfloat16, True),
    (128, 128, torch.bfloat16, True), (64, 64, torch.float32, False),
    (128, 128, torch.float32, False), (8, 64, torch.bfloat16, False),
])
def test_cuda_conv_body_counter_follows_the_rule(cuda, c, co, dtype, tc):
    x, k, bias = _conv_inputs((1, 6, 20, c, co), dtype, cuda, 24)
    counts = (conv3x3.launches, conv3x3.bare_launches, conv3x3.tc_launches)
    y, _ = conv3x3.conv3x3_stats(x, k, bias)
    y5 = conv3x3.conv3x3_fused(x, k, bias)
    assert (conv3x3.launches, conv3x3.bare_launches, conv3x3.tc_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 2 * tc)
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), conv3x3.conv3x3_stats_plain(x, k, bias)[0].float(),
                               rtol=rtol, atol=1e-4)
    torch.testing.assert_close(y5.float(), y.float(), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_k5_backward_matches_the_cpu(cuda):
    """The VJP (PyTorch's conv backward, relu mask from the recomputed conv)
    on the card against the same on the CPU, fp32."""
    g = torch.Generator().manual_seed(18)
    x, k, bias, gy = (torch.randn(*s, generator=g) for s in
                      ((1, 12, 20, 32), (3, 3, 32, 48), (48,), (1, 12, 20, 48)))
    grads = []
    for dev in (torch.device("cpu"), cuda):
        args = [t.to(dev).requires_grad_() for t in (x, 0.1 * k, 0.1 * bias)]
        y = conv3x3.conv3x3_fused(*args, relu=True)
        grads.append(torch.autograd.grad(y, args, gy.to(dev)))
    for a, b in zip(*grads):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)


# K11: a copy of the volume's values into the same bilinear formula, fp32;
# all levels in one launch
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("hw", [(5, 9), (55, 127)])
def test_cuda_k11_matches_plain(cuda, dtype, radius, hw):
    f1, f2, coords = _lookup_inputs(b=2, h8=hw[0], w8=hw[1], c=64, seed=19)
    pyr = build_corr_pyramid_from_fmaps(
        torch.from_numpy(f1).to(cuda), torch.from_numpy(f2).to(cuda), 4, dtype)
    c = torch.from_numpy(coords).to(cuda)
    c[0, 0, :4] = torch.tensor([[-3e38, 3e38], [1e9, 2.0], [3.5, -4e6], [-1e9, 1e9]])
    n = corr_lookup.launches
    got = corr_lookup.corr_pyramid_lookup_pallas(pyr, c, radius)
    assert corr_lookup.launches == n + 1 and got.dtype == torch.float32
    want = torch.cat([corr_lookup.lookup_level_plain(v, c / 2.0 ** i, radius)
                      for i, v in enumerate(pyr)], -1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.all(got[0, 0, :4] == 0)
    assert torch.equal(corr_lookup.corr_pyramid_lookup_pallas(pyr, c, radius), got)
    k2 = (2 * radius + 1) ** 2
    one = corr_lookup.lookup_level_pallas(pyr[1], (c / 2).contiguous(), radius)
    assert corr_lookup.launches == n + 3
    torch.testing.assert_close(one, got[..., k2:2 * k2], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_einsum_lookup_matches_the_cpu(cuda, dtype):
    """The einsum backend's lookup (plain PyTorch, no hand kernel) on the
    card against the CPU on the same volumes, far-out coords included."""
    f1, f2, coords = _lookup_inputs(b=2, h8=5, w8=9, c=64, seed=40)
    coords[0, 0, 0] = (1e9, -1e9)
    coords[1, 4, 8] = (-3e38, 3e38)
    pyr = build_corr_pyramid_from_fmaps(torch.from_numpy(f1), torch.from_numpy(f2), 4, dtype)
    c = torch.from_numpy(coords)
    want = corr_pyramid_lookup(pyr, c, R)
    got = corr_pyramid_lookup([v.to(cuda) for v in pyr], c.to(cuda), R)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_einsum_lookup_refuses_tf32(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    f1, f2, coords = _lookup_inputs(b=1, h8=5, w8=9, c=64, seed=41)
    pyr = build_corr_pyramid_from_fmaps(torch.from_numpy(f1).to(cuda), torch.from_numpy(f2).to(cuda), 4)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        corr_pyramid_lookup(pyr, torch.from_numpy(coords).to(cuda), R)


# ---- radius 3 (the small model's) on K6-K9, and GMA / small end to end -------

R3 = 3


def _r3_case(b, c, dtype, dev, coords_kind, seed):
    """_tile_case's 50x90 grid and coords; and the paths of K6-K9's tiles at
    radius 3: (tile path, per query) over all levels."""
    pyr, coords = _tile_case(b, c, dtype, dev, coords_kind, seed)
    tiles = corr_fused.lookup_tiles(pyr.f1, pyr.f2s, coords, R3, query_hw=_grid(pyr))
    return pyr, coords, (sum(int(t.tile_path.sum()) for t in tiles),
                         sum(int(((t.queries > 0) & ~t.tile_path).sum()) for t in tiles))


# K6 (B=1) and K7 (B=2, one launch per level) at radius 3: 8x8 supports, 49
# outputs a level; smooth coords take the tile path, mixed and random both
@pytest.mark.cuda
@pytest.mark.parametrize("coords_kind", ["smooth", "mixed", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c", [(1, 128), (2, 128), (1, 36)])
def test_cuda_k6_k7_at_radius_3_match_plain(cuda, coords_kind, dtype, b, c):
    pyr, coords, (tile, per_query) = _r3_case(b, c, dtype, cuda, coords_kind, 70 + b + c)
    assert tile > 0 and (per_query > 0) == (coords_kind != "smooth")
    k2 = (2 * R3 + 1) ** 2
    if b == 1:
        got = corr_fused.corr_fused_all(pyr.f1, pyr.f2s, coords, R3, dtype,
                                        query_hw=_grid(pyr))
    else:
        got = torch.full((coords.shape[0], 4 * k2), float("nan"), device=cuda, dtype=dtype)
        for lvl, f2 in enumerate(pyr.f2s):
            corr_fused.corr_fused_level(pyr.f1, f2, lvl, coords, R3, got, (50, 90))
    want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, R3, torch.float32)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    assert got.shape == (coords.shape[0], 4 * k2) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want, **tol)


# K8 and K9 at radius 3 on both paths, with the limits of the radius-4 tests
@pytest.mark.cuda
@pytest.mark.parametrize("coords_kind", ["smooth", "mixed", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c", [(1, 128), (2, 128), (2, 36)])
def test_cuda_k8_k9_at_radius_3_match_plain(cuda, coords_kind, dtype, b, c):
    pyr, coords, (tile, per_query) = _r3_case(b, c, dtype, cuda, coords_kind, 80 + b + c)
    assert tile > 0 and (per_query > 0) == (coords_kind != "smooth")
    g = torch.randn(coords.shape[0], 4 * (2 * R3 + 1) ** 2,
                    generator=torch.Generator().manual_seed(b + c)).to(cuda, dtype)
    f1p, f2p = pyr.f1.float(), [f.float() for f in pyr.f2s]
    got = corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, R3)
    _check_k8(got, corr_fused.bwd_df1_plain(f1p, f2p, coords, g, R3), dtype)
    assert torch.equal(corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, R3), got)
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-4, rtol=1e-2)
    for a, w in zip(corr_fused.bwd_df2(pyr.f1, pyr.f2s, coords, g, R3),
                    corr_fused.bwd_df2_plain(f1p, f2p, coords, g, R3)):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w, **tol)


# the GMA model (2 heads, position and content, every gamma 0.5) and the small
# model (radius 3, bilinear upsampling), 64x96, 4 iterations, fp32: the card
# (kernels) against the CPU (plain versions), as chip_smoke's parity phase
@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "plane"])
@pytest.mark.parametrize("model_kw", [dict(gma=True, num_heads=2, position_and_content=True),
                                      dict(small=True)], ids=["gma", "small"])
def test_cuda_gma_and_small_forwards_match_the_cpu(cuda, model_kw, backend):
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

    gen = torch.Generator().manual_seed(5)
    model = RAFT(RAFTConfig(iters=4, lookup_backend=backend, **model_kw), generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("aggregator.gamma"):
                p.fill_(0.5)
    img1 = torch.rand(1, 64, 96, 3, generator=gen)
    img2 = torch.roll(img1, (2, 3), (1, 2))
    cpu = model(img1, img2, final_flow_only=True)["flow_up"][-1]
    model.to(cuda)
    n = corr_fused.all_launches + corr_plane.launches
    gpu = model(img1.to(cuda), img2.to(cuda), final_flow_only=True)["flow_up"][-1].cpu()
    assert corr_fused.all_launches + corr_plane.launches - n == 4
    d = (gpu - cpu).abs()
    assert torch.isfinite(gpu).all() and float(d.mean()) < 1e-3 and float(d.max()) < 2e-2


def _k12_case(dev, levels, radius, g_dtype, seed, b=2, h8=5, w8=9):
    """A window cotangent g [BQ, L * (2r+1)^2] at coords in, partly and far
    out of bounds (B=2 at 5x9 by default: 90 queries)."""
    _, _, coords = _lookup_inputs(b=b, h8=h8, w8=w8, c=1, seed=seed)
    coords[0, 0, 0] = (1e9, -1e9)
    coords[-1, -1, -1] = (-3e38, 3e38)
    c = torch.from_numpy(coords).reshape(-1, 2).to(dev)
    rng = np.random.default_rng(seed + 1)
    g = torch.from_numpy(rng.normal(0, 1, (c.shape[0], levels * (2 * radius + 1) ** 2))
                         .astype(np.float32)).to(dev, g_dtype)
    shapes = [(-(-h8 // 2 ** lvl), -(-w8 // 2 ** lvl)) for lvl in range(levels)]
    return g, c, shapes


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("levels,radius", [(1, 4), (4, 4), (4, 3), (2, 1), (4, 0)])
def test_cuda_k12_gives_the_plain_bits(cuda, g_dtype, out_dtype, levels, radius):
    """K12 (the plane lookups' backward) writes every plane row whole, equal
    to ``lookup_vjp_dvols`` bit for bit (no FMA in the transposed lerp), at
    the ragged 5x9 (scalar rows) and 8x16 (16-byte rows) shapes."""
    from flow_supervisor_tpu_torch.ops.corr import lookup_vjp_dvols

    for b, h8, w8 in ((2, 5, 9), (1, 8, 16)):
        g, c, shapes = _k12_case(cuda, levels, radius, g_dtype, seed=40 + radius, b=b, h8=h8, w8=w8)
        before = corr_plane.bwd_launches
        got = corr_plane.lookup_bwd(g, c, shapes, radius, out_dtype)
        want = lookup_vjp_dvols(g, c, shapes, radius, out_dtype)
        assert corr_plane.bwd_launches == before + 1
        for gl, wl, (h2, w2) in zip(got, want, shapes):
            assert gl.shape == (c.shape[0], h2, w2) and gl.dtype == out_dtype
            assert torch.equal(gl, wl)
        assert all(torch.all(gl[0] == 0) for gl in got)  # the far query's rows


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["plane", "pallas"])
def test_cuda_plane_lookup_grads_match_the_cpu(cuda, backend):
    """d f1 / d f2 through the plane build and each backend's lookup (K1 or
    K10 forward, K12 backward) on the card against the same on the CPU."""
    from flow_supervisor_tpu_torch.kernels.corr_lookup_v2 import corr_pyramid_lookup_v2

    f1, f2, coords = _lookup_inputs(b=2, h8=5, w8=9, c=64, seed=50)
    g = np.random.default_rng(51).normal(0, 1, (2, 5, 9, 4 * 81)).astype(np.float32)
    res = []
    for dev in (torch.device("cpu"), cuda):
        a = torch.from_numpy(f1).to(dev).requires_grad_()
        b = torch.from_numpy(f2).to(dev).requires_grad_()
        planes = corr_plane.build_plane_pyramid(a, b, 4)
        c = torch.from_numpy(coords).to(dev)
        out = (corr_plane.corr_pyramid_lookup_plane(planes, c, R) if backend == "plane"
               else corr_pyramid_lookup_v2(planes, c, R))
        res.append([t.cpu() for t in torch.autograd.grad(
            (out * torch.from_numpy(g).to(dev)).sum(), (a, b))])
    for got, want in zip(res[1], res[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


# ---- the update block's conv epilogues (csrc/update_epilogue.cu) ----------------

# the inference cells' update-block grid (B=32, 448x1024 / 8) in bf16 and the
# evaluation cell's (B=1, Sintel padded to 440x1024 / 8) in fp32
EPILOGUE_SHAPES = [((32, 56, 128), torch.bfloat16), ((1, 55, 128), torch.float32)]
# (c, offset, width): the conv's channels written at a channel offset of a
# buffer `width` wide (width None: in place over the conv's output)
EPILOGUE_ACT_CASES = [
    (True, 1.0, 256, 0, None),  # convc1, the flow and mask heads' first convs
    (True, 1.0, 192, 0, 256),  # convc2 into [cor | flo]
    (True, 1.0, 64, 192, 256),  # convf2 into [cor | flo]
    (True, 1.0, 126, 256, 384),  # the motion conv into RAFT's [h | x]: a masked tail
    (True, 1.0, 126, 0, 128),  # the motion conv into GMA's contiguous motion
    (False, 1.0, 2, 0, None),  # the flow head's last conv
    (False, 0.25, 576, 0, None),  # the mask head's last conv
    (True, 1.0, 64, 3, 80),  # a misaligned slot: the scalar body
]


def _epilogue_tol(dtype):
    # bf16: 1 ulp (the kernel's and ATen's exp / tanh, and FMA, may differ in
    # fp32's last bits, which can tip a rounding); fp32: those bits alone
    return dict(rtol=1e-2, atol=1e-5) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-6)


def _slot(x_shape, c, off, width, dtype, dev, gen):
    buf = torch.randn(*x_shape[:3], width, generator=gen).to(dev, dtype)
    return buf, buf[..., off:off + c]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", EPILOGUE_SHAPES)
@pytest.mark.parametrize("relu,scale,c,off,width", EPILOGUE_ACT_CASES)
@pytest.mark.parametrize("bias_f32", [True, False])  # a model held in fp32, or in the data's dtype
def test_cuda_update_epilogue_act_matches_plain(cuda, shape, dtype, relu, scale, c, off, width,
                                                bias_f32):
    gen = torch.Generator().manual_seed(c + off)
    x = torch.randn(*shape, c, generator=gen).to(cuda, dtype)
    bias = torch.randn(c, generator=gen).to(cuda, torch.float32 if bias_f32 else dtype)
    if width is None:
        buf, out = None, x.clone()
    else:
        buf, out = _slot(x.shape, c, off, width, dtype, cuda, gen)
    before = None if buf is None else buf.clone()
    want = update_epilogue.bias_act_plain(x, bias, torch.empty_like(x), relu, scale)
    n = update_epilogue.launches
    got = update_epilogue.bias_act(out if width is None else x, bias, out, relu, scale)
    torch.cuda.synchronize()
    assert update_epilogue.launches == n + 1 and got.data_ptr() == out.data_ptr()
    torch.testing.assert_close(got.float(), want.float(), **_epilogue_tol(dtype))
    if buf is not None:  # the buffer's other channels are as they were
        rest = torch.ones(width, dtype=torch.bool, device=cuda)
        rest[off:off + c] = False
        assert torch.equal(buf[..., rest], before[..., rest])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", EPILOGUE_SHAPES)
@pytest.mark.parametrize("width", [384, 512, 131])
@pytest.mark.parametrize("bias_f32", [True, False])
def test_cuda_update_epilogue_gru_modes_match_plain(cuda, shape, dtype, width, bias_f32):
    """The gate (sigmoid(z) over z, r * h into the h slot of a [h | x]
    buffer `width` wide: RAFT's, GMA's, and a stride that takes the scalar
    body), then the update (h' into the state, from h or in place over it,
    and into the slot); x's channels untouched."""
    c = 128
    gen = torch.Generator().manual_seed(width)
    z, r, q = (torch.randn(*shape, c, generator=gen).to(cuda, dtype) for _ in range(3))
    bdt = torch.float32 if bias_f32 else dtype
    bz, br, bq = (torch.randn(c, generator=gen).to(cuda, bdt) for _ in range(3))
    h = torch.tanh(torch.randn(*shape, c, generator=gen)).to(cuda, dtype)
    hx, slot = _slot(z.shape, c, 0, width, dtype, cuda, gen)
    x_before = hx[..., c:].clone()
    tol = _epilogue_tol(dtype)

    zs_want, rh_want = z.clone(), torch.empty_like(z)
    update_epilogue.gru_gate_plain(zs_want, r, bz, br, h, rh_want)
    n = update_epilogue.launches
    zs = update_epilogue.gru_gate(z, r, bz, br, h, slot)
    torch.cuda.synchronize()
    torch.testing.assert_close(zs.float(), zs_want.float(), **tol)
    torch.testing.assert_close(slot.float(), rh_want.float(), **tol)

    for in_place in (False, True):
        state = h.clone() if in_place else torch.empty_like(h)
        want = torch.empty_like(h)
        update_epilogue.gru_update_plain(q, bq, zs_want, h, want, torch.empty_like(h))
        got = update_epilogue.gru_update(q, bq, zs_want, state if in_place else h, state, slot)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(slot, got)
    assert update_epilogue.launches == n + 3
    assert torch.equal(hx[..., c:], x_before)


@pytest.mark.cuda
def test_cuda_fused_update_block_matches_its_op_chain(cuda):
    """RAFT's and GMA's update blocks on the card, fp32 with TF32 off: the
    fused path (no gradient, the kernel) against the op chain (under
    gradient), two calls in one set of buffers."""
    from flow_supervisor_tpu_torch.models import gma, update
    from flow_supervisor_tpu_torch.models.layers import init_weights_

    gen = torch.Generator().manual_seed(60)
    blocks = [update.BasicUpdateBlock(128, 4, 4), gma.GMAUpdateBlock(128, 4, 4, 1)]
    for blk in blocks:
        init_weights_(blk, "update", gen)
    with torch.no_grad():
        blocks[1].aggregator.gamma.fill_(0.5)

    def cl(t):
        return t.to(cuda).contiguous(memory_format=torch.channels_last)

    b, h8, w8 = 2, 12, 20
    net = cl(torch.tanh(torch.randn(b, 128, h8, w8, generator=gen)))
    inp = cl(torch.relu(torch.randn(b, 128, h8, w8, generator=gen)))
    steps = [(cl(torch.randn(b, 324, h8, w8, generator=gen)),
              cl(2 * torch.randn(b, 2, h8, w8, generator=gen))) for _ in range(2)]
    attn = torch.softmax(torch.randn(b, 1, h8 * w8, h8 * w8, generator=gen), -1).to(cuda)
    for blk, extra in zip(blocks, ((), (attn,))):
        blk = blk.to(cuda, memory_format=torch.channels_last)
        want, h = [], net
        for corr, flow in steps:
            out = blk(h, inp, corr, flow, *extra)
            want.append([t.detach() for t in out])
            h = out[0].detach()
        n = update_epilogue.launches
        with torch.no_grad():
            buffers = blk.buffers(net, inp)
            h = net
            for (corr, flow), w_out in zip(steps, want):
                out = blk(h, inp, corr, flow, *extra, buffers=buffers)
                for g_t, w_t in zip(out, w_out):
                    torch.testing.assert_close(g_t, w_t, rtol=1e-5, atol=1e-5)
                h = out[0]
        assert update_epilogue.launches == n + 2 * 13  # 13 epilogues a call
