"""The port's kernel modules (K1 corr_plane, K2 conv3x3, K3/K4 norm, K6/K7
corr_fused, K10 corr_lookup_v2) vs the JAX package's Pallas kernels, on CPU.

On CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode, as its own tests do. fp32,
atol 1e-5 (only summation order differs). tests/test_torch_port_cuda.py
holds the CUDA kernels against these plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.kernels import corr_fused as jcf
from flow_supervisor_tpu.kernels import corr_lookup_v2 as jv2
from flow_supervisor_tpu.kernels import corr_plane as jcp
from flow_supervisor_tpu.kernels.conv3x3 import conv3x3_stats as jconv3x3_stats
from flow_supervisor_tpu.kernels.corr_lookup_v2 import build_padded_pyramid
from flow_supervisor_tpu.kernels.norm import _norm_impl, instance_norm_apply as japply
from flow_supervisor_tpu.models.layers import instance_norm as jinstance_norm
from flow_supervisor_tpu.ops import corr as jcorr
from flow_supervisor_tpu_torch.kernels import conv3x3, corr_fused, corr_lookup_v2, corr_plane, norm

R = 4
ATOL = 1e-5


def _lookup_inputs(b=1, h8=8, w8=16, c=16, seed=0):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)
    coords = np.stack(
        [rng.uniform(-15, w8 + 15, (b, h8, w8)), rng.uniform(-15, h8 + 15, (b, h8, w8))], -1
    ).astype(np.float32)
    return f1, f2, coords


def _port_lookup(f1, f2, coords, levels=4, out_dtype=torch.float32):
    planes = corr_plane.build_plane_pyramid(
        torch.from_numpy(f1), torch.from_numpy(f2), levels
    )
    return corr_plane.corr_pyramid_lookup_plane(planes, torch.from_numpy(coords), R, out_dtype)


@pytest.mark.parametrize("shape", [(1, 8, 16), (2, 5, 9)], ids=["bq128", "bq90"])
def test_k1_plain_matches_pallas_plane_kernel(shape):
    """Windows fully and partly out of bounds; a query count that is not a
    multiple of any tile (2*5*9 = 90)."""
    f1, f2, coords = _lookup_inputs(*shape)
    got = _port_lookup(f1, f2, coords)
    pyr = build_padded_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, R)
    want = jcp.corr_pyramid_lookup_plane(pyr, jnp.asarray(coords), R, dy_major=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_k1_plain_matches_gather_oracle():
    f1, f2, coords = _lookup_inputs(b=1, h8=9, w8=13, c=32, seed=1)
    got = _port_lookup(f1, f2, coords)
    vols = jcorr.build_corr_pyramid_from_fmaps(jnp.asarray(f1), jnp.asarray(f2), 4)
    want = jcorr.corr_pyramid_lookup_gather(vols, jnp.asarray(coords), R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("levels", [2, 4])
@pytest.mark.parametrize("radius", [1, 3])
def test_k1_plain_matches_gather_oracle_at_other_radii(radius, levels):
    """K1's plain version (the CUDA kernel's yardstick on the card) at radii
    other than RAFT's 4, with 2 and 4 levels; B=2, windows partly and fully
    out of bounds."""
    f1, f2, coords = _lookup_inputs(b=2, h8=9, w8=13, c=32, seed=10 + radius)
    planes = corr_plane.build_plane_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), levels)
    got = corr_plane.corr_pyramid_lookup_plane(planes, torch.from_numpy(coords), radius)
    vols = jcorr.build_corr_pyramid_from_fmaps(jnp.asarray(f1), jnp.asarray(f2), levels)
    want = jcorr.corr_pyramid_lookup_gather(vols, jnp.asarray(coords), radius)
    assert got.shape == want.shape == (2, 9, 13, levels * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_k1_far_out_of_bounds_coords_read_zero():
    f1, f2, coords = _lookup_inputs(seed=2)
    coords[0, 0, 0] = (1e9, -1e9)
    coords[0, 0, 1] = (-3e38, 3e38)
    got = _port_lookup(f1, f2, coords)
    assert torch.all(got[0, 0, :2] == 0)
    assert torch.isfinite(got).all()


def test_k1_bf16_output_is_the_rounded_fp32_output():
    f1, f2, coords = _lookup_inputs(seed=3)
    f32 = _port_lookup(f1, f2, coords)
    b16 = _port_lookup(f1, f2, coords, out_dtype=torch.bfloat16)
    assert b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))


def _port_fused(f1, f2, coords, levels=4, out_dtype=torch.float32):
    pyr = corr_fused.build_fused_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), levels)
    return corr_fused.corr_pyramid_lookup_fused(pyr, torch.from_numpy(coords), R, out_dtype)


def _port_v2(f1, f2, coords, levels=4):
    planes = corr_plane.build_plane_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), levels)
    return corr_lookup_v2.corr_pyramid_lookup_v2(planes, torch.from_numpy(coords), R)


@pytest.mark.parametrize("c,b", [(16, 1), (32, 2)], ids=["c16_b1_k6", "c32_b2_k7"])
def test_k6_k7_plain_matches_pallas_fused_kernel(c, b):
    """B=1 takes the all-levels path (K6), B=2 the per-level path (K7) in both
    packages; C=16 scales by an exact reciprocal, C=32 divides; windows fully
    and partly out of bounds (coords up to 15 px out)."""
    f1, f2, coords = _lookup_inputs(b=b, c=c, seed=4)
    got = _port_fused(f1, f2, coords)
    pyr = jcf.build_fused_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, R)
    want = jcf.corr_pyramid_lookup_fused(pyr, jnp.asarray(coords), R, dy_major=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_k10_plain_matches_pallas_window_kernel():
    """Level by level, the support patches [BQ, 2r+2, 2r+2] against the first
    2r+2 of the Pallas kernel's 16 support columns, then the whole lookup
    against the JAX composition of those patches (``_combine``, dx-major
    reorder, level concat, as ``corr_lookup_v2._lookup_impl`` does). B=2."""
    f1, f2, coords = _lookup_inputs(b=2, c=32, seed=5)
    planes = corr_plane.build_plane_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    pyr = build_padded_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, R)
    flat = coords.reshape(-1, 2)
    k, sup = 2 * R + 1, 2 * R + 2
    want = []
    for lvl, (plane, jplane) in enumerate(zip(planes, pyr.planes)):
        cl = flat / 2.0 ** lvl
        got = corr_lookup_v2.level_support(plane, torch.from_numpy(cl), R)
        jsup, frac = jv2._level_support(jplane, pyr.shapes[lvl], jnp.asarray(cl), R)
        np.testing.assert_allclose(got.numpy(), np.asarray(jsup)[:, :, :sup], atol=ATOL, rtol=0)
        want.append(jnp.transpose(jv2._combine(jsup, frac, k), (0, 2, 1)).reshape(-1, k * k))
    want = np.asarray(jnp.concatenate(want, axis=-1)).reshape(*coords.shape[:3], -1)
    got = _port_v2(f1, f2, coords)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_k6_k7_k10_far_out_of_bounds_coords_read_zero(backend):
    f1, f2, coords = _lookup_inputs(b=2, seed=7)
    coords[0, 0, 0] = (1e9, -1e9)
    coords[1, 0, 1] = (-3e38, 3e38)
    got = (_port_fused if backend == "fused" else _port_v2)(f1, f2, coords)
    assert torch.all(got[0, 0, 0] == 0) and torch.all(got[1, 0, 1] == 0)
    assert torch.isfinite(got).all()


def test_k6_k7_wrappers_reject_bad_layouts():
    f1, f2 = torch.zeros(1, 8, 16), torch.zeros(1, 2, 4, 16)
    coords = torch.zeros(8, 2)
    with pytest.raises(ValueError):
        corr_fused.corr_fused_all(f1, [torch.zeros(1, 2, 4, 8)], coords)  # channel mismatch
    with pytest.raises(ValueError):
        corr_fused.corr_fused_all(f1, [f2.to(torch.bfloat16)], coords)  # dtype mismatch
    with pytest.raises(ValueError):
        corr_fused.corr_fused_all(f1, [f2], torch.zeros(7, 2))
    with pytest.raises(ValueError):
        corr_fused.corr_fused_level(f1, f2, 1, coords, R, torch.zeros(8, 81))  # stripe 1 too wide
    with pytest.raises(ValueError):
        corr_lookup_v2.level_support(torch.zeros(8, 4, 4), torch.zeros(8, 2, dtype=torch.float64))


CONV_SHAPES = [
    (2, 16, 24, 64, 64),
    (1, 8, 16, 8, 16),
    (2, 24, 16, 96, 96),
    (1, 16, 32, 128, 128),
    (1, 7, 10, 32, 32),  # width not a multiple of 8
]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=[str(s) for s in CONV_SHAPES])
def test_k2_plain_matches_pallas_conv_stats(shape, relu):
    b, h, w, c, co = shape
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, c, co)).astype(np.float32)
    bias = rng.normal(0, 0.1, (co,)).astype(np.float32)
    y, st = conv3x3.conv3x3_stats(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias))
    out = norm.instance_norm_apply(y, st, relu=relu)
    if w % 8 == 0:
        jy, jst = jconv3x3_stats(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), interpret=True)
        jout = japply(jy, jst, relu=relu, interpret=True)
    else:  # the Pallas conv needs w % 8 == 0; the JAX pair falls back to conv + norm
        from flow_supervisor_tpu.kernels.conv3x3 import _conv_reference

        jy = _conv_reference(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
        jout, jst = _norm_impl(jy, 1e-5, relu, interpret=True)
    # fp32 sums of up to 9 * 128 terms in another order: atol 1e-5 plus rtol 1e-5
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 13, 24, 64), (1, 3, 7, 32), (2, 9, 16, 128)])
def test_k3_k4_plain_match_pallas_norm_and_jnp_norm(shape, relu):
    rng = np.random.default_rng(8)
    x = (rng.normal(0, 1, shape) * 3 + 1.5).astype(np.float32)
    got = norm.instance_norm(torch.from_numpy(x), relu=relu)
    st = norm.instance_norm_stats(torch.from_numpy(x))
    jy, jst = _norm_impl(jnp.asarray(x), 1e-5, relu, interpret=True)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    ref = jinstance_norm(jnp.asarray(x))
    if relu:
        ref = jnp.maximum(ref, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_wrappers_reject_bad_layouts():
    x = torch.zeros(1, 4, 6, 8)
    with pytest.raises(ValueError):
        norm.instance_norm_stats(x.permute(0, 2, 1, 3))  # not contiguous
    with pytest.raises(TypeError):
        norm.instance_norm_stats(x.double())
    with pytest.raises(ValueError):
        norm.instance_norm_apply(x, torch.zeros(1, 2, 9))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_stats(x, torch.zeros(3, 3, 4, 8), torch.zeros(8))
    with pytest.raises(TypeError):
        conv3x3.conv3x3_stats(x, torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16), torch.zeros(8))
    with pytest.raises(ValueError):
        corr_plane.corr_lookup([torch.zeros(5, 4, 4)], torch.zeros(4, 2), R)
    with pytest.raises(ValueError):
        corr_plane.corr_lookup([torch.zeros(4, 4, 4)], torch.zeros(4, 2, dtype=torch.float64), R)
