"""K3 / K4 (instance-norm statistics and apply) on the CPU: the rule that
picks the kernels' vector or scalar body, and the plain versions, which the
wrappers take on CPU tensors, against the JAX package at the shapes where
the bodies differ (C = 36, M = 1, M not a multiple of a tile's rows); the
conv + instance-norm pair's output through the same plain versions.

The JAX side runs its Pallas kernels in interpret mode (the JAX package's
own tests run them so on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.kernels.conv3x3 import conv3x3_instnorm_relu as jconv_pair
from flow_supervisor_tpu.kernels.norm import _norm_impl, instance_norm_apply as japply
from flow_supervisor_tpu_torch.kernels import conv3x3, norm

# the fnet's norm shapes: a 448x1024 forward at B=1 (2 images) and B=8 (16),
# the chairs Baseline step (20 images at 368x496); then ragged ones
FNET_SHAPES = [(n, h // s, w // s, c) for n, h, w in ((2, 448, 1024), (16, 448, 1024), (20, 368, 496))
               for s, c in ((2, 64), (4, 96), (8, 128))]
RAGGED_SHAPES = [(1, 55, 127, 64), (2, 37, 50, 96), (2, 46, 155, 96), (3, 1, 1, 128)]


def _like(shape, dtype, offset=0):
    """A tensor of `shape` whose data starts `offset` elements into an
    allocation (the rule reads only C, the dtype and the address)."""
    return torch.zeros(offset + 1, dtype=dtype)[offset:].expand(shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", FNET_SHAPES + RAGGED_SHAPES,
                         ids=[str(s) for s in FNET_SHAPES + RAGGED_SHAPES])
def test_every_fnet_and_ragged_shape_takes_the_vector_body(shape, dtype):
    assert norm.vector_body(_like(shape, dtype))


# the scalar body: C not a multiple of 8 bf16 or 4 fp32 channels (one 16-byte
# vector), or x not 16-byte aligned
@pytest.mark.parametrize("c,dtype,offset,vec", [
    (36, torch.bfloat16, 0, False), (36, torch.float32, 0, True), (4, torch.bfloat16, 0, False),
    (4, torch.float32, 0, True), (6, torch.float32, 0, False), (530, torch.bfloat16, 0, False),
    (64, torch.bfloat16, 1, False), (64, torch.bfloat16, 8, True), (64, torch.float32, 2, False),
    (64, torch.float32, 4, True),
])
def test_scalar_body_rule(c, dtype, offset, vec):
    assert norm.vector_body(_like((2, 9, 11, c), dtype, offset)) == vec


def _x(shape, seed):
    return (np.random.default_rng(seed).normal(0, 1, shape) * 3 + 1.5).astype(np.float32)


# C = 36 (scalar body), M = 1, M = 527 (not a multiple of a block's rows and
# odd: no lane packing on the JAX side), M = 2600 (two ragged JAX row tiles)
NORM_SHAPES = [(2, 9, 13, 36), (2, 1, 1, 36), (1, 1, 1, 64), (1, 17, 31, 64), (1, 40, 65, 64)]


# fp32 sums over H*W in another order: rtol 1e-5 and atol 1e-5 on (mean, r)
# and on y of x ~ 3 N(0, 1) + 1.5. At M = 1 the variance is 0 in exact
# arithmetic: the port rounds E[x^2] and mean^2 alike and gets 0, so r =
# rsqrt(eps); XLA on the CPU takes E[x^2] - mean * mean with one rounding
# (a fused multiply-add), which leaves E[x^2]'s rounding error, at most
# 2^-24 x^2: its r lies between rsqrt(eps + 2^-24 x^2) and rsqrt(eps). y is
# 0 in both (x - mean = 0).
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=[str(s) for s in NORM_SHAPES])
def test_instance_norm_plain_matches_pallas_norm(shape, relu):
    x = _x(shape, 80)
    y = norm.instance_norm(torch.from_numpy(x), relu=relu)
    st = norm.instance_norm_stats(torch.from_numpy(x)).numpy()
    jy, jst = _norm_impl(jnp.asarray(x), 1e-5, relu, interpret=True)
    jst = np.asarray(jst)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    if shape[1] * shape[2] > 1:
        np.testing.assert_allclose(st, jst, rtol=1e-5, atol=1e-5)
        return
    x2 = x.reshape(shape[0], shape[3]).astype(np.float64) ** 2
    np.testing.assert_array_equal(st[:, 0], jst[:, 0])
    np.testing.assert_array_equal(st[:, 1], np.float32(1 / np.sqrt(np.float32(1e-5))))
    assert np.all(jst[:, 1] <= st[:, 1] * (1 + 1e-6))
    assert np.all(jst[:, 1] >= 1 / np.sqrt(1e-5 + 2.0 ** -24 * x2) * (1 - 1e-6))


# given the same statistics, the same arithmetic ((x - mean) * r in fp32,
# relu, a round-to-nearest cast): the same bits in fp32 and bf16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=[str(s) for s in NORM_SHAPES])
def test_instance_norm_apply_plain_gives_the_pallas_bits(shape, relu, dtype):
    x = torch.from_numpy(_x(shape, 81)).to(dtype)
    st = norm.instance_norm_stats_plain(x)
    y = norm.instance_norm_apply(x, st, relu)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jy = japply(jx, jnp.asarray(st.numpy()), relu=relu, interpret=True)
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(jy.astype(jnp.float32)))


# the conv + instance-norm pair (K2 then K4 on the card, their plain versions
# here) against the JAX pair's XLA composition on the CPU (fp32 conv sums of
# 9 C terms in another order: rtol 1e-5, atol 1e-5), and bit for bit the
# plain conv's statistics applied by the plain K4
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 11, 36, 36), (1, 9, 16, 64, 64)], ids=str)
def test_conv_pair_output_unchanged(shape, relu):
    b, h, w, c, co = shape
    rng = np.random.default_rng(82)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, c, co)).astype(np.float32)
    bias = rng.normal(0, 0.1, (co,)).astype(np.float32)
    tx, tk, tb = torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias)
    y = conv3x3.conv3x3_instnorm_relu(tx, tk, tb, relu=relu)
    yc, st = conv3x3.conv3x3_stats_plain(tx, tk, tb)
    assert torch.equal(y, norm.instance_norm_apply_plain(yc, st, relu))
    jy = jconv_pair(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), relu)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
