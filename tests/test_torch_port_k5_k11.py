"""The port's K5 (``conv3x3_fused``) and K11 (``corr_pyramid_lookup_pallas``)
against the JAX package's Pallas kernels, on the CPU, where the port's
wrappers run their plain PyTorch versions and the JAX kernels run in
interpret mode, as its own tests run them, at 8x8-scale shapes.

fp32; forwards to atol 2e-5 / 1e-5 (only summation order differs), K5's
gradients (the JAX package's custom VJP, PyTorch's conv backward here) to
1e-5 of each gradient's largest element. tests/test_torch_port_cuda.py holds
the CUDA kernels against these plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.kernels.conv3x3 import _conv_reference, conv3x3_fused as jconv3x3_fused
from flow_supervisor_tpu.kernels.corr_lookup import (
    corr_pyramid_lookup_pallas as jlookup_pallas,
    lookup_level_pallas as jlookup_level,
)
from flow_supervisor_tpu.ops.corr import build_corr_pyramid_from_fmaps as jbuild, corr_pyramid_lookup
from flow_supervisor_tpu_torch.kernels import conv3x3, corr_lookup
from flow_supervisor_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps, corr_pyramid_lookup_gather


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(1, 8, 8, 16, 16), (2, 8, 16, 8, 24)])
def test_k5_plain_matches_jax_kernel_and_vjp(shape, relu):
    b, h, w, c, co = shape
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    k = rng.normal(0, 0.3, (3, 3, c, co)).astype(np.float32)
    bias = rng.normal(0, 0.3, (co,)).astype(np.float32)
    g = rng.normal(0, 1, (b, h, w, co)).astype(np.float32)
    jy, vjp = jax.vjp(lambda *a: jconv3x3_fused(*a, relu), *map(jnp.asarray, (x, k, bias)))
    ref = _conv_reference(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    ref = np.asarray(jnp.maximum(ref, 0.0) if relu else ref)
    tx, tk, tb = (torch.tensor(a, requires_grad=True) for a in (x, k, bias))
    ty = conv3x3.conv3x3_fused(tx, tk, tb, relu)
    assert conv3x3.bare_launches == 0
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=2e-5)
    np.testing.assert_allclose(ty.detach().numpy(), ref, atol=2e-5)
    if relu:
        assert float(ty.detach().min()) == 0.0
    for name, want, got in zip(("x", "k", "b"), vjp(jnp.asarray(g)),
                               torch.autograd.grad(ty, (tx, tk, tb), torch.from_numpy(g))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)


def _volumes(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jpyr = jbuild(jnp.asarray(f1), jnp.asarray(f2), 4)
    pyr = build_corr_pyramid_from_fmaps(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    return rng, jpyr, pyr


def test_k11_plain_matches_jax_kernel_and_oracle():
    rng, jpyr, pyr = _volumes(1, 8, 8, 16, 0)
    coords = rng.uniform(-4.0, 12.0, (1, 8, 8, 2)).astype(np.float32)
    want = np.asarray(jlookup_pallas(jpyr, jnp.asarray(coords), radius=4, interpret=True))
    oracle = np.asarray(corr_pyramid_lookup(jpyr, jnp.asarray(coords), radius=4))
    got = corr_lookup.corr_pyramid_lookup_pallas(pyr, torch.from_numpy(coords), 4)
    assert corr_lookup.launches == 0
    assert got.dtype == torch.float32 and got.shape == (1, 8, 8, 4 * 81)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)
    gather = corr_pyramid_lookup_gather(pyr, torch.from_numpy(coords), 4)
    np.testing.assert_allclose(got.numpy(), gather.numpy(), rtol=1e-5, atol=1e-5)


def test_k11_plain_one_level_far_out_of_bounds_and_bf16():
    rng, jpyr, pyr = _volumes(2, 4, 8, 8, 1)
    coords = np.stack([rng.uniform(-12, 20, (2, 4, 8)), rng.uniform(-12, 16, (2, 4, 8))], -1)
    coords[0, 0, :6] = [[-100.0, -100.0], [500.0, 500.0], [3.5, 2.5], [-100.0, 3.0],
                        [7.9, 3.9], [200.0, -200.0]]
    coords = coords.astype(np.float32)
    want = np.asarray(jlookup_level(jpyr[0], jnp.asarray(coords), radius=2, tq=8, interpret=True))
    got = corr_lookup.lookup_level_pallas(pyr[0], torch.from_numpy(coords), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0, 0, 0].numpy(), 0.0)
    # +-3e38 clamp in float before any integer conversion: an all-zero window
    far = torch.from_numpy(coords).clone()
    far[1, 1, :4] = torch.tensor([[3e38, 1.0], [-3e38, 2.0], [1.5, 3e38], [2.5, -3e38]])
    out = corr_lookup.lookup_level_pallas(pyr[0], far, 2)
    np.testing.assert_array_equal(out[1, 1, :4].numpy(), 0.0)
    # a bf16 volume is read as fp32 and the output stays fp32
    vol16 = pyr[0].to(torch.bfloat16)
    got16 = corr_lookup.lookup_level_pallas(vol16, torch.from_numpy(coords), 2)
    want16 = corr_lookup.lookup_level_pallas(vol16.float(), torch.from_numpy(coords), 2)
    assert got16.dtype == torch.float32
    np.testing.assert_array_equal(got16.numpy(), want16.numpy())
