"""The backward passes of the port's kernel modules against the JAX package,
on CPU, fp32: the fused lookup's (K8/K9, here their plain versions) against
the JAX package's Pallas K8/K9 in interpret mode (``_try_bwd_kernel``) and
against its default einsum VJP (``_lookup_bwd``), and the conv3x3 +
instance-norm pair's and the instance norm's autograd backward against
``jax.vjp`` of the JAX functions.

The lookup's backward is compared on the pooled factors, calling the JAX
package's backward functions directly (its forward would run the Pallas
lookup in interpret mode too). Tolerances: the lookup gradients to atol 2e-5
(fp32 sums of up to 4 * 100 terms per element in another order, values of
order 1); the norm and conv gradients to atol 1e-5 plus rtol 1e-4 (sums
over H*W in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.kernels import corr_fused as jcf
from flow_supervisor_tpu.kernels.conv3x3 import conv3x3_instnorm_relu as jconv_pair
from flow_supervisor_tpu.kernels.norm import instance_norm_fused as jinstance_norm
from flow_supervisor_tpu_torch.kernels import conv3x3, corr_fused, norm

R = 4


def _lookup_inputs(b, h8=8, w8=16, c=32, seed=0):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)
    coords = np.stack(
        [rng.uniform(-6, w8 + 6, (b, h8, w8)), rng.uniform(-6, h8 + 6, (b, h8, w8))], -1
    ).astype(np.float32)
    coords[0, 0, :4] = [(300.0, -200.0), (-250.0, 3.5), (4.25, 1e4), (w8 + 40.0, h8 + 40.0)]
    g = rng.normal(0, 1, (b, h8, w8, 4 * (2 * R + 1) ** 2)).astype(np.float32)
    return f1, f2, coords, g


def _port_bwd(f1, f2, coords, g):
    """The plain K8 / K9 (the wrappers on CPU tensors) on the pooled factors."""
    pyr = corr_fused.build_fused_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    flat = torch.from_numpy(coords).reshape(-1, 2)
    gf = torch.from_numpy(g).reshape(flat.shape[0], -1)
    d_f1 = corr_fused.bwd_df1(pyr.f1, pyr.f2s, flat, gf, R)
    d_f2s = corr_fused.bwd_df2(pyr.f1, pyr.f2s, flat, gf, R)
    return d_f1.numpy(), [d.numpy() for d in d_f2s]


def _jax_pooled(d_f2gs, shapes):
    """The JAX package's grouped d_f2 layout -> [B, h2, w2, C] per level."""
    return [np.asarray(jcf._ungroup_f2(d, h2, w2)).transpose(0, 1, 3, 2)
            for d, (h2, w2) in zip(d_f2gs, shapes)]


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    for a, b in zip(got[1], want[1]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)


def test_k8_k9_plain_match_pallas_backward_kernels():
    """B=1: the JAX package's volume-free backward ``_try_bwd_kernel`` (K8 and
    K9 in interpret mode) on the same factors; coords in bounds, windows
    partly out, and far out of bounds (the first four queries)."""
    f1, f2, coords, g = _lookup_inputs(b=1)
    got = _port_bwd(f1, f2, coords, g)
    pyr = jcf.build_fused_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, R)
    res = jcf._try_bwd_kernel(pyr.f1, pyr.f2gs, pyr.shapes, R, False, jnp.asarray(coords),
                              jnp.asarray(g))
    assert res is not None  # the kernels ran, not the einsum fallback
    _check(got, (np.asarray(res[0]), _jax_pooled(res[1], pyr.shapes)))
    assert not got[0][0, :4].any()  # far-out queries get no gradient
    assert np.abs(got[1][0]).max() > 0.1


def test_k8_k9_plain_match_einsum_vjp_at_b2():
    """B=2 (the port runs K8/K9 at any batch) against the JAX package's default
    closed-form einsum backward, ``_lookup_bwd``."""
    assert not jcf.BWD_KERNEL
    f1, f2, coords, g = _lookup_inputs(b=2, h8=5, w8=9, seed=1)
    got = _port_bwd(f1, f2, coords, g)
    pyr = jcf.build_fused_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, R)
    d_f1, d_f2gs, _ = jcf._lookup_bwd(pyr.shapes, pyr.h1w1, R, "float32", False, "float32",
                                      (pyr.f1, pyr.f2gs, jnp.asarray(coords)), jnp.asarray(g))
    _check(got, (np.asarray(d_f1), _jax_pooled(d_f2gs, pyr.shapes)))


def test_fused_lookup_autograd_runs_k8_k9_through_the_pooling():
    """The lookup's autograd backward is K8 (d_f1) and K9 (d_f2 per level),
    and reaches fmap2 through the pooled levels."""
    f1, f2, coords, g = _lookup_inputs(b=1, seed=2)
    t1 = torch.from_numpy(f1).requires_grad_()
    t2 = torch.from_numpy(f2).requires_grad_()
    pyr = corr_fused.build_fused_pyramid(t1, t2, 4)
    for f in pyr.f2s:
        f.retain_grad()
    out = corr_fused.corr_pyramid_lookup_fused(pyr, torch.from_numpy(coords), R)
    out.backward(torch.from_numpy(g))
    d_f1, d_f2s = _port_bwd(f1, f2, coords, g)
    np.testing.assert_array_equal(t1.grad.numpy().reshape(d_f1.shape), d_f1)
    for f, d in zip(pyr.f2s[1:], d_f2s[1:]):  # level 0 is fmap2 itself
        np.testing.assert_array_equal(f.grad.numpy(), d)
    # fmap2's gradient: level 0's own plus what the pooled levels pass back
    assert np.abs(t2.grad.numpy() - d_f2s[0]).max() > 1e-3


def test_fused_backward_takes_no_coords_gradient():
    f1, f2, coords, g = _lookup_inputs(b=1, seed=2)
    c = torch.from_numpy(coords).requires_grad_()
    pyr = corr_fused.build_fused_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    out = corr_fused.corr_pyramid_lookup_fused(pyr, c, R)
    assert not out.requires_grad  # coords are detached, as JAX's stop_gradient
    with pytest.raises(ValueError):
        corr_fused.bwd_df1(pyr.f1, pyr.f2s, c.detach().reshape(-1, 2), torch.zeros(3, 324), R)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(2, 9, 16, 32, 48), (1, 7, 10, 16, 16)])
def test_conv3x3_instnorm_relu_backward_matches_jax_vjp(shape, relu):
    b, h, w, c, co = shape
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, c, co)).astype(np.float32)
    bias = rng.normal(0, 0.1, (co,)).astype(np.float32)
    g = rng.normal(0, 1, (b, h, w, co)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, kk, bb: jconv_pair(a, kk, bb, relu),
                     jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    ts = [torch.from_numpy(v).requires_grad_() for v in (x, k, bias)]
    out = conv3x3.conv3x3_instnorm_relu(*ts, relu=relu)
    out.backward(torch.from_numpy(g))
    for t, wv, name in zip(ts, want, ("x", "w", "b")):
        np.testing.assert_allclose(t.grad.numpy(), wv, atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("relu", [True, False])
def test_instance_norm_backward_matches_jax_vjp(relu):
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 1, (2, 11, 13, 24)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jinstance_norm(a, 1e-5, relu), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    norm.instance_norm(t, relu=relu).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
