"""The backward of the plane and pallas lookups (K12's plain version) against
the JAX package's custom VJPs, on the CPU.

- ``ops.corr.lookup_vjp_dvols`` against JAX's ``corr_fused.lookup_vjp_dvols``
  (d_vol per level): fp32 and bf16 cotangents (bf16: JAX's d_vol is the bf16
  rounding of the fp32 support cotangent), coords inside the map and at and
  beyond its border (half-pixel edges, windows wholly outside, far coords).
- d fmap1 / d fmap2 through the port's plane build and its plane (K1) and
  pallas (K10) lookups, against ``jax.grad`` through JAX's
  ``corr_pyramid_lookup_plane`` and ``corr_pyramid_lookup_v2`` (Pallas in
  interpret mode, jitted), each with both ``dy_major`` settings on the JAX
  side (the port's channels are dx-major, so g is permuted to match): fp32
  within 2e-4 absolute, as tests/test_corr_plane.py holds JAX's VJP to its
  oracle.
- bf16 (the plane lookup's bf16 output, the pallas lookup's bf16 planes):
  within 2e-2 of the largest gradient of the fp32 one, JAX's own limit
  (tests/test_corr_plane.py:113-131).
- The K12 wrapper on CPU tensors is its plain version; it refuses what the
  kernel does not take.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.kernels import corr_plane as jcp
from flow_supervisor_tpu.kernels.corr_fused import lookup_vjp_dvols as jax_dvols
from flow_supervisor_tpu.kernels.corr_lookup_v2 import (
    build_padded_pyramid,
    corr_pyramid_lookup_v2 as jax_v2,
)
from flow_supervisor_tpu_torch.kernels import corr_plane
from flow_supervisor_tpu_torch.kernels.corr_lookup_v2 import corr_pyramid_lookup_v2
from flow_supervisor_tpu_torch.ops.corr import lookup_vjp_dvols

R = 4
LEVELS = 2
H8, W8, C = 8, 16, 16
K2 = (2 * R + 1) ** 2


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(1, H8, W8, C).astype(np.float32)
    f2 = rng.randn(1, H8, W8, C).astype(np.float32)
    coords = np.stack([rng.uniform(-15, W8 + 15, (1, H8, W8)),
                       rng.uniform(-15, H8 + 15, (1, H8, W8))], -1).astype(np.float32)
    g = rng.randn(1, H8, W8, LEVELS * K2).astype(np.float32)
    return f1, f2, coords, g


def _border_coords():
    """Queries on and beyond the map's border at level 0 and 1: half-pixel
    edges, windows partly and wholly outside, and far coords."""
    xs = [-R - 1.5, -R - 0.5, -0.5, 0.0, 0.25, W8 - 1, W8 - 0.5, W8 + R - 0.5, W8 + R + 1.5, 1e9]
    ys = [-R - 1.5, -0.5, 0.0, H8 - 1, H8 - 0.25, H8 + R + 0.5, -3e38, 3.5]
    grid = np.array([(x, y) for x in xs for y in ys], np.float32)
    grid = np.concatenate([grid, np.zeros((H8 * W8 - len(grid), 2), np.float32) + 3.25])
    return grid.reshape(1, H8, W8, 2)


def _dx_major(g_jax, dy_major):
    """JAX's cotangent in the port's dx-major channel order."""
    if not dy_major:
        return g_jax
    k = 2 * R + 1
    b, h, w, _ = g_jax.shape
    return g_jax.reshape(b, h, w, LEVELS, k, k).swapaxes(-1, -2).reshape(b, h, w, -1)


@pytest.mark.parametrize("where", ["inside", "border"])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_lookup_vjp_dvols_matches_jax(where, g_dtype):
    _, _, coords, g = _inputs(1)
    if where == "border":
        coords = _border_coords()
    shapes = ((H8, W8), (H8 // 2, W8 // 2))
    jdt = jnp.bfloat16 if g_dtype == torch.bfloat16 else jnp.float32
    want = jax_dvols(jnp.asarray(g, jdt), jnp.asarray(coords), shapes, R, False)
    got = lookup_vjp_dvols(torch.from_numpy(g).to(g_dtype), torch.from_numpy(coords), shapes, R)
    for lvl, (gl, wl, (h2, w2)) in enumerate(zip(got, want, shapes)):
        wl = np.asarray(wl.astype(jnp.float32)).reshape(-1, h2, w2)
        assert gl.dtype == g_dtype and gl.shape == wl.shape
        # fp32: the same sums up to XLA's fused multiply-adds; bf16: the
        # rounding of those sums, within one bf16 ulp
        tol = dict(atol=1e-6, rtol=1e-6) if g_dtype == torch.float32 else dict(atol=1e-6,
                                                                               rtol=2 ** -8)
        np.testing.assert_allclose(gl.float().numpy(), wl, **tol, err_msg=f"level {lvl}")
        # zero outside each query's support taps, as JAX's
        assert np.array_equal(gl.float().numpy() == 0, wl == 0)


def _jax_grads(backend, dy_major, f1, f2, coords, g, out_dtype=jnp.float32):
    def loss(a, b):
        pyr = build_padded_pyramid(a, b, LEVELS, R)
        if backend == "plane":
            out = jcp.corr_pyramid_lookup_plane(pyr, jnp.asarray(coords), R, dy_major=dy_major,
                                                out_dtype=out_dtype)
        else:
            out = jax_v2(pyr, jnp.asarray(coords), R, dy_major=dy_major)
        return jnp.vdot(out.astype(jnp.float32), jnp.asarray(g))

    return [np.asarray(d) for d in jax.jit(jax.grad(loss, (0, 1)))(jnp.asarray(f1),
                                                                     jnp.asarray(f2))]


def _port_grads(backend, f1, f2, coords, g, dtype=torch.float32):
    """d <lookup, g> / d (f1, f2) through the port's plane build and lookup:
    the plane backend's output in ``dtype``, or the pallas backend over
    planes in ``dtype``."""
    a = torch.from_numpy(f1).requires_grad_()
    b = torch.from_numpy(f2).requires_grad_()
    c = torch.from_numpy(coords)
    if backend == "plane":
        planes = corr_plane.build_plane_pyramid(a, b, LEVELS)
        out = corr_plane.corr_pyramid_lookup_plane(planes, c, R, dtype)
    else:
        planes = corr_plane.build_plane_pyramid(a, b, LEVELS, dtype)
        out = corr_pyramid_lookup_v2(planes, c, R)
    loss = (out.float() * torch.from_numpy(g)).sum()
    return [t.numpy() for t in torch.autograd.grad(loss, (a, b))]


@pytest.mark.parametrize("dy_major", [False, True])
@pytest.mark.parametrize("backend", ["plane", "pallas"])
def test_fmap_grads_match_jax_custom_vjp(backend, dy_major):
    f1, f2, coords, g = _inputs(2)
    want = _jax_grads(backend, dy_major, f1, f2, coords, g)
    got = _port_grads(backend, f1, f2, coords, _dx_major(g, dy_major))
    for name, a, b in zip(("d_fmap1", "d_fmap2"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("backend", ["plane", "pallas"])
def test_bf16_grads_close_to_fp32(backend):
    """The plane lookup with a bf16 output (the bf16 cotangent makes a bf16
    d_plane, JAX's rule) and the pallas lookup over bf16 planes (fp32
    cotangent, bf16 d_plane): within 2e-2 of the largest fp32 gradient, and
    of JAX's bf16 plane gradient."""
    f1, f2, coords, g = _inputs(3)
    ref = _port_grads(backend, f1, f2, coords, g)
    got = _port_grads(backend, f1, f2, coords, g, torch.bfloat16)
    for a, b in zip(got, ref):
        assert np.abs(a - b).max() / np.abs(b).max() < 2e-2
    if backend == "plane":
        jax16 = _jax_grads("plane", False, f1, f2, coords, g, jnp.bfloat16)
        for a, b in zip(got, jax16):
            assert np.abs(a - b).max() / np.abs(b).max() < 2e-2


def test_k12_wrapper_is_its_plain_version_on_the_cpu_and_refuses():
    _, _, coords, g = _inputs(4)
    c = torch.from_numpy(coords).reshape(-1, 2)
    gt = torch.from_numpy(g).reshape(c.shape[0], -1)
    shapes = [(H8, W8), (H8 // 2, W8 // 2)]
    before = corr_plane.bwd_launches
    got = corr_plane.lookup_bwd(gt, c, shapes, R, torch.bfloat16)
    for a, b in zip(got, lookup_vjp_dvols(gt, c, shapes, R, torch.bfloat16)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert corr_plane.bwd_launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="must be contiguous"):
        corr_plane.lookup_bwd(gt[:, :K2], c, shapes, R)
    with pytest.raises(ValueError, match="does not fit"):
        corr_plane.lookup_bwd(torch.zeros(c.shape[0], 2 * (2 * 40 + 1) ** 2), c, shapes, 40)
    with pytest.raises(ValueError, match="levels"):
        corr_plane.lookup_bwd(gt, c, [], R)


def test_the_lookups_keep_nothing_plane_sized_for_the_backward():
    """Like JAX's residuals (coords and dtype tokens), the autograd graph of
    a lookup holds only coords: the planes reach it as inputs, not saved
    tensors."""
    f1, f2, coords, _ = _inputs(5)
    a = torch.from_numpy(f1).requires_grad_()
    planes = corr_plane.build_plane_pyramid(a, torch.from_numpy(f2), LEVELS)
    c = torch.from_numpy(coords)
    for out in (corr_plane.corr_pyramid_lookup_plane(planes, c, R),
                corr_pyramid_lookup_v2(planes, c, R)):
        node = out.grad_fn
        while node is not None and not hasattr(node, "saved_tensors"):
            node = node.next_functions[0][0]
        assert [tuple(t.shape) for t in node.saved_tensors] == [(H8 * W8, 2)]
