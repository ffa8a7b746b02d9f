"""The pallas backend's lookup (K10, ``corr_lookup_v2.corr_pyramid_lookup_v2``)
and the volume pyramid's (K11, ``corr_lookup.corr_pyramid_lookup_pallas``) on
the CPU, where their wrappers run the plain PyTorch versions, against the
JAX package at radius 3 and 4, B=2, on an 8x16 query grid and a ragged 7x13
one (odd pooled sizes), with coords up to 15 px and far (+-1e9, +-3e38) out
of bounds.

The JAX side is ``ops.corr.corr_pyramid_lookup``, the oracle the JAX
package's own tests hold its ``corr_pyramid_lookup_v2`` and its volume
lookup against (tests/test_pallas_lookup_v2.py, tests/test_pallas_lookup.py):
their Pallas kernels in interpret mode take 10-35 s a call even at 5x9.
tests/test_torch_port_kernels.py holds K10's support patches against the
interpret-mode kernel, and tests/test_torch_port_k5_k11.py K11's windows.
fp32, atol 1e-5. On the card, K1, K10 and K11 run one body
(csrc/window.cuh); here their three plain versions give the same bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.ops import corr as jcorr
from flow_supervisor_tpu_torch.kernels import corr_lookup, corr_lookup_v2, corr_plane
from flow_supervisor_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps
from flow_supervisor_tpu_torch.profile_forward import _category

ATOL = 1e-5
LEVELS = 4
FAR = [(1e9, -1e9), (-3e38, 3e38), (-1e9, 2.5), (3.5, 3e38)]


def _inputs(hw, seed, b=2, c=16):
    """f1, f2 [B, h, w, C] and coords [B, h, w, 2] (x, y), the first four
    far out of bounds."""
    rng = np.random.default_rng(seed)
    h, w = hw
    f1 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    coords = np.stack(
        [rng.uniform(-15, w + 15, (b, h, w)), rng.uniform(-15, h + 15, (b, h, w))], -1
    ).astype(np.float32)
    coords.reshape(-1, 2)[: len(FAR)] = FAR
    return f1, f2, coords


def _jax_lookup(f1, f2, coords, radius):
    vols = jcorr.build_corr_pyramid_from_fmaps(jnp.asarray(f1), jnp.asarray(f2), LEVELS)
    return np.asarray(jcorr.corr_pyramid_lookup(vols, jnp.asarray(coords), radius=radius))


def _planes(f1, f2):
    return corr_plane.build_plane_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), LEVELS)


def _volumes(f1, f2):
    return build_corr_pyramid_from_fmaps(torch.from_numpy(f1), torch.from_numpy(f2), LEVELS)


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("hw", [(8, 16), (7, 13)])
def test_pallas_lookup_matches_jax(radius, hw):
    f1, f2, coords = _inputs(hw, seed=40 + radius)
    n = corr_lookup_v2.launches
    got = corr_lookup_v2.corr_pyramid_lookup_v2(_planes(f1, f2), torch.from_numpy(coords), radius)
    assert corr_lookup_v2.launches == n
    want = _jax_lookup(f1, f2, coords, radius)
    assert got.shape == want.shape == (2, *hw, LEVELS * (2 * radius + 1) ** 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert torch.all(got.reshape(-1, got.shape[-1])[: len(FAR)] == 0)


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("hw", [(8, 16), (7, 13)])
def test_volume_lookup_matches_jax(radius, hw):
    f1, f2, coords = _inputs(hw, seed=50 + radius)
    vols, c = _volumes(f1, f2), torch.from_numpy(coords)
    n = corr_lookup.launches
    got = corr_lookup.corr_pyramid_lookup_pallas(vols, c, radius)
    want = _jax_lookup(f1, f2, coords, radius)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert torch.all(got.reshape(-1, got.shape[-1])[: len(FAR)] == 0)
    k2 = (2 * radius + 1) ** 2
    one = corr_lookup.lookup_level_pallas(vols[1], c / 2, radius)
    assert torch.equal(one, got[..., k2 : 2 * k2])
    assert corr_lookup.launches == n


@pytest.mark.parametrize("radius", [3, 4])
def test_k1_k10_k11_plain_versions_give_the_same_bits(radius):
    """One function, one body on the card: the three plain versions on the
    same correlations agree bit for bit (fp32)."""
    f1, f2, coords = _inputs((7, 13), seed=60 + radius)
    planes, c = _planes(f1, f2), torch.from_numpy(coords)
    k1 = corr_plane.corr_pyramid_lookup_plane(planes, c, radius)
    k10 = corr_lookup_v2.corr_pyramid_lookup_v2(planes, c, radius)
    k11 = corr_lookup.corr_pyramid_lookup_pallas(_volumes(f1, f2), c, radius)
    assert torch.equal(k10, k1) and torch.equal(k11, k1)


def test_window_wrappers_reject_a_radius_beyond_shared_memory():
    """A block's 8 warps hold levels x (2r+2) x (2r+3) fp32 each, within
    the 227 KB a block may take on the card: r = 20 fits at 4 levels, 21
    does not; at one level 41 fits, 42 does not. The CPU refuses what the
    card would."""
    f1, f2, coords = _inputs((5, 9), seed=70)
    planes, vols, c = _planes(f1, f2), _volumes(f1, f2), torch.from_numpy(coords)
    assert corr_plane.window_fits(LEVELS, 20) and not corr_plane.window_fits(LEVELS, 21)
    assert corr_plane.window_fits(1, 41) and not corr_plane.window_fits(1, 42)
    assert corr_lookup_v2.corr_pyramid_lookup_v2(planes, c, 20).shape[-1] == LEVELS * 41 ** 2
    assert corr_lookup.corr_pyramid_lookup_pallas(vols, c, 20).shape[-1] == LEVELS * 41 ** 2
    with pytest.raises(ValueError, match="shared memory"):
        corr_lookup_v2.corr_pyramid_lookup_v2(planes, c, 21)
    with pytest.raises(ValueError, match="shared memory"):
        corr_lookup.corr_pyramid_lookup_pallas(vols, c, 21)
    assert corr_lookup.lookup_level_pallas(vols[2], c / 4, 41).shape[-1] == 83 ** 2
    with pytest.raises(ValueError, match="shared memory"):
        corr_lookup.lookup_level_pallas(vols[2], c / 4, 42)


def test_window_wrappers_reject_more_levels_than_the_kernel_holds():
    f1, f2, coords = _inputs((5, 9), seed=71)
    planes, vols, c = _planes(f1, f2), _volumes(f1, f2), torch.from_numpy(coords)
    nine = corr_plane.MAX_LEVELS + 1
    with pytest.raises(ValueError, match="levels"):
        corr_lookup_v2.corr_pyramid_lookup_v2((planes * 3)[:nine], c, 4)
    with pytest.raises(ValueError, match="levels"):
        corr_lookup.corr_pyramid_lookup_pallas((vols * 3)[:nine], c, 4)
    with pytest.raises(ValueError, match="levels"):
        corr_lookup.corr_pyramid_lookup_pallas([], c, 4)


def test_volume_wrapper_rejects_levels_of_mixed_dtypes_or_grids():
    """One launch reads every level with one input type and one query grid."""
    f1, f2, coords = _inputs((5, 9), seed=72)
    vols, c = _volumes(f1, f2), torch.from_numpy(coords)
    with pytest.raises(ValueError, match="one dtype"):
        corr_lookup.corr_pyramid_lookup_pallas([vols[0], vols[1].to(torch.bfloat16)], c, 4)
    with pytest.raises(ValueError, match="one dtype"):
        corr_lookup.corr_pyramid_lookup_pallas([vols[0], vols[1][:1]], c, 4)


@pytest.mark.parametrize("tin,tout", [("__nv_bfloat16", "__nv_bfloat16"),
                                      ("__nv_bfloat16", "float"), ("float", "float")])
def test_profiler_books_the_shared_window_body_as_one_category(tin, tout):
    """K1, K10 and K11 are one kernel template: the profiler files each
    instance, demangled or mangled, under one category."""
    demangled = f"void (anonymous namespace)::window_kernel<{tin}, {tout}, 4, 0>(Levels, int)"
    mangled = "_ZN12_GLOBAL__N_113window_kernelIffLi4ELi0EEEvNS_6LevelsEiPKfPT0_ii"
    assert _category(demangled) == _category(mangled) == "K1 / K10 / K11 window lookup"
