"""flow_supervisor_tpu_torch ops vs the JAX package's ops, fp32 on CPU.

Inputs come from a seeded numpy generator and go through both packages;
tolerance atol 1e-5 (fp32, only the summation order differs)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.data import io as jio
from flow_supervisor_tpu.ops import coords as jcoords
from flow_supervisor_tpu.ops import corr as jcorr
from flow_supervisor_tpu.ops import pad as jpad
from flow_supervisor_tpu.ops import upsample as jup
from flow_supervisor_tpu_torch import flo
from flow_supervisor_tpu_torch.ops import coords, corr, pad, upsample

ATOL = 1e-5


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def test_coords_grid_and_downsample_shape():
    _close(coords.coords_grid(2, 5, 7), jcoords.coords_grid(2, 5, 7))
    for s in (436, 440, 1024, 375, 27, 1, 9):
        assert coords.downsample_shape(s) == jcoords.downsample_shape(s)


@pytest.mark.parametrize("size", [(27, 64), (10, 13), (6, 8)])
def test_resize_flow_and_image(size):
    rng = np.random.default_rng(1)
    f = rng.normal(0, 3, (2, 9, 16, 2)).astype(np.float32)
    _close(coords.resize_flow(torch.from_numpy(f), size), jcoords.resize_flow(jnp.asarray(f), size))
    _close(
        coords.resize_flow(torch.from_numpy(f), size, scaling=False),
        jcoords.resize_flow(jnp.asarray(f), size, scaling=False),
    )
    im = rng.uniform(0, 1, (1, 9, 16, 3)).astype(np.float32)
    _close(coords.resize_image(torch.from_numpy(im), size), jcoords.resize_image(jnp.asarray(im), size))


def _fmaps(b=1, h=7, w=13, c=32, h2=None, w2=None, seed=0):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (b, h2 or h, w2 or w, c)).astype(np.float32)
    return f1, f2


def test_all_pairs_correlation():
    f1, f2 = _fmaps(b=2, h2=5, w2=6)
    got = corr.all_pairs_correlation(torch.from_numpy(f1), torch.from_numpy(f2))
    assert got.shape == (2, 7, 13, 5, 6)
    _close(got, jcorr.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2)))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_same_pool_partial_edge_windows(k):
    """Odd sizes (27 x 13): TF-SAME pads unevenly and edge windows divide by
    their valid taps only."""
    f, _ = _fmaps(b=2, h=27, w=13, c=8, seed=2)
    got = corr._avg_pool_fmap_same(torch.from_numpy(f), k)
    want = jcorr._avg_pool_fmap_same(jnp.asarray(f), k)
    assert got.shape == want.shape
    _close(got, want)


def test_pyramid_and_gather_lookup():
    f1, f2 = _fmaps(h=9, w=11, c=16, seed=3)
    pyr = corr.build_corr_pyramid_from_fmaps(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    jpyr = jcorr.build_corr_pyramid_from_fmaps(jnp.asarray(f1), jnp.asarray(f2), 4)
    for a, b in zip(pyr, jpyr):
        assert a.shape == b.shape
        _close(a, b)
    rng = np.random.default_rng(4)
    c = np.stack(
        [rng.uniform(-15, 26, (1, 9, 11)), rng.uniform(-15, 24, (1, 9, 11))], -1
    ).astype(np.float32)
    got = corr.corr_pyramid_lookup_gather(pyr, torch.from_numpy(c), 4)
    want = jcorr.corr_pyramid_lookup_gather(jpyr, jnp.asarray(c), 4)
    assert got.shape == (1, 9, 11, 4 * 81)
    _close(got, want)


@pytest.mark.parametrize("out_size", [None, (61, 90)])
def test_upsample_convex(out_size):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (2, 8, 12, 2)).astype(np.float32)
    m = rng.normal(0, 2, (2, 8, 12, 576)).astype(np.float32)
    got = upsample.upsample_convex(torch.from_numpy(x), torch.from_numpy(m), out_size)
    want = jup.upsample_convex(jnp.asarray(x), jnp.asarray(m), out_size)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw", [(436, 1024), (375, 1242), (64, 96)])
def test_pad_unpad(mode, hw):
    assert pad.pad_spec_for(*hw, mode) == jpad.pad_spec_for(*hw, mode)
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (1, hw[0] // 8, hw[1] // 8 + 3, 3)).astype(np.float32)
    got, spec = pad.pad_to_multiple(torch.from_numpy(x), mode)
    want, jspec = jpad.pad_to_multiple(jnp.asarray(x), mode)
    assert spec == jspec
    _close(got, want, atol=0)
    _close(pad.unpad(got, spec), x, atol=0)


def test_flo_files_match_the_jax_package(tmp_path):
    rng = np.random.default_rng(7)
    f = rng.normal(0, 5, (11, 17, 2)).astype(np.float32)
    ours, theirs = os.path.join(tmp_path, "a.flo"), os.path.join(tmp_path, "b.flo")
    flo.write_flo(ours, f)
    jio.write_flo(theirs, f)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(flo.read_flo(theirs), f)
