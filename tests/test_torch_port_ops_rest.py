"""The JAX package's ops that no model path reaches, ported
(flow_supervisor_tpu_torch/ops/corr.py, coords.py, resampler.py), against
the JAX ops on seeded numpy inputs (fp32, the CPU):

- ``build_corr_pyramid`` (the full volume pooled by 2, 4, 8, TF 'SAME' and
  count-aware, ragged 7x11 targets) and ``transpose_corr_volume``: within
  1e-6 (pooling sums in another order), the transpose exactly; the pooled
  volume equals the port's pyramid from pooled feature maps within 1e-5;
- ``combine_pyramid``: exactly; ``_masked_support``: exactly, far-out
  positions included; ``corr_pyramid_lookup_combined`` over it, at coords
  in bounds, partly out and far out: within 1e-5 of JAX's, and of the
  port's per-level ``corr_pyramid_lookup`` on the same pyramid;
- ``initialize_coords``: exactly; ``resample_flow_lookup``: within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.ops import coords as jcoords
from flow_supervisor_tpu.ops import corr as jcorr
from flow_supervisor_tpu.ops import resample_flow_lookup as jax_resample_flow_lookup
from flow_supervisor_tpu_torch.ops import coords, corr, resampler

B, H1, W1, H2, W2, C = 2, 5, 6, 7, 11, 16
RADIUS = 2


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


@pytest.fixture(scope="module")
def volume():
    rng = np.random.default_rng(0)
    f1 = rng.normal(0, 1, (B, H1, W1, C)).astype(np.float32)
    f2 = rng.normal(0, 1, (B, H2, W2, C)).astype(np.float32)
    vol = np.array(jcorr.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2)))
    return f1, f2, vol


def _coords(kind: str, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.arange(W1), np.arange(H1)), -1)[None].astype(np.float32)
    scale = {"in_bounds": 1.5, "partly_out": 6.0, "far_out": 1e4}[kind]
    return (grid + rng.normal(0, scale, (B, H1, W1, 2))).astype(np.float32)


def test_build_corr_pyramid_matches_jax(volume):
    f1, f2, vol = volume
    want = jcorr.build_corr_pyramid(jnp.asarray(vol), 4)
    got = corr.build_corr_pyramid(torch.from_numpy(vol), 4)
    from_fmaps = corr.build_corr_pyramid_from_fmaps(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert [g.shape[3:] for g in got] == [(7, 11), (4, 6), (2, 3), (1, 2)]
    for g, w, f in zip(got, want, from_fmaps):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(g), _np(f), rtol=0, atol=1e-5)


def test_transpose_corr_volume_matches_jax(volume):
    vol = volume[2]
    got = corr.transpose_corr_volume(torch.from_numpy(vol))
    np.testing.assert_array_equal(_np(got), np.asarray(jcorr.transpose_corr_volume(vol)))
    assert got.shape == (B, H2, W2, H1, W1)


def test_combine_pyramid_matches_jax(volume):
    vol = volume[2]
    want = jcorr.combine_pyramid(jcorr.build_corr_pyramid(jnp.asarray(vol), 4))
    got = corr.combine_pyramid(corr.build_corr_pyramid(torch.from_numpy(vol), 4))
    assert got.shape == want.shape == (B, H1, W1, H2, 11 + 6 + 3 + 2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("offset", [0, 5])
def test_masked_support_matches_jax(offset):
    rng = np.random.default_rng(2)
    pos = np.concatenate([rng.uniform(-4, 12, (B, 20)), [[-1e6] * 2 + [1e6] * 18] * B], 1)
    pos = pos.astype(np.float32)
    want = jcorr._masked_support(jnp.asarray(pos), 2 * RADIUS + 2, 9, offset, RADIUS, 20)
    got = corr._masked_support(torch.from_numpy(pos), 2 * RADIUS + 2, 9, offset, RADIUS, 20)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["in_bounds", "partly_out", "far_out"])
def test_corr_pyramid_lookup_combined_matches_jax(volume, kind):
    vol = volume[2]
    c = _coords(kind)
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(vol), 4)
    pyr = corr.build_corr_pyramid(torch.from_numpy(vol), 4)
    shapes = [tuple(v.shape[3:]) for v in pyr]
    want = jcorr.corr_pyramid_lookup_combined(jcorr.combine_pyramid(jpyr), shapes,
                                              jnp.asarray(c), RADIUS)
    got = corr.corr_pyramid_lookup_combined(corr.combine_pyramid(pyr), shapes,
                                            torch.from_numpy(c), RADIUS)
    per_level = corr.corr_pyramid_lookup(pyr, torch.from_numpy(c), RADIUS)
    assert got.shape == (B, H1, W1, 4 * (2 * RADIUS + 1) ** 2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(per_level), rtol=0, atol=1e-5)
    if kind == "far_out":
        assert not got.any()


def test_initialize_coords_matches_jax():
    got = coords.initialize_coords(2, 45, 70)
    want = jcoords.initialize_coords(2, 45, 70)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 6, 9, 2)
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_resample_flow_lookup_matches_jax():
    rng = np.random.default_rng(3)
    src = rng.normal(0, 1, (B, 9, 13, 3)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(13), np.arange(9)), -1)[None].astype(np.float32)
    c = (grid + rng.normal(0, 3, (B, 9, 13, 2))).astype(np.float32)
    want = jax_resample_flow_lookup(jnp.asarray(src), jnp.asarray(c))
    got = resampler.resample_flow_lookup(torch.from_numpy(src), torch.from_numpy(c))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)
