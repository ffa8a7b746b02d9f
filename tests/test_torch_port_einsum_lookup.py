"""The port's einsum lookup (ops/corr.py ``corr_pyramid_lookup``, the
one-hot matrix-product window of the ``einsum`` backend) against the JAX
package's ``corr_pyramid_lookup`` on the same volume pyramid, on the CPU.

Coords lie in bounds, partly out (windows over the edge) and far out (to
3e38), at radius 4 and 3, over fp32 and bf16 volumes (the one-hot products
pick volume values exactly in either dtype; the combine is fp32). Limit:
1e-5, fp32 summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.ops import corr as jcorr
from flow_supervisor_tpu_torch.ops.corr import (
    build_corr_pyramid_from_fmaps, corr_pyramid_lookup, corr_pyramid_lookup_gather,
)

B, H8, W8, C, LEVELS = 2, 6, 11, 32, 4
LIMIT = 1e-5


def _coords(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "in":
        lo, hi = (0.0, 0.0), (W8 - 1.0, H8 - 1.0)
    else:
        lo, hi = (-6.0, -6.0), (W8 + 6.0, H8 + 6.0)
    c = np.stack([rng.uniform(lo[0], hi[0], (B, H8, W8)), rng.uniform(lo[1], hi[1], (B, H8, W8))], -1)
    if kind == "far":
        c[0, 0, 0] = (1e9, -1e9)
        c[0, 1, 2] = (-3e38, 3e38)
        c[1, 5, 10] = (5e5, 2.5)
        c[1, 2, 3] = (-2.5, -4e6)
    return c.astype(np.float32)


@pytest.fixture(scope="module")
def fmaps():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1, (B, H8, W8, C)).astype(np.float32),
            rng.normal(0, 1, (B, H8, W8, C)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius", [4, 3])
@pytest.mark.parametrize("kind", ["in", "partly_out", "far"])
def test_einsum_lookup_matches_jax(fmaps, dtype, radius, kind):
    f1, f2 = (torch.from_numpy(f) for f in fmaps)
    pyramid = build_corr_pyramid_from_fmaps(f1, f2, LEVELS, getattr(torch, dtype))
    coords = _coords(kind, seed=radius)
    got = corr_pyramid_lookup(pyramid, torch.from_numpy(coords), radius)
    jpyr = [jnp.asarray(v.float().numpy()).astype(getattr(jnp, dtype)) for v in pyramid]
    want = np.asarray(jcorr.corr_pyramid_lookup(jpyr, jnp.asarray(coords), radius=radius))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (B, H8, W8, LEVELS * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LIMIT)
    if kind == "far":  # windows wholly outside every level read zeros
        assert not got[0, 0, 0].any() and not got[0, 1, 2].any()


@pytest.mark.parametrize("radius", [4, 3])
def test_einsum_lookup_matches_the_gather_oracle(fmaps, radius):
    f1, f2 = (torch.from_numpy(f) for f in fmaps)
    pyramid = build_corr_pyramid_from_fmaps(f1, f2, LEVELS)
    coords = torch.from_numpy(_coords("partly_out", seed=7))
    torch.testing.assert_close(corr_pyramid_lookup(pyramid, coords, radius),
                               corr_pyramid_lookup_gather(pyramid, coords, radius),
                               rtol=0, atol=LIMIT)
