"""The port's space-parallel RAFT forward (parallel/spatial.py
``spatial_forward``) in a world of 4 gloo ranks on the CPU.

One pair of seeded noise images, 64x96 (H a multiple of 8 * 4, so each rank
holds 16 rows, 2 at 1/8 resolution: the 7x7 flow conv's 3-row halo reaches
past the next rank), 2 iterations, fp32, on the weights of a JAX RAFT
(``random_variables``, batch-norm statistics in [0.5, 1.5]) carried over by
``convert.from_flax``:

- the einsum lookup, sharded, against JAX's ``spatial_forward`` on a space
  mesh of 4 of the 8 virtual CPU devices of tests/conftest.py, and against
  JAX's one-device forward: the final flow within 2e-4 (JAX's own limit,
  tests/test_spatial_shard.py);
- every lookup backend sharded (einsum, and plane, fused and pallas, whose
  plain versions run here) against the port's one-process forward, the
  final and the low-resolution flow within 1e-5; each rank holds the same
  flow. The port keeps the model's backend under the shard, where JAX's
  spatial forward switches to einsum;
- a warm start: the flow_init of the whole frame, resized to 1/8 and split
  by rows, within 1e-5;
- a planted fault, coords0 without the shard's first row, must put the
  einsum forward beyond the limits;
- a height off the 8 * 4 grid is refused, naming H and 8 * space;
- each rank's all-reduces a forward: 44 + 10 an iteration.

The JAX side compiles its two forwards while the ranks run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.models import RAFT as JRAFT
from flow_supervisor_tpu.models import RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.parallel.spatial import make_space_mesh
from flow_supervisor_tpu.parallel.spatial import spatial_forward as jax_spatial_forward
from flow_supervisor_tpu_torch.convert import from_flax
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from test_torch_space_world import finish_world, start_world
from test_torch_train_jaxstep import random_variables

SPACE = 4
H, W = 8 * SPACE * 2, 96
ITERS = 2
JAX_LIMIT = 2e-4
PORT_LIMIT = 1e-5
BACKENDS = ("einsum", "plane", "fused", "pallas")


def _images():
    rng = np.random.default_rng(0)
    i1 = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    i2 = (np.roll(i1, (2, -3), axis=(1, 2)) * 0.9 + 0.05 * rng.uniform(0, 1, i1.shape))
    init = rng.normal(0, 2, (1, H, W, 2)).astype(np.float32)
    return i1, i2.astype(np.float32), init


@pytest.fixture(scope="module")
def runs():
    jmodel = JRAFT(JRAFTConfig(iters=ITERS, lookup_backend="einsum").resolved())
    variables = random_variables(jmodel, seed=3, hw=(H, W))
    state = from_flax(variables["params"], variables["batch_stats"])
    i1, i2, init = _images()
    t1, t2, tinit = (torch.from_numpy(a) for a in (i1, i2, init))

    def case(backend, **kw):
        return {"cfg": {"iters": ITERS, "lookup_backend": backend}, "state": state,
                "image1": t1, "image2": t2, **kw}

    cases = [case(b) for b in BACKENDS] + [
        case("einsum", flow_init=tinit), case("einsum", fault="coords_offset"),
        case("einsum", image1=t1[:, :48], image2=t2[:, :48])]
    world = start_world(SPACE, "forwards", {"cases": cases})
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    j1, j2 = jnp.asarray(i1), jnp.asarray(i2)
    jax_sharded = np.asarray(jax_spatial_forward(jmodel, make_space_mesh(SPACE))(jv, j1, j2))
    jax_one = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False, final_flow_only=True)["flow_up"][-1])(jv, j1, j2))
    ranks = finish_world(world)
    port = {}
    for c in cases[:len(BACKENDS) + 1]:
        model = RAFT(RAFTConfig(**c["cfg"]))
        model.load_state_dict(state)
        out = model(t1, t2, flow_init=c.get("flow_init"), final_flow_only=True)
        port[(c["cfg"]["lookup_backend"], "flow_init" in c)] = (out["flow_up"][-1],
                                                                 out["flow_low"][-1])
    return {"jax_sharded": jax_sharded, "jax_one": jax_one, "port": port, "ranks": ranks}


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("jax_side", ["jax_sharded", "jax_one"])
def test_sharded_einsum_forward_matches_jax(runs, jax_side):
    want = runs[jax_side]
    errs = [_err(r[0][0], want) for r in runs["ranks"]]
    print(jax_side, errs)
    assert runs["ranks"][0][0][0].shape == want.shape == (1, H, W, 2)
    assert max(errs) < JAX_LIMIT


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_forward_matches_one_process_per_backend(runs, backend):
    i = BACKENDS.index(backend)
    up, low = runs["port"][(backend, False)]
    got = [r[i] for r in runs["ranks"]]
    print(backend, [(_err(u, up), _err(lo, low)) for u, lo, _ in got])
    for u, lo, _ in got:
        assert u.shape == up.shape and lo.shape == low.shape == (1, H // 8, W // 8, 2)
        assert _err(u, up) < PORT_LIMIT and _err(lo, low) < PORT_LIMIT
        assert torch.equal(u, got[0][0]) and torch.equal(lo, got[0][1])


def test_sharded_warm_start_matches_one_process(runs):
    up, low = runs["port"][("einsum", True)]
    for r in runs["ranks"]:
        u, lo, _ = r[len(BACKENDS)]
        assert _err(u, up) < PORT_LIMIT and _err(lo, low) < PORT_LIMIT
    # the warm start moved the flow, so the comparison sees flow_init's rows
    assert _err(up, runs["port"][("einsum", False)][0]) > 1e-2


def test_a_missing_coords_offset_fails_the_comparison(runs):
    up, _ = runs["port"][("einsum", False)]
    errs = [_err(r[len(BACKENDS) + 1][0], up) for r in runs["ranks"]]
    print("coords0 without the shard's first row:", errs)
    assert min(errs) > 100 * PORT_LIMIT and min(errs) > JAX_LIMIT


def test_a_height_off_the_grid_is_refused(runs):
    for r in runs["ranks"]:
        assert "H=48" in r[-1] and "8*space=32" in r[-1], r[-1]


def test_all_reduces_a_forward(runs):
    """Each rank's all-reduces a forward, every backend alike: 41 in the two
    encoders (fnet 28: a halo per conv taller than one row and a moment sum
    per instance norm; cnet 13 halos), 1 to gather fmap2, 10 a refinement
    iteration (the update block's convs taller than one row) and 3 for the
    final flow (the upsample's halo and gather, the low flow's gather): 165
    at 12 iterations, the count a rank's host time on the card divides by."""
    for i, backend in enumerate(BACKENDS):
        counts = [r[i][2] for r in runs["ranks"]]
        print(backend, counts)
        assert counts == [41 + 1 + 10 * ITERS + 3] * SPACE
