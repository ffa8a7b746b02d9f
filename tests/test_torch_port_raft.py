"""The ported RAFT inference forward vs the JAX package's RAFT, on CPU.

JAX RAFT (einsum lookup, scanned iterations) is initialized once; its
parameters (with random batch-norm statistics) are carried to the port by
``from_flax``. Both run the same seeded inputs at 64x96, 3 iterations, fp32;
the port must match to max |d flow_up| < 2e-3 px, the golden bound of
docs/PARITY.md, with and without ``flow_init`` and ``final_flow_only``, and
under each of the port's lookup backends (plane, fused at B=1 and B=2,
pallas) against the same JAX einsum model: every backend computes the same
windows, so only fp32 summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.convert import convert_torch_raft
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu_torch.convert import from_flax, load_flax_npz
from flow_supervisor_tpu_torch.evaluation import run_pair
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

H, W, ITERS = 64, 96, 3
BOUND = 2e-3  # px


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, -3), axis=(1, 2)) * 0.9 + 0.05 * rng.uniform(0, 1, img1.shape)
    flow_init = rng.normal(0, 2, (1, H // 8, W // 8, 2)).astype(np.float32)
    return img1, img2.astype(np.float32), flow_init


@pytest.fixture(scope="module")
def jax_model(pair):
    img1, img2, _ = pair
    model = JRAFT(JRAFTConfig(lookup_backend="einsum", scan_iters=True, iters=ITERS).resolved())
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(img1), jnp.asarray(img2))
    rng = np.random.default_rng(1)
    # non-trivial batch-norm statistics, so the bridge and cnet's BN are exercised
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.uniform(0.5, 1.5, a.shape), np.float32), v["batch_stats"]
    )
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return model, params, stats


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, params, stats = jax_model
    model = RAFT(RAFTConfig(iters=ITERS))
    model.load_state_dict(from_flax(params, stats))
    return model


def _jax_apply(jax_model, img1, img2, **kw):
    model, params, stats = jax_model
    variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
    out = model.apply(variables, jnp.asarray(img1), jnp.asarray(img2), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def test_weight_bridge_round_trips_exactly(jax_model, port_model):
    _, params, stats = jax_model
    back_p, back_s = convert_torch_raft(port_model.state_dict())
    same = jax.tree_util.tree_map(np.array_equal, back_p, params)
    assert all(jax.tree_util.tree_leaves(same))
    same = jax.tree_util.tree_map(np.array_equal, back_s, stats)
    assert all(jax.tree_util.tree_leaves(same))


def test_flax_npz_loads_into_the_port(jax_model, port_model, tmp_path):
    from flax.traverse_util import flatten_dict

    _, params, stats = jax_model
    path = str(tmp_path / "raft.npz")
    np.savez(path, **flatten_dict({"params": params, "batch_stats": stats}, sep="/"))
    model = RAFT(RAFTConfig(iters=ITERS))
    model.load_state_dict(from_flax(*load_flax_npz(path)))
    for k, v in port_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize(
    "with_init,final_only",
    [(False, False), (False, True), (True, True)],
    ids=["all_iters", "final_flow_only", "flow_init"],
)
def test_forward_matches_jax(jax_model, port_model, pair, with_init, final_only):
    img1, img2, flow_init = pair
    init = flow_init if with_init else None
    want = _jax_apply(
        jax_model, img1, img2, flow_init=None if init is None else jnp.asarray(init),
        final_flow_only=final_only,
    )
    got = port_model(
        torch.from_numpy(img1), torch.from_numpy(img2),
        flow_init=None if init is None else torch.from_numpy(init),
        final_flow_only=final_only,
    )
    assert tuple(got["flow_up"].shape) == want["flow_up"].shape
    assert tuple(got["flow_low"].shape) == want["flow_low"].shape == (ITERS, 1, H // 8, W // 8, 2)
    assert np.abs(got["flow_up"].numpy() - want["flow_up"]).max() < BOUND
    assert np.abs(got["flow_low"].numpy() - want["flow_low"]).max() < BOUND


def test_run_pair_pads_runs_and_unpads(port_model, pair):
    img1, img2, _ = pair
    crop1, crop2 = img1[0, :60, :90], img2[0, :60, :90]  # pads to 64 x 96
    flow, low = run_pair(port_model, crop1, crop2, "sintel", iters=ITERS)
    assert flow.shape == (60, 90, 2) and low.shape == (8, 12, 2)
    x1 = np.pad(crop1, ((2, 2), (3, 3), (0, 0)), mode="edge")[None]
    x2 = np.pad(crop2, ((2, 2), (3, 3), (0, 0)), mode="edge")[None]
    full = port_model(torch.from_numpy(x1), torch.from_numpy(x2), final_flow_only=True)
    np.testing.assert_array_equal(flow, full["flow_up"][-1, 0, 2:62, 3:93].numpy())


@pytest.mark.parametrize(
    "field,value",
    [("small", True), ("gma", True), ("convex_upsampling", False)],
)
def test_unported_variants_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RAFT(RAFTConfig(**{field: value}))


def test_teacher_head_is_built_and_trains_only_through_fused():
    model = RAFT(RAFTConfig(iters=1, teacher=True, teacher_iters=1))
    assert sorted(k for k in model.state_dict() if k.startswith("teacher_update_block.")) == sorted(
        "teacher_" + k for k in model.state_dict() if k.startswith("update_block."))
    img = torch.zeros(1, 16, 16, 3)
    with pytest.raises(NotImplementedError, match="fused"):  # plane has no backward yet
        model.semi_forward(img, img, img, img, torch.zeros(1, 2, dtype=torch.long))
    with pytest.raises(ValueError, match="teacher=True"):
        RAFT(RAFTConfig(iters=1)).semi_forward(img, img, img, img, torch.zeros(1, 2))


@pytest.fixture(scope="module")
def backend_models(jax_model):
    _, params, stats = jax_model
    state = from_flax(params, stats)
    models = {}
    for backend in ("plane", "fused", "pallas"):
        models[backend] = RAFT(RAFTConfig(iters=ITERS, lookup_backend=backend))
        models[backend].load_state_dict(state)
    return models


@pytest.mark.parametrize(
    "backend,batch", [("plane", 1), ("fused", 1), ("fused", 2), ("pallas", 1)],
    ids=["plane", "fused_b1_k6", "fused_b2_k7", "pallas"],
)
def test_forward_per_lookup_backend_matches_jax(jax_model, backend_models, pair, backend, batch):
    img1, img2, _ = pair
    if batch == 2:  # a second, different pair: the reversed one, flipped left-right
        img1, img2 = (np.concatenate([a, b[:, :, ::-1]]) for a, b in ((img1, img2), (img2, img1)))
    want = _jax_apply(jax_model, img1, img2)
    got = backend_models[backend](torch.from_numpy(img1.copy()), torch.from_numpy(img2.copy()))
    assert tuple(got["flow_up"].shape) == want["flow_up"].shape == (ITERS, batch, H, W, 2)
    assert np.abs(got["flow_up"].numpy() - want["flow_up"]).max() < BOUND
    assert np.abs(got["flow_low"].numpy() - want["flow_low"]).max() < BOUND


@pytest.mark.parametrize("backend", ["auto", "einsum", "zero"])
def test_unported_lookup_backends_raise(backend):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RAFT(RAFTConfig(lookup_backend=backend))


def test_unknown_lookup_backend_is_refused():
    with pytest.raises(ValueError, match="plane"):
        RAFT(RAFTConfig(lookup_backend="planes"))
