"""The ported RAFT inference forward vs the JAX package's RAFT, on CPU.

JAX RAFT (einsum lookup, scanned iterations) is initialized once; its
parameters (with random batch-norm statistics) are carried to the port by
``from_flax``. Both run the same seeded inputs at 64x96, 3 iterations, fp32;
the port must match to max |d flow_up| < 2e-3 px, the golden bound of
docs/PARITY.md, with and without ``flow_init`` and ``final_flow_only``, and
under each of the port's lookup backends (plane, fused at B=1 and B=2,
pallas, einsum, and auto, which is einsum on the CPU) against the same JAX
einsum model: every backend computes the same windows, so only fp32
summation order differs. The zero ablation is held against the JAX model
with the zero backend.
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
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig, resolve_lookup_backend

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


def test_teacher_head_is_built_and_trains_through_plane():
    model = RAFT(RAFTConfig(iters=1, teacher=True, teacher_iters=1))
    assert sorted(k for k in model.state_dict() if k.startswith("teacher_update_block.")) == sorted(
        "teacher_" + k for k in model.state_dict() if k.startswith("update_block."))
    img = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    # plane, the default lookup here, trains through K12's backward
    out = model.semi_forward(img, img.flip(1), img, img.flip(1), torch.zeros(1, 2, dtype=torch.long))
    loss = out["teacher_fw"].square().mean() + out["student_bw"].square().mean()
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()),
                                                allow_unused=True)))
    assert grads["teacher_update_block.flow_head.conv2.weight"].abs().max() > 0
    assert grads["fnet.conv2.weight"].abs().max() > 0  # through the planes' backward
    with pytest.raises(ValueError, match="teacher=True"):
        RAFT(RAFTConfig(iters=1)).semi_forward(img, img, img, img, torch.zeros(1, 2))


@pytest.fixture(scope="module")
def backend_models(jax_model):
    _, params, stats = jax_model
    state = from_flax(params, stats)
    models = {}
    for backend in ("plane", "fused", "pallas", "einsum", "zero", "auto"):
        models[backend] = RAFT(RAFTConfig(iters=ITERS, lookup_backend=backend))
        models[backend].load_state_dict(state)
    return models


@pytest.mark.parametrize(
    "backend,batch",
    [("plane", 1), ("fused", 1), ("fused", 2), ("pallas", 1), ("einsum", 1), ("einsum", 2),
     ("zero", 1), ("auto", 1)],
    ids=["plane", "fused_b1_k6", "fused_b2_k7", "pallas", "einsum", "einsum_b2", "zero",
         "auto_cpu_einsum"],
)
def test_forward_per_lookup_backend_matches_jax(jax_model, backend_models, pair, backend, batch):
    img1, img2, _ = pair
    if batch == 2:  # a second, different pair: the reversed one, flipped left-right
        img1, img2 = (np.concatenate([a, b[:, :, ::-1]]) for a, b in ((img1, img2), (img2, img1)))
    if backend == "zero":
        zero = JRAFT(JRAFTConfig(lookup_backend="zero", scan_iters=True, iters=ITERS).resolved())
        want = _jax_apply((zero,) + jax_model[1:], img1, img2)
    else:
        want = _jax_apply(jax_model, img1, img2)
    got = backend_models[backend](torch.from_numpy(img1.copy()), torch.from_numpy(img2.copy()))
    assert tuple(got["flow_up"].shape) == want["flow_up"].shape == (ITERS, batch, H, W, 2)
    assert np.abs(got["flow_up"].numpy() - want["flow_up"]).max() < BOUND
    assert np.abs(got["flow_low"].numpy() - want["flow_low"]).max() < BOUND


def test_auto_backend_rule_takes_fused_on_cuda_and_einsum_elsewhere():
    """The port's rule (JAX's takes einsum everywhere but a TPU)."""
    assert resolve_lookup_backend("auto", torch.device("cpu")) == "einsum"
    assert resolve_lookup_backend("auto", "cpu") == "einsum"
    assert resolve_lookup_backend("auto", torch.device("cuda")) == "fused"
    assert resolve_lookup_backend("auto", "cuda:0") == "fused"
    for backend in ("plane", "fused", "pallas", "einsum", "zero"):
        assert resolve_lookup_backend(backend, "cuda") == backend


def test_default_experiment_config_builds():
    """ModelCfg's default lookup backend is auto, which RAFT now takes."""
    from flow_supervisor_tpu_torch.config import ExperimentConfig
    from flow_supervisor_tpu_torch.training.loop import build_model

    model = build_model(ExperimentConfig())
    assert model.cfg.lookup_backend == "auto"


@pytest.mark.parametrize("backend", ["einsum", "zero", "auto"])
def test_einsum_zero_and_auto_lookups_train(backend):
    """einsum and zero (and auto, einsum here) have a backward, as in JAX."""
    model = RAFT(RAFTConfig(iters=2, lookup_backend=backend), generator=torch.Generator().manual_seed(0))
    img = torch.rand(1, 32, 48, 3, generator=torch.Generator().manual_seed(1))
    out = model.train_forward(img, img.flip(2))
    out["flow_up"].square().mean().backward()
    upd = [p.grad for p in model.update_block.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in upd)
    assert any(g.abs().max() > 0 for g in upd)
    fnet = [p.grad for p in model.fnet.parameters()]
    if backend == "zero":  # the ablation's windows carry nothing back to fnet
        assert all(g is None or not g.any() for g in fnet)
    else:
        assert all(g is not None and torch.isfinite(g).all() for g in fnet)
        assert any(g.abs().max() > 0 for g in fnet)


def test_unknown_lookup_backend_is_refused():
    with pytest.raises(ValueError, match="plane"):
        RAFT(RAFTConfig(lookup_backend="planes"))
