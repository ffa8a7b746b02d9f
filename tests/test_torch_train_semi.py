"""One flow-supervisor (semi) train step of the port against one step of the
JAX package, on CPU, fp32, on the same weights and batches.

The port's RAFT (fused lookup: K6 forward, K8/K9 backward, here their plain
versions) is initialised from a seed with random batch-norm statistics and a
teacher head of its own; ``convert_torch_raft`` carries the weights to the
JAX RAFT (einsum lookup: the same function, and no Pallas interpret mode in a
whole-step test). Both take one step of the Sintel recipe's settings (robust
losses, lfl_loss_decay_rate 1.0, no teacher SMURF loss, lr 1e-5 exponential,
weight decay 0, clipnorm 1, frozen batch norm, pixel-sum L_fr, both
directions) on a 32x48 crop of 48x64 frames, 2 student and 2 teacher
iterations. The JAX step runs once, in a module fixture.

Tolerances: the losses and epe to rtol 1e-5 (fp32 sums in another order);
each merged gradient to 1e-4 of its variable's largest element (the unsup
branch's gradients are ~B*H*W = 1536x the sup branch's, and clipnorm then
rescales each variable). The bias of every fnet conv that an instance norm
follows has a gradient that is zero in exact arithmetic: in both packages it
is fp32 noise, below 1e-5 of its weight's gradient, and is checked as such.
The parameters after the step, by their update: Adam's first step moves an
element by lr * g / (|g| + eps / sqrt(1 - b2)), which for |g| near 3e-7
turns the gradients' last digits into O(lr) moves. So the noise biases may
move by anything up to lr in either package, every other update lies within
0.2 lr of JAX's, and 99.9 % of them within 1e-3 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.config import ModelCfg as JModelCfg, TrainCfg as JTrainCfg
from flow_supervisor_tpu.convert import convert_torch_raft
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.training.optim import make_optimizer as jmake_optimizer
from flow_supervisor_tpu.training.semi import make_semi_train_step as jmake_semi_train_step
from flow_supervisor_tpu.training.state import TrainState as JTrainState
from flow_supervisor_tpu_torch.config import ModelCfg, TrainCfg
from flow_supervisor_tpu_torch.convert import from_flax
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
from flow_supervisor_tpu_torch.training.semi import make_semi_train_step
from flow_supervisor_tpu_torch.training.state import TrainState

H, W, FH, FW = 32, 48, 48, 64
ITERS = 2
LR = 1e-5
MODEL_KW = dict(iters=ITERS, teacher_iters=ITERS, lfr_loss_type="robust", lfl_loss_decay_rate=1.0)
TRAIN_KW = dict(lr=LR, lr_schedule="exponential", lr_decay_steps=25000, weight_decay=0.0,
                clip_norm=1.0)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for crop in ((8, 16), (16, 0)):
        full1 = rng.uniform(0, 1, (1, FH, FW, 3)).astype(np.float32)
        full2 = np.roll(full1, (1, -2), axis=(1, 2)) * 0.9 + 0.1 * rng.uniform(0, 1, full1.shape)
        full2 = full2.astype(np.float32)
        y, x = crop
        b = {"image1": full1[:, y : y + H, x : x + W].copy(),
             "image2": full2[:, y : y + H, x : x + W].copy(),
             "orig_image1": full1, "orig_image2": full2,
             "crop_yx": np.asarray([crop], np.int32)}
        out.append(b)
    sup, unsup = out
    flow = rng.normal(0, 3, (1, H, W, 2)).astype(np.float32)
    flow[0, :2, :3] = 500.0  # |gt| >= 400: masked out of the loss
    sup["flow"] = flow
    sup["valid"] = (rng.uniform(0, 1, (1, H, W, 1)) > 0.2).astype(np.float32)
    return sup, unsup


@pytest.fixture(scope="module")
def steps():
    torch.manual_seed(0)
    model = RAFT(RAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS, freeze_bn=True,
                            lookup_backend="fused"), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for m in model.modules():  # non-trivial frozen batch-norm statistics and affine
        if isinstance(m, torch.nn.BatchNorm2d):
            for t in (m.running_mean, m.running_var, m.weight, m.bias):
                t.data.uniform_(0.5, 1.5, generator=gen)
    # copies: the port's step updates its parameters in place
    sd = {("grad_" + k[len("teacher_"):] if k.startswith("teacher_update_block.") else k): v.clone()
          for k, v in model.state_dict().items()}
    params, stats = convert_torch_raft(sd, teacher=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    sup, unsup = _batches()

    jmodel = JRAFT(JRAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS, freeze_bn=True,
                               lookup_backend="einsum").resolved())
    jstate = JTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, stats),
        jmake_optimizer(JTrainCfg(**TRAIN_KW), freeze_bn=True),
    )
    jstep = jmake_semi_train_step(jmodel, JModelCfg(**MODEL_KW), gamma=0.8,
                                  sup_loss_type="robust", donate=False, debug_grads=True)
    jnew, jlog = jstep(jstate, {k: jnp.asarray(v) for k, v in sup.items()},
                       {k: jnp.asarray(v) for k, v in unsup.items()})
    jgrads = from_flax(jax.tree_util.tree_map(np.asarray, jlog.pop("_merged_grads")), stats)
    jparams = from_flax(jax.tree_util.tree_map(np.asarray, jnew.params), stats)
    jlog = {k: float(v) for k, v in jlog.items()}

    tx = make_optimizer(TrainCfg(**TRAIN_KW), batchnorm_params(model))
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_semi_train_step(model, ModelCfg(**MODEL_KW), gamma=0.8, sup_loss_type="robust",
                                debug_grads=True)
    to_t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
    state, log = step(state, to_t(sup), to_t(unsup))
    grads = log.pop("_grads")
    return {"jlog": jlog, "jgrads": jgrads, "jparams": jparams, "log": log, "grads": grads,
            "state": state, "before": before, "params": params, "stats": stats,
            "frozen": batchnorm_params(model)}


def test_semi_step_logs_match_jax(steps):
    jlog, log = steps["jlog"], steps["log"]
    assert sorted(log) == sorted(jlog) == sorted(
        ["sup_label_loss", "lfl_loss", "sup_loss", "epe", "lfr_loss", "unsup_loss"])
    for k, v in jlog.items():
        assert np.isfinite(v)
        np.testing.assert_allclose(float(log[k]), v, rtol=1e-5, err_msg=k)


def _noise_bias(name: str) -> bool:
    """An fnet conv bias that an instance norm follows (all but the last conv)."""
    return name.startswith("fnet.") and name.endswith(".bias") and name != "fnet.conv2.bias"


def test_semi_step_merged_grads_match_jax(steps):
    grads, jgrads = steps["grads"], steps["jgrads"]
    assert sorted(grads) == sorted(k for k in steps["before"])
    for name, g in grads.items():
        want = jgrads[name].numpy()
        if _noise_bias(name):
            ref = np.abs(jgrads[name[: -len("bias")] + "weight"].numpy()).max()
            assert max(np.abs(want).max(), np.abs(g.numpy()).max()) <= 1e-5 * ref, name
            continue
        scale = np.abs(want).max()
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * scale + 1e-12, (name, err, scale)
    # both branches reach the student; the teacher head gets L_fl's gradient only
    assert np.abs(jgrads["teacher_update_block.flow_head.conv2.weight"].numpy()).max() > 0


def test_semi_step_params_after_step_match_jax(steps):
    state, before, jparams = steps["state"], steps["before"], steps["jparams"]
    assert state.step == 1
    moved = []
    for name, p in state.params.items():
        d = (p.detach() - before[name]).numpy()
        jd = jparams[name].numpy() - before[name].numpy()
        if name in steps["frozen"]:  # frozen batch norm: no update at all
            assert not d.any() and not jd.any(), name
            continue
        # at most lr, and the rounding of p + u
        assert np.abs(d).max() <= LR + 2 * np.spacing(np.abs(before[name].numpy()).max())
        if _noise_bias(name):
            continue
        err = np.abs(d - jd)
        assert err.max() <= 0.2 * LR, (name, err.max())
        moved.append(err.ravel())
    err = np.concatenate(moved)
    assert np.mean(err <= 1e-3 * LR) >= 0.999, np.mean(err <= 1e-3 * LR)


def test_from_flax_maps_the_teacher_head(steps):
    sd = from_flax(steps["params"], steps["stats"])
    for name, p in steps["before"].items():
        assert torch.equal(sd[name], p), name
