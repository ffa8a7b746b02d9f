"""The port's training ops, losses, metrics, schedules and optimizer against
the JAX package, on CPU, fp32, on the same numpy inputs.

Tolerances: crops, pads and the crop upsample are copies or the same fp32
arithmetic (atol 1e-6); losses and metrics rtol 1e-6; schedules rtol 1e-6
(fp32 powers); the optimizer's parameters after three steps to fp32
rounding (rtol 1e-6, atol 1e-9: the same operations in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.config import TrainCfg as JTrainCfg
from flow_supervisor_tpu.losses import sequence_loss as jsequence_loss
from flow_supervisor_tpu.metrics import epe_per_image as jepe_per_image
from flow_supervisor_tpu.models.raft import _crop_upsample as j_crop_upsample
from flow_supervisor_tpu.ops import pad as jpad
from flow_supervisor_tpu.ops import upsample as jup
from flow_supervisor_tpu.training import optim as joptim
from flow_supervisor_tpu.training.schedules import build_schedules as jbuild_schedules
from flow_supervisor_tpu_torch.config import TrainCfg
from flow_supervisor_tpu_torch.losses.supervised import sequence_loss
from flow_supervisor_tpu_torch.metrics import epe_per_image
from flow_supervisor_tpu_torch.models.raft import _crop_upsample
from flow_supervisor_tpu_torch.ops import pad, upsample
from flow_supervisor_tpu_torch.training import checkpoint, optim
from flow_supervisor_tpu_torch.training.schedules import build_schedules

# (y, x) offsets per sample: inside, at the far edge, and past it (clamped)
OFFSETS = np.asarray([[8, 16], [16, 16], [40, -8]], np.int32)


def _close(got: torch.Tensor, want, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def test_crop_and_pad_bboxes():
    rng = np.random.default_rng(0)
    full = rng.normal(0, 1, (3, 48, 64, 5)).astype(np.float32)
    got = pad.crop_bboxes(torch.from_numpy(full), torch.from_numpy(OFFSETS), (32, 48))
    _close(got, jpad.crop_bboxes(jnp.asarray(full), jnp.asarray(OFFSETS), (32, 48)), atol=0)
    small = rng.normal(0, 1, (3, 4, 6, 5)).astype(np.float32)
    off8 = OFFSETS // 8
    got = pad.pad_bboxes(torch.from_numpy(small), torch.from_numpy(off8), (6, 8))
    _close(got, jpad.pad_bboxes(jnp.asarray(small), jnp.asarray(off8), (6, 8)), atol=0)


def test_pad_bboxes_is_differentiable():
    x = torch.ones(1, 2, 3, 1, requires_grad=True)
    pad.pad_bboxes(x, torch.tensor([[1, 2]]), (5, 6)).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_upsample_convex_pre_padded():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 8, 12, 2)).astype(np.float32)
    m = rng.normal(0, 2, (2, 6, 10, 576)).astype(np.float32)
    got = upsample.upsample_convex(torch.from_numpy(x), torch.from_numpy(m), (45, 80), pre_padded=True)
    want = jup.upsample_convex(jnp.asarray(x), jnp.asarray(m), (45, 80), pre_padded=True)
    assert got.shape == want.shape
    _close(got, want)


def test_crop_upsample_matches_jax_and_full_frame_crop():
    rng = np.random.default_rng(2)
    flow = rng.normal(0, 2, (3, 6, 8, 2)).astype(np.float32)
    mask = rng.normal(0, 2, (3, 6, 8, 576)).astype(np.float32)
    off8 = OFFSETS // 8
    got = _crop_upsample(torch.from_numpy(flow), torch.from_numpy(mask), torch.from_numpy(off8),
                         (4, 6), (32, 48))
    want = j_crop_upsample(jnp.asarray(flow), jnp.asarray(mask), jnp.asarray(off8), (4, 6), (32, 48))
    _close(got, want)
    full = upsample.upsample_convex(torch.from_numpy(flow), torch.from_numpy(mask))
    _close(got[:2], pad.crop_bboxes(full, torch.from_numpy(OFFSETS), (32, 48))[:2])


@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("loss", ["l1", "l2", "robust"])
def test_sequence_loss(loss, with_valid):
    rng = np.random.default_rng(3)
    preds = rng.normal(0, 3, (3, 2, 9, 13, 2)).astype(np.float32)
    gt = rng.normal(0, 3, (2, 9, 13, 2)).astype(np.float32)
    gt[0, :2, :4] = [300.0, 300.0]  # |gt| >= 400: out of the loss
    gt[1, 3, 5] = [0.0, 399.0]  # just inside
    valid = (rng.uniform(0, 1, (2, 9, 13, 1)) > 0.3).astype(np.float32) if with_valid else None
    got = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                        None if valid is None else torch.from_numpy(valid), 0.8, loss)
    want = jsequence_loss(jnp.asarray(preds), jnp.asarray(gt),
                          None if valid is None else jnp.asarray(valid), 0.8, loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("with_valid", [True, False])
def test_epe_per_image(with_valid):
    rng = np.random.default_rng(4)
    pred = rng.normal(0, 3, (3, 9, 13, 2)).astype(np.float32)
    gt = rng.normal(0, 3, (3, 9, 13, 2)).astype(np.float32)
    valid = (rng.uniform(0, 1, (3, 9, 13, 1)) > 0.3).astype(np.float32)
    valid[2] = 0.0  # an image with an empty mask reports -1
    v = valid if with_valid else None
    got = epe_per_image(torch.from_numpy(pred), torch.from_numpy(gt),
                        None if v is None else torch.from_numpy(v))
    want = jepe_per_image(jnp.asarray(pred), jnp.asarray(gt), None if v is None else jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if with_valid:
        assert float(got[2]) == -1.0


@pytest.mark.parametrize("kind", ["onecycle", "exponential", "smurf", "constant"])
def test_schedules(kind):
    kw = dict(lr=4e-4, lr_schedule=kind, lr_decay_steps=300, lr_decay_rate=0.5,
              weight_decay=1e-4, num_steps=1000)
    lr, wd = build_schedules(TrainCfg(**kw))
    jlr, jwd = jbuild_schedules(JTrainCfg(**kw))
    for step in (0, 1, 40, 55, 299, 300, 799, 800, 950, 1000, 1099, 1100, 1500):
        np.testing.assert_allclose(float(lr(step)), float(jlr(step)), rtol=1e-6, err_msg=f"lr {step}")
        np.testing.assert_allclose(float(wd(step)), float(jwd(step)), rtol=1e-6, err_msg=f"wd {step}")


def test_optimizer_three_steps_match_jax_adamw():
    """Per-variable clipnorm (one variable far above norm 1, one below),
    gradients with elements near eps scale, scheduled decay, and a frozen
    batch-norm scale and bias that must not move."""
    rng = np.random.default_rng(5)
    shapes = {"conv.kernel": (3, 3, 4, 8), "conv.bias": (8,), "head.kernel": (5, 6),
              "norm.scale": (8,), "norm.bias": (8,)}
    params = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    jtree = lambda d: {"conv": {"Conv_0": {"kernel": d["conv.kernel"], "bias": d["conv.bias"]}},  # noqa: E731
                       "head": {"kernel": d["head.kernel"]},
                       "norm": {"BatchNorm_0": {"scale": d["norm.scale"], "bias": d["norm.bias"]}}}
    lr_fn, wd_fn = build_schedules(TrainCfg(lr=1e-3, lr_schedule="onecycle", num_steps=10,
                                            weight_decay=1e-2))
    jlr_fn, jwd_fn = jbuild_schedules(JTrainCfg(lr=1e-3, lr_schedule="onecycle", num_steps=10,
                                                weight_decay=1e-2))
    tx = optim.AdamW(lr_fn, wd_fn, clip_norm=1.0, frozen=frozenset({"norm.scale", "norm.bias"}))
    jtx = joptim.adamw(jlr_fn, jwd_fn, clip_norm=1.0, freeze_bn=True)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(tparams)
    jparams = jax.tree_util.tree_map(jnp.asarray, jtree(params))
    jstate = jtx.init(jparams)
    for step in range(3):
        grads = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
        grads["conv.kernel"] *= 10.0  # clipped to norm 1
        grads["conv.bias"] *= 1e-2  # below the clip
        g = grads["head.kernel"]
        g[0] = rng.normal(0, 3e-7, g.shape[1])  # near eps / sqrt(1 - b2)
        g[1] = 0.0
        updates, state = tx.update({k: torch.from_numpy(v) for k, v in grads.items()}, state,
                                   tparams)
        for k, u in updates.items():
            tparams[k] = tparams[k] + u
        jupd, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, jtree(grads)), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupd)
    flat = {k: np.asarray(v) for k, v in zip(
        shapes, [jparams["conv"]["Conv_0"]["kernel"], jparams["conv"]["Conv_0"]["bias"],
                 jparams["head"]["kernel"], jparams["norm"]["BatchNorm_0"]["scale"],
                 jparams["norm"]["BatchNorm_0"]["bias"]])}
    for k, v in flat.items():
        np.testing.assert_allclose(tparams[k].numpy(), v, rtol=1e-6, atol=1e-9, err_msg=k)
    for k in ("norm.scale", "norm.bias"):
        np.testing.assert_array_equal(tparams[k].numpy(), params[k])
    assert sorted(state.mu) == ["conv.bias", "conv.kernel", "head.kernel"]  # frozen: no moments
    assert state.count == 3


def test_teacher_and_baseline_transplants():
    sd = {"fnet.w": torch.ones(2), "update_block.a.weight": torch.full((2,), 2.0),
          "teacher_update_block.a.weight": torch.zeros(2), "cnet.norm1.running_mean": torch.ones(1)}
    base = {"fnet.w": torch.full((2,), 5.0), "update_block.a.weight": torch.full((2,), 7.0),
            "cnet.norm1.running_mean": torch.full((1,), 3.0), "other.x": torch.ones(1)}
    new = checkpoint.initialize_teacher_net(checkpoint.initialize_from_baseline(sd, base))
    assert sorted(new) == sorted(sd)
    assert torch.equal(new["fnet.w"], base["fnet.w"])
    assert torch.equal(new["cnet.norm1.running_mean"], base["cnet.norm1.running_mean"])
    assert torch.equal(new["teacher_update_block.a.weight"], base["update_block.a.weight"])
    new["teacher_update_block.a.weight"].add_(1.0)  # a copy, not an alias
    assert torch.equal(new["update_block.a.weight"], base["update_block.a.weight"])
