"""Shared set-up of the one-step JAX-vs-port train tests
(tests/test_torch_train_{baseline,unsup,smurf}.py), and the test that the
weight bridge carries an unfrozen model's batch-norm statistics both ways.

The port's RAFT is built from a seed with random batch-norm statistics and
affine parameters; ``convert_torch_raft`` carries its weights to the JAX
RAFT (einsum lookup: the fused lookup's function, and no Pallas interpret
mode in a whole-step test), and ``from_flax`` carries the JAX step's
gradients and parameters back. Batches are seeded numpy: 32x48 crops of
48x64 frames.

Tolerances, as tests/test_torch_train_semi.py sets them: logs to rtol 1e-5
(fp32 sums in another order); each gradient to 1e-4 of its variable's
largest element; the bias of every fnet conv that an instance norm follows,
and with unfrozen batch norm of every cnet conv that a batch norm follows,
has a zero gradient in exact arithmetic (the normalization subtracts the
mean it shifts), fp32 noise in both packages, held below 1e-5 of its
weight's gradient; updates within 0.2 lr of JAX's and 99.9
% of them within 1e-3 lr (Adam's first step moves an element by at most lr,
and turns the last digits of gradients near eps scale into O(lr) moves).
"""
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flow_supervisor_tpu.convert import convert_torch_raft
from chip_smoke import noise_bias
from flow_supervisor_tpu.training.state import TrainState as JTrainState
from flow_supervisor_tpu_torch.convert import from_flax
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

# A setting for the whole test process, on purpose: the suite runs in several
# worker processes on the CPU, each of which imports every test module at
# collection, so every test of a worker runs on one torch thread. That keeps
# the workers from oversubscribing the cores (torch's default of a thread per
# core made the step tests several times slower under six workers on eight
# cores). A file run on its own without this module keeps torch's default.
torch.set_num_threads(1)

H, W, FH, FW = 32, 48, 48, 64
ITERS = 2


class GradsState(JTrainState):
    """The JAX TrainState, keeping the gradients it was last stepped with
    (the Baseline and Unsup steps have no debug output for them)."""

    grads: Any = None

    def apply_gradients(self, grads):
        return super().apply_gradients(grads).replace(grads=grads)


def port_model(teacher: bool, freeze_bn: bool, seed: int = 0) -> RAFT:
    """The port's fp32 RAFT (fused lookup), with non-trivial batch-norm
    statistics and affine parameters."""
    model = RAFT(RAFTConfig(iters=ITERS, teacher=teacher, teacher_iters=ITERS,
                            freeze_bn=freeze_bn, lookup_backend="fused"),
                 generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            for t in (m.running_mean, m.running_var, m.weight, m.bias):
                t.data.uniform_(0.5, 1.5, generator=gen)
    return model


def jax_variables(model: RAFT):
    """(params, batch_stats) of the JAX RAFT for the port model's weights
    (copies: the port's step updates its parameters in place)."""
    sd = {("grad_" + k[len("teacher_"):] if k.startswith("teacher_update_block.") else k):
          v.clone() for k, v in model.state_dict().items()}
    params, stats = convert_torch_raft(sd, teacher=model.cfg.teacher)
    return (jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, stats))


def crop_batch(rng, b: int = 1, crops=((8, 16), (16, 0))):
    """{image1, image2, orig_image1, orig_image2, crop_yx}: two related random
    frames [b, 48, 64, 3] and their 32x48 crops at crops[:b]."""
    full1 = rng.uniform(0, 1, (b, FH, FW, 3)).astype(np.float32)
    full2 = np.roll(full1, (1, -2), axis=(1, 2)) * 0.9 + 0.1 * rng.uniform(0, 1, full1.shape)
    full2 = full2.astype(np.float32)
    crop = np.asarray(crops[:b], np.int32)
    return {"image1": np.stack([full1[i, y : y + H, x : x + W] for i, (y, x) in enumerate(crop)]),
            "image2": np.stack([full2[i, y : y + H, x : x + W] for i, (y, x) in enumerate(crop)]),
            "orig_image1": full1, "orig_image2": full2, "crop_yx": crop}


def labels(rng, b: int = 1):
    """{flow, valid} for [b, 32, 48]: flow with a few |gt| >= 400 pixels
    (masked out of the loss), valid with about 20 % zeros."""
    flow = rng.normal(0, 3, (b, H, W, 2)).astype(np.float32)
    flow[:, :2, :3] = 500.0
    return {"flow": flow, "valid": (rng.uniform(0, 1, (b, H, W, 1)) > 0.2).astype(np.float32)}


def random_variables(jmodel, seed: int = 0, gamma: float = 0.5, hw=(H, W), full=(FH, FW)):
    """Seeded numpy variables of the JAX model ``jmodel`` in the tree its
    init gives (traced with ``jax.eval_shape``, not run: an eager init of a
    whole model costs about 35 s on the CPU), by ``fill_variables``; the
    model is initialized through ``semi_forward`` when it has a teacher head."""
    key = jax.random.PRNGKey(0)
    img, fimg = jnp.zeros((1, *hw, 3)), jnp.zeros((1, *full, 3))
    if jmodel.cfg.teacher:
        shapes = jax.eval_shape(lambda: jmodel.init(
            key, img, img, fimg, fimg, jnp.zeros((1, 2), jnp.int32), method="semi_forward"))
    else:
        shapes = jax.eval_shape(lambda: jmodel.init(key, img, img))
    return fill_variables(shapes, seed, gamma)


def fill_variables(shapes, seed: int = 0, gamma: float = 0.5) -> dict:
    """Seeded numpy values for a flax variables tree of shapes: encoder
    (``fnet`` / ``cnet``) kernels He-uniform, the other kernels U(+-1 /
    sqrt(fan_in)), biases U(+-0.1), batch- and group-norm scales, biases and
    statistics in [0.5, 1.5], GMA's position tables N(0, 1) and every
    aggregator's ``gamma`` at ``gamma`` (not its initial zero, which cuts q,
    k and v out of the forward and its gradient)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        shape, last = leaf.shape, names[-1]
        if names[0] == "batch_stats" or any(n in ("BatchNorm_0", "GroupNorm_0") for n in names):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if last == "gamma":
            return np.full(shape, gamma, np.float32)
        if last in ("rel_height", "rel_width"):
            return rng.normal(0.0, 1.0, shape).astype(np.float32)
        if last == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            encoder = len(names) > 1 and names[1] in ("fnet", "cnet")
            lim = (6.0 / fan_in) ** 0.5 if encoder else fan_in ** -0.5
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def jnp_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_port(tree, stats) -> dict[str, torch.Tensor]:
    """A JAX params-shaped tree (gradients or parameters) in the port's names."""
    return from_flax(jax.tree_util.tree_map(np.asarray, tree), jax.tree_util.tree_map(
        np.asarray, stats))


def check_logs(log: dict, jlog: dict, keys, total: str | None = None) -> None:
    """Each log entry to rtol 1e-5; with ``total``, a term may instead lie
    within 1e-5 of that entry (the whole loss): a term that is a vanishing
    share of it, such as self-supervision at random weights (exp of -30:
    fp32's relative error in the exponent becomes ~3e-5 in the value), is held
    at the scale it contributes."""
    assert sorted(log) == sorted(jlog) == sorted(keys), (sorted(log), sorted(jlog))
    atol = 0.0 if total is None else 1e-5 * abs(float(jlog[total]))
    for k, v in jlog.items():
        assert np.isfinite(float(v)), k
        np.testing.assert_allclose(float(log[k]), float(v), rtol=1e-5, atol=atol, err_msg=k)


def check_grads(grads: dict, jgrads: dict, names, bn_train: bool = False,
                limit: float = 1e-4) -> None:
    """Each gradient within ``limit`` of its variable's largest element."""
    assert sorted(grads) == sorted(names)
    for name, g in grads.items():
        want = jgrads[name].numpy()
        if noise_bias(name, bn_train):
            ref = np.abs(jgrads[name[: -len("bias")] + "weight"].numpy()).max()
            assert max(np.abs(want).max(), np.abs(g.numpy()).max()) <= 1e-5 * ref, name
            continue
        err = np.abs(g.numpy() - want).max()
        assert err <= limit * np.abs(want).max() + 1e-12, (name, err, np.abs(want).max())


def check_updates(params: dict, before: dict, jparams: dict, frozen, lr: float, wd: float,
                  bn_train: bool = False, max_lr: float = 0.2, share_lr: float = 1e-3,
                  share: float = 0.999) -> None:
    """Updates: none for frozen variables; each within lr + wd |p| (and the
    rounding of p + u); within max_lr * lr of JAX's, a ``share`` of them
    (99.9 %) within share_lr * lr."""
    moved = []
    for name, p in params.items():
        d = (p.detach() - before[name]).numpy()
        jd = jparams[name].numpy() - before[name].numpy()
        if name in frozen:
            assert not d.any() and not jd.any(), name
            continue
        p0 = np.abs(before[name].numpy()).max()
        assert np.abs(d).max() <= lr + wd * p0 + 2 * np.spacing(p0), name
        if noise_bias(name, bn_train):
            continue
        err = np.abs(d - jd)
        assert err.max() <= max_lr * lr, (name, err.max())
        moved.append(err.ravel())
    err = np.concatenate(moved)
    assert np.mean(err <= share_lr * lr) >= share, np.mean(err <= share_lr * lr)


def test_weight_bridge_round_trips_unfrozen_batch_norm():
    """An unfrozen model needs nothing new of the bridge: its state dict goes
    to the JAX trees and back unchanged, batch-norm statistics included."""
    model = port_model(teacher=False, freeze_bn=False, seed=3)
    params, stats = jax_variables(model)
    back = to_port(params, stats)
    sd = model.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k
