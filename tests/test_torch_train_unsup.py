"""One unsupervised (SMURF-style, raft-unsup) train step of the port against
one step of the JAX package, on the CPU, fp32, on the same weights and batch:
B=2, 32x48 crops of 48x64 frames at per-sample offsets, 2 iterations, the
default loss (census 1, smooth1 2.5, selfsup 0.3, wang occlusion, per-update
decay 0.8), unfrozen batch norm, so the teacher's pass (the same net on the
full frames, without gradient) updates the running statistics before the
student's. The JAX step runs once, in a module fixture. Tolerances and
set-up: tests/test_torch_train_jaxstep.py; running statistics to rtol 1e-5.

Gradients are held to 1e-3 of each variable's largest element, not 1e-4:
the census loss's gradient is ill-conditioned in fp32, so the summation
order alone moves it. ``test_unsup_step_rounding_spread`` measures it: the
same port step on the same weights with three torch threads instead of one
moves some variable's gradient by about 2e-4 of its largest, and from
weights scaled by 1 + 2^-24 N(0, 1) by 1.9e-4 to 2.6e-4 over three
perturbation seeds; the JAX step lies 2.4e-4 away (run with ``-s`` to print
them; the smoothness term alone moves by 1.4e-5). The limit keeps a margin
of 2x over all of them. Updates are held as chip_smoke.py holds its card-vs-CPU step
for the same reason: each within Adam's 2 lr of JAX's (an element whose
gradient is near eps scale turns such differences into moves of up to lr),
and 99.5 % within 1e-2 lr, where the perturbed port step keeps about
99.9 %."""
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.config import ModelCfg as JModelCfg, TrainCfg as JTrainCfg
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.training.optim import make_optimizer as jmake_optimizer
from flow_supervisor_tpu.training.unsup import make_unsup_train_step as jmake_unsup_train_step
from flow_supervisor_tpu_torch.config import ModelCfg, TrainCfg
from flow_supervisor_tpu_torch.training.optim import make_optimizer
from flow_supervisor_tpu_torch.training.state import TrainState
from flow_supervisor_tpu_torch.training.unsup import make_unsup_train_step
from test_torch_train_jaxstep import (
    ITERS, GradsState, check_grads, check_logs, check_updates, crop_batch, jax_variables,
    jnp_batch, noise_bias, port_model, to_port, torch_batch,
)

MODEL_KW = dict(model_type="raft-unsup", iters=ITERS)
TRAIN_KW = dict(lr=1e-4, lr_schedule="exponential", lr_decay_steps=25000, weight_decay=0.0,
                clip_norm=1.0)


@pytest.fixture(scope="module")
def steps():
    model = port_model(teacher=False, freeze_bn=False, seed=4)
    params, stats = jax_variables(model)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = crop_batch(np.random.default_rng(1), b=2)

    jmodel = JRAFT(JRAFTConfig(iters=ITERS, freeze_bn=False, lookup_backend="einsum").resolved())
    jstate = GradsState.create(params, stats, jmake_optimizer(JTrainCfg(**TRAIN_KW), freeze_bn=False))
    jstep = jmake_unsup_train_step(jmodel, JModelCfg(**MODEL_KW), donate=False)
    jnew, jlog = jstep(jstate, jnp_batch(batch))

    tx = make_optimizer(TrainCfg(**TRAIN_KW))
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_unsup_train_step(model, ModelCfg(**MODEL_KW), debug_grads=True)
    state, log = step(state, torch_batch(batch))
    return {"jlog": jlog, "jgrads": to_port(jnew.grads, stats),
            "jvars": to_port(jnew.params, jnew.batch_stats), "log": log,
            "grads": log.pop("_grads"), "state": state, "before": before, "model": model,
            "lr": float(tx.lr_fn(0))}


def test_unsup_step_logs_match_jax(steps):
    check_logs(steps["log"], steps["jlog"], ["loss", "census", "smooth1", "selfsup"], total="loss")
    assert all(float(v) > 0 for v in steps["log"].values())


GRAD_LIMIT = 1e-3  # of each variable's largest element; see the module docstring


def _worst_gap(grads, ref):
    """Largest |g - g_ref| over each variable's largest |g_ref|, noise biases aside."""
    return max(float((grads[k] - ref[k]).abs().max() / ref[k].abs().max())
               for k in grads if not noise_bias(k, True) and ref[k].abs().max() > 0)


def test_unsup_step_grads_match_jax(steps):
    check_grads(steps["grads"], steps["jgrads"], steps["before"], bn_train=True,
                limit=GRAD_LIMIT)


def _port_grads(perturbation_seed=None, threads=None):
    """The port step's gradients, from weights scaled by 1 + 2^-24 N(0, 1)
    for a perturbation seed, on ``threads`` torch threads for a summation
    order other than the reference step's."""
    model = port_model(teacher=False, freeze_bn=False, seed=4)
    if perturbation_seed is not None:
        gen = torch.Generator().manual_seed(perturbation_seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 2.0**-24 * torch.randn(p.shape, generator=gen))
    state = TrainState.create(dict(model.named_parameters()), make_optimizer(TrainCfg(**TRAIN_KW)))
    before = torch.get_num_threads()
    torch.set_num_threads(threads or before)
    try:
        _, log = make_unsup_train_step(model, ModelCfg(**MODEL_KW), debug_grads=True)(
            state, torch_batch(crop_batch(np.random.default_rng(1), b=2)))
    finally:
        torch.set_num_threads(before)
    return log["_grads"]


def test_unsup_step_rounding_spread(steps):
    """The port step on another thread count (another summation order), and
    from rounding-scale weight perturbations for three seeds: each lies from
    the reference port step about as far as JAX's does, and the limit is at
    least 2x the largest of them."""
    order = _worst_gap(_port_grads(threads=3 if torch.get_num_threads() != 3 else 2),
                       steps["grads"])
    perturbed = [_worst_gap(_port_grads(seed), steps["grads"]) for seed in range(3)]
    gap = _worst_gap(steps["grads"], steps["jgrads"])
    print(f"summation-order spread {order:.3g}, perturbation spreads "
          f"{[f'{s:.3g}' for s in perturbed]}, JAX gap {gap:.3g} of each variable's largest")
    assert 0 < order and 0 < min(perturbed) and max(order, *perturbed, gap) <= GRAD_LIMIT / 2


def test_unsup_step_params_and_running_statistics_match_jax(steps):
    assert steps["state"].step == 1
    check_updates(steps["state"].params, steps["before"], steps["jvars"], frozenset(),
                  steps["lr"], 0.0, bn_train=True, max_lr=2.0, share_lr=1e-2, share=0.995)
    sd = steps["model"].state_dict()
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), steps["jvars"][k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
