"""One supervised (Baseline) train step of the port against one step of the
JAX package, on the CPU, fp32, on the same weights and batch: B=2, 32x48,
2 iterations, unfrozen batch norm (the chairs stages: cnet normalizes by
batch statistics and updates its running ones, flax's biased variance and
momentum 0.99), the chairs recipe's optimizer (lr 4e-4 onecycle, weight
decay 1e-4, clipnorm 1). The JAX step runs once, in a module fixture.
Tolerances and set-up: tests/test_torch_train_jaxstep.py; the running
statistics after the step to rtol 1e-5."""
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.config import TrainCfg as JTrainCfg
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.training.baseline import make_train_step as jmake_train_step
from flow_supervisor_tpu.training.optim import make_optimizer as jmake_optimizer
from flow_supervisor_tpu_torch.config import TrainCfg
from flow_supervisor_tpu_torch.training.baseline import make_train_step
from flow_supervisor_tpu_torch.training.optim import make_optimizer
from flow_supervisor_tpu_torch.training.state import TrainState
from test_torch_train_jaxstep import (
    ITERS, GradsState, check_grads, check_logs, check_updates, crop_batch, jax_variables,
    jnp_batch, labels, port_model, to_port, torch_batch,
)

TRAIN_KW = dict(lr=4e-4, lr_schedule="onecycle", weight_decay=1e-4, clip_norm=1.0,
                num_steps=100000)


@pytest.fixture(scope="module")
def steps():
    model = port_model(teacher=False, freeze_bn=False)
    params, stats = jax_variables(model)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    rng = np.random.default_rng(0)
    crops = crop_batch(rng, b=2)
    batch = {"image1": crops["image1"], "image2": crops["image2"], **labels(rng, b=2)}

    jmodel = JRAFT(JRAFTConfig(iters=ITERS, freeze_bn=False, lookup_backend="einsum").resolved())
    jstate = GradsState.create(params, stats, jmake_optimizer(JTrainCfg(**TRAIN_KW), freeze_bn=False))
    jstep = jmake_train_step(jmodel, loss_type="robust", gamma=0.8, donate=False)
    jnew, jlog = jstep(jstate, jnp_batch(batch))

    tx = make_optimizer(TrainCfg(**TRAIN_KW))
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, loss_type="robust", gamma=0.8, debug_grads=True)
    state, log = step(state, torch_batch(batch))
    return {"jlog": jlog, "jgrads": to_port(jnew.grads, stats),
            "jvars": to_port(jnew.params, jnew.batch_stats), "log": log,
            "grads": log.pop("_grads"), "state": state, "before": before, "model": model,
            "lr": float(tx.lr_fn(0)), "wd": float(tx.wd_fn(0))}


def test_baseline_step_logs_match_jax(steps):
    check_logs(steps["log"], steps["jlog"], ["loss", "epe"])


def test_baseline_step_grads_match_jax(steps):
    check_grads(steps["grads"], steps["jgrads"], steps["before"], bn_train=True)
    # unfrozen batch norm trains its scale and bias
    assert steps["grads"]["cnet.norm1.weight"].abs().max() > 0


def test_baseline_step_params_after_step_match_jax(steps):
    assert steps["state"].step == 1
    check_updates(steps["state"].params, steps["before"], steps["jvars"], frozenset(),
                  steps["lr"], steps["wd"], bn_train=True)


def test_baseline_step_running_statistics_match_jax(steps):
    """flax's running statistics: momentum 0.99 toward the batch's mean and
    BIASED variance (nn.BatchNorm2d's unbiased one is n/(n-1) off)."""
    sd, jvars = steps["model"].state_dict(), steps["jvars"]
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                                 for m in steps["model"].modules())
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), jvars[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    # and they moved: the step updated them
    before = port_model(teacher=False, freeze_bn=False).state_dict()
    assert all(not torch.equal(sd[k], before[k]) for k in names)
