"""One supervised (Baseline) train step of the port's small model against one
step of the JAX package, on the CPU, fp32, on the same weights and batch:
B=2, 32x48, 2 iterations, 4 levels at radius 3, bilinear upsampling, the
chairs recipe's optimizer (lr 4e-4 onecycle, weight decay 1e-4, clipnorm 1).
The small model has no batch norm (fnet instance norm, cnet none), so the
chairs stage's unfrozen batch norm changes nothing. The variables are
seeded numpy values in the JAX model's tree (``random_variables``; the JAX
package's converter has no small model), carried to the port by
``convert.from_flax``. The port runs the fused lookup (the plain versions of
K7 / K8 / K9 here), JAX einsum (the same function). The JAX step runs once,
in a module fixture. Tolerances: tests/test_torch_train_jaxstep.py (the
Baseline step's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flow_supervisor_tpu.config import TrainCfg as JTrainCfg
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.training.baseline import make_train_step as jmake_train_step
from flow_supervisor_tpu.training.optim import make_optimizer as jmake_optimizer
from flow_supervisor_tpu_torch.config import TrainCfg
from flow_supervisor_tpu_torch.convert import from_flax
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from flow_supervisor_tpu_torch.training.baseline import make_train_step
from flow_supervisor_tpu_torch.training.optim import make_optimizer
from flow_supervisor_tpu_torch.training.state import TrainState
from test_torch_train_jaxstep import (
    ITERS, GradsState, check_grads, check_logs, check_updates, crop_batch, jnp_batch, labels,
    random_variables, to_port, torch_batch,
)

TRAIN_KW = dict(lr=4e-4, lr_schedule="onecycle", weight_decay=1e-4, clip_norm=1.0,
                num_steps=100000)


@pytest.fixture(scope="module")
def steps():
    jmodel = JRAFT(JRAFTConfig(small=True, iters=ITERS, freeze_bn=False, lookup_backend="einsum",
                               scan_iters=True).resolved())
    params = random_variables(jmodel, seed=13)["params"]
    model = RAFT(RAFTConfig(small=True, iters=ITERS, lookup_backend="fused"))
    model.load_state_dict(from_flax(params, {}))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(14)
    crops = crop_batch(rng, b=2)
    batch = {"image1": crops["image1"], "image2": crops["image2"], **labels(rng, b=2)}

    jstate = GradsState.create(jax.tree_util.tree_map(jnp.asarray, params), {},
                               jmake_optimizer(JTrainCfg(**TRAIN_KW), freeze_bn=False))
    jstep = jmake_train_step(jmodel, loss_type="robust", gamma=0.8, donate=False)
    jnew, jlog = jstep(jstate, jnp_batch(batch))

    tx = make_optimizer(TrainCfg(**TRAIN_KW))
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, loss_type="robust", gamma=0.8, debug_grads=True)
    state, log = step(state, torch_batch(batch))
    return {"jlog": jlog, "jgrads": to_port(jnew.grads, {}), "jvars": to_port(jnew.params, {}),
            "log": log, "grads": log.pop("_grads"), "state": state, "before": before,
            "lr": float(tx.lr_fn(0)), "wd": float(tx.wd_fn(0)), "model": model}


def test_small_baseline_step_logs_match_jax(steps):
    check_logs(steps["log"], steps["jlog"], ["loss", "epe"])


def test_small_baseline_step_grads_match_jax(steps):
    """fnet's conv biases (an instance norm follows each but the last) are
    fp32 noise; cnet has no norm, so its biases train."""
    check_grads(steps["grads"], steps["jgrads"], steps["before"])
    assert steps["grads"]["cnet.layer1.0.conv1.bias"].abs().max() > 0
    assert steps["model"].cfg.corr_radius == 3
    assert steps["grads"]["update_block.encoder.convc1.weight"].shape[1] == 4 * 49


def test_small_baseline_step_params_after_step_match_jax(steps):
    assert steps["state"].step == 1
    check_updates(steps["state"].params, steps["before"], steps["jvars"], frozenset(),
                  steps["lr"], steps["wd"])
