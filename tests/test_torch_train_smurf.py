"""One flow-supervisor (semi) train step WITH the teacher SMURF loss, of the
port against one step of the JAX package, on the CPU, fp32, on the same
weights and batches: the KITTI recipe's loss settings (teacher_smurf_weight
1, census 1, smooth1 0, smooth2 2, brox occlusion, robust L_fr,
lfl_loss_decay_rate 0.8), frozen batch norm, 32x48 crops of 48x64 frames,
2 student and 2 teacher iterations. The unsup branch's teacher then runs
every iteration with gradient into the teacher head. The JAX step runs
once, in a module fixture. Tolerances and set-up:
tests/test_torch_train_jaxstep.py."""
import jax
import numpy as np
import pytest

from flow_supervisor_tpu.config import ModelCfg as JModelCfg, TrainCfg as JTrainCfg
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.training.optim import make_optimizer as jmake_optimizer
from flow_supervisor_tpu.training.semi import make_semi_train_step as jmake_semi_train_step
from flow_supervisor_tpu.training.state import TrainState as JTrainState
from flow_supervisor_tpu_torch.config import ModelCfg, TrainCfg
from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
from flow_supervisor_tpu_torch.training.semi import make_semi_train_step
from flow_supervisor_tpu_torch.training.state import TrainState
from test_torch_train_jaxstep import (
    ITERS, check_grads, check_logs, check_updates, crop_batch, jax_variables, jnp_batch, labels,
    port_model, to_port, torch_batch,
)

MODEL_KW = dict(iters=ITERS, teacher_iters=ITERS, lfr_loss_type="robust", lfl_loss_decay_rate=0.8,
                teacher_smurf_weight=1.0, census_weight=1.0, smooth1_weight=0.0,
                smooth2_weight=2.0, occlusion="brox")
TRAIN_KW = dict(lr=1e-5, lr_schedule="exponential", lr_decay_steps=25000, weight_decay=0.0,
                clip_norm=1.0)


@pytest.fixture(scope="module")
def steps():
    model = port_model(teacher=True, freeze_bn=True, seed=0)
    params, stats = jax_variables(model)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    rng = np.random.default_rng(0)
    sup = {**crop_batch(rng, crops=((8, 16),)), **labels(rng)}
    unsup = crop_batch(rng, crops=((16, 0),))

    jmodel = JRAFT(JRAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS, freeze_bn=True,
                               lookup_backend="einsum").resolved())
    jstate = JTrainState.create(params, stats,
                                jmake_optimizer(JTrainCfg(**TRAIN_KW), freeze_bn=True))
    jstep = jmake_semi_train_step(jmodel, JModelCfg(**MODEL_KW), gamma=0.8,
                                  sup_loss_type="robust", donate=False, debug_grads=True)
    jnew, jlog = jstep(jstate, jnp_batch(sup), jnp_batch(unsup))
    jgrads = to_port(jlog.pop("_merged_grads"), stats)

    frozen = batchnorm_params(model)
    state = TrainState.create(dict(model.named_parameters()),
                              make_optimizer(TrainCfg(**TRAIN_KW), frozen))
    step = make_semi_train_step(model, ModelCfg(**MODEL_KW), gamma=0.8, sup_loss_type="robust",
                                debug_grads=True)
    state, log = step(state, torch_batch(sup), torch_batch(unsup))
    return {"jlog": jax.tree_util.tree_map(float, jlog), "jgrads": jgrads,
            "jparams": to_port(jnew.params, stats), "log": log,
            "grads": log.pop("_grads"), "state": state, "before": before,
            "frozen": frozen}


def test_smurf_semi_step_logs_match_jax(steps):
    check_logs(steps["log"], steps["jlog"], ["sup_label_loss", "lfl_loss", "sup_loss", "epe",
                                             "teacher_smurf_loss", "lfr_loss", "unsup_loss"])


def test_smurf_semi_step_grads_match_jax(steps):
    check_grads(steps["grads"], steps["jgrads"], steps["before"])
    # the SMURF term reaches the teacher head through the unsup branch
    assert steps["grads"]["teacher_update_block.mask.2.weight"].abs().max() > 0


def test_smurf_semi_step_params_after_step_match_jax(steps):
    assert steps["state"].step == 1
    check_updates(steps["state"].params, steps["before"], steps["jparams"], steps["frozen"],
                  TRAIN_KW["lr"], 0.0)
