"""One flow-supervisor (gma-semi) train step of the port's GMA against one
step of the JAX package, on the CPU, fp32, on the same weights and batches.

The GMA model has 2 heads (so the aggregators' projection) and the position
and content similarity (so the position tables), a teacher head and frozen
batch norm; every aggregator's ``gamma`` is 0.5, not its initial zero, at
which q, k and v would get no gradient. The variables are seeded numpy
values in the JAX model's tree (``random_variables``), carried to the port
by ``convert.from_flax`` (the JAX package's converter does not map the
position tables). Both take one step of the DAVIS recipe's settings
(train.sh:47-53: robust losses, lfl_loss_decay_rate 0.8, lr 1e-5
exponential, no weight decay, clipnorm 1, pixel-sum L_fr, both directions)
on 32x48 crops of 48x64 frames, 2 student and 2 teacher iterations: the
port on the fused lookup (the plain versions of K6 / K8 / K9 here), JAX on
einsum (the same function). The JAX step runs once, in a module fixture.
Tolerances: tests/test_torch_train_jaxstep.py (the semi step's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flow_supervisor_tpu.config import ModelCfg as JModelCfg, TrainCfg as JTrainCfg
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
from test_torch_train_jaxstep import (
    ITERS, check_grads, check_logs, check_updates, crop_batch, jnp_batch, labels,
    random_variables, to_port, torch_batch,
)

GMA_KW = dict(gma=True, num_heads=2, position_and_content=True)
MODEL_KW = dict(model_type="gma-semi", iters=ITERS, teacher_iters=ITERS, num_heads=2,
                position_and_content=True, lfr_loss_type="robust", lfl_loss_decay_rate=0.8)
TRAIN_KW = dict(lr=1e-5, lr_schedule="exponential", lr_decay_steps=25000, weight_decay=0.0,
                clip_norm=1.0)


@pytest.fixture(scope="module")
def steps():
    jmodel = JRAFT(JRAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS, freeze_bn=True,
                               lookup_backend="einsum", scan_iters=True, **GMA_KW).resolved())
    v = random_variables(jmodel, seed=11)
    params, stats = v["params"], v["batch_stats"]
    model = RAFT(RAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS, freeze_bn=True,
                            lookup_backend="fused", **GMA_KW))
    model.load_state_dict(from_flax(params, stats))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(12)
    sup = {**crop_batch(rng, crops=((8, 16),)), **labels(rng)}
    unsup = crop_batch(rng, crops=((16, 0),))

    jstate = JTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, stats),
        jmake_optimizer(JTrainCfg(**TRAIN_KW), freeze_bn=True))
    jstep = jmake_semi_train_step(jmodel, JModelCfg(**MODEL_KW), gamma=0.8,
                                  sup_loss_type="robust", donate=False, debug_grads=True)
    jnew, jlog = jstep(jstate, jnp_batch(sup), jnp_batch(unsup))
    jgrads = to_port(jlog.pop("_merged_grads"), stats)

    tx = make_optimizer(TrainCfg(**TRAIN_KW), batchnorm_params(model))
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_semi_train_step(model, ModelCfg(**MODEL_KW), gamma=0.8, sup_loss_type="robust",
                                debug_grads=True)
    state, log = step(state, torch_batch(sup), torch_batch(unsup))
    return {"jlog": jlog, "jgrads": jgrads, "jvars": to_port(jnew.params, stats), "log": log,
            "grads": log.pop("_grads"), "state": state, "before": before,
            "frozen": batchnorm_params(model), "lr": float(tx.lr_fn(0))}


def test_gma_semi_step_logs_match_jax(steps):
    check_logs(steps["log"], steps["jlog"],
               ["sup_label_loss", "lfl_loss", "sup_loss", "epe", "lfr_loss", "unsup_loss"])


def test_gma_semi_step_grads_match_jax(steps):
    check_grads(steps["grads"], steps["jgrads"], steps["before"])
    # the attention path trains: q . k (to_qk), the position tables, v and
    # the projection of both heads, and gamma
    for name in ("att.to_qk.weight", "att.pos_emb.rel_height.weight",
                 "att.pos_emb.rel_width.weight", "update_block.aggregator.to_v.weight",
                 "update_block.aggregator.project.weight", "update_block.aggregator.gamma",
                 "teacher_update_block.aggregator.to_v.weight"):
        assert steps["jgrads"][name].abs().max() > 0, name


def test_gma_semi_step_params_after_step_match_jax(steps):
    assert steps["state"].step == 1
    check_updates(steps["state"].params, steps["before"], steps["jvars"], steps["frozen"],
                  steps["lr"], 0.0)
