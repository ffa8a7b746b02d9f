"""Per-iteration remat (``RAFTConfig.update_ckpt``, JAX's ``nn.remat`` of the
update block and the teacher head) on the CPU.

- The RAFT, GMA and small models: one train step's gradients with
  ``update_ckpt=True`` bitwise equal to the same step without it (the
  rematerialized blocks have no batch norm and no dropout, so their second
  run gives the same bits): the flow-supervisor semi step (student update
  block and teacher head) for RAFT and GMA, the Baseline step for the small
  model; fp32, 32x48 crops of 48x64 frames, 2 iterations.
- The port's remat RAFT against JAX's ``RAFTConfig(update_ckpt=True)`` on
  the same weights (``convert_torch_raft``): the flows of the forward with
  gradient and the gradients of <flow_up, g> with respect to every
  parameter, JAX jitted (einsum lookup), at the JAX-vs-port step tests'
  tolerances (flows 1e-4 px; each gradient within 1e-4 of its variable's
  largest, the fnet biases that an instance norm follows, fp32 noise in both
  packages, of their weight's largest).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg
from flow_supervisor_tpu_torch.training.loop import build_model, make_step
from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
from flow_supervisor_tpu_torch.training.state import TrainState
from test_torch_train_jaxstep import (
    ITERS, crop_batch, jax_variables, labels, noise_bias, port_model, to_port, torch_batch,
)

MODELS = {
    "raft": (dict(model_type="raft-semi"), dict(stage="semi-sintel_unsup_test-things_unsup")),
    "gma": (dict(model_type="gma-semi"), dict(stage="semi-davis_unsup-ctskh")),
    "small": (dict(model_type="raft-baseline", small=True), dict(stage="chairs")),
}


def _step_grads(kind: str, update_ckpt: bool) -> dict:
    model_kw, train_kw = MODELS[kind]
    cfg = ExperimentConfig(
        ModelCfg(**model_kw, iters=ITERS, teacher_iters=ITERS, compute_dtype="float32",
                 lookup_backend="einsum", lfr_loss_type="robust"),
        TrainCfg(**train_kw, lr=1e-5, lr_schedule="constant", weight_decay=0.0))
    model = build_model(cfg, torch.Generator().manual_seed(3), update_ckpt=update_ckpt)
    assert model.cfg.update_ckpt is update_ckpt
    if model.gma:  # gamma starts at zero, which leaves the attention out
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.data.fill_(0.5)
    frozen = batchnorm_params(model) if model.cfg.freeze_bn else ()
    state = TrainState.create(dict(model.named_parameters()), make_optimizer(cfg.train, frozen))
    rng = np.random.default_rng(4)
    if kind == "small":
        batch = torch_batch({k: v for k, v in crop_batch(rng, 2).items()
                             if k in ("image1", "image2")} | labels(rng, 2))
    else:
        sup = torch_batch(crop_batch(rng) | labels(rng))
        batch = (sup, torch_batch(crop_batch(rng)))
    _, log = make_step(model, cfg, debug_grads=True)(state, batch)
    return log["_grads"]


@pytest.mark.parametrize("kind", ["raft", "gma", "small"])
def test_remat_gives_the_same_gradients_bit_for_bit(kind, monkeypatch):
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint

    def counted(*args, **kw):
        calls.append(kw.get("use_reentrant"))
        return checkpoint(*args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    plain = _step_grads(kind, False)
    assert not calls
    remat = _step_grads(kind, True)
    # every update-block call with a graph: semi = sup (student + teacher
    # head) + unsup (two directions, the student's), Baseline = the student's
    assert calls == [False] * (ITERS * (1 if kind == "small" else 4))
    assert plain.keys() == remat.keys()
    differ = [k for k in plain if not torch.equal(plain[k], remat[k])]
    assert not differ, differ
    assert any(k.startswith("update_block.") and plain[k].abs().max() > 0 for k in plain)
    if kind != "small":
        assert any(k.startswith("teacher_update_block.") and plain[k].abs().max() > 0
                   for k in plain)


def test_remat_forward_and_gradients_match_jax_remat():
    model = port_model(teacher=False, freeze_bn=True)
    model = model.__class__(dataclasses.replace(model.cfg, update_ckpt=True,
                                                lookup_backend="einsum"))
    model.load_state_dict(port_model(teacher=False, freeze_bn=True).state_dict())
    params, stats = jax_variables(model)
    rng = np.random.default_rng(5)
    batch = crop_batch(rng)
    g = rng.normal(0, 1, (ITERS, 1, 32, 48, 2)).astype(np.float32)
    jmodel = JRAFT(JRAFTConfig(iters=ITERS, update_ckpt=True, freeze_bn=True,
                               lookup_backend="einsum").resolved())

    @jax.jit
    def jloss(p):
        out = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["image1"]),
                           jnp.asarray(batch["image2"]), train=False)
        return jnp.vdot(out["flow_up"], jnp.asarray(g)), out["flow_up"]

    (_, jflow), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model.train()
    names = [n for n, _ in model.named_parameters()]
    out = model.train_forward(torch.from_numpy(batch["image1"]), torch.from_numpy(batch["image2"]))
    grads = dict(zip(names, torch.autograd.grad((out["flow_up"] * torch.from_numpy(g)).sum(),
                                                list(model.parameters()))))
    np.testing.assert_allclose(out["flow_up"].detach().numpy(), np.asarray(jflow), atol=1e-4)
    want = to_port(jgrads, stats)
    for k, gk in grads.items():
        scale = want[k[: -len("bias")] + "weight"] if noise_bias(k) else want[k]
        err = float((gk - want[k]).abs().max() / scale.abs().max().clamp_min(1e-30))
        assert err < 1e-4, (k, err)
