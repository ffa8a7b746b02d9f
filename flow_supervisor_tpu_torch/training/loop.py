"""Training loop (counterpart of flow_supervisor_tpu/training/loop.py):
model build, weight transplants, stepping and metric logging.

    from flow_supervisor_tpu_torch.training.loop import train
    model, state = train(cfg, data_iter, max_steps=100)

The model type picks the step, as in the JAX package: ``raft-baseline``
(training/baseline.py), ``raft-unsup`` (training/unsup.py) or ``raft-semi``
(training/semi.py). ``data_iter`` yields one batch dict per step for the
first two and a (sup_batch, unsup_batch) tuple for semi (each step's batch
contract), from any source: the dataset pipeline is not ported yet. The loop
moves each batch to the device, steps, and every ``log_every`` steps appends
the log (losses, epe, steps/s) as one JSON row to
``<ckpt_dir>/metrics.jsonl``. Batch-norm running statistics live in the
model's buffers. Checkpoint files and standing validation are not ported
(ROADMAP Queue 1, items 3-5). Training runs only through
``lookup_backend="fused"``. It runs on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from flow_supervisor_tpu_torch.config import ExperimentConfig
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from flow_supervisor_tpu_torch.training import checkpoint as ckpt
from flow_supervisor_tpu_torch.training.baseline import make_train_step
from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
from flow_supervisor_tpu_torch.training.semi import make_semi_train_step
from flow_supervisor_tpu_torch.training.state import TrainState
from flow_supervisor_tpu_torch.training.unsup import make_unsup_train_step

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def frozen_bn(cfg: ExperimentConfig) -> bool:
    """Batch norm is frozen for every stage but the chairs ones, or when asked."""
    return cfg.train.freeze_bn or cfg.train.stage not in ("chairs", "chairs_unsup")


def build_model(cfg: ExperimentConfig, generator: Optional[torch.Generator] = None) -> RAFT:
    """The port's RAFT for a config, random weights from ``generator``;
    ``teacher`` and ``freeze_bn`` resolved as in the JAX package. Parameters
    are fp32 masters, cast to the compute dtype at each conv call."""
    mc = cfg.model
    if mc.dropout != 0.0:
        raise NotImplementedError("ModelCfg(dropout > 0) is not ported yet")
    if mc.model_type.startswith("gma"):
        raise NotImplementedError("GMA models are not ported yet (ROADMAP Queue 1, item 7)")
    rcfg = RAFTConfig(
        small=mc.small,
        iters=mc.iters,
        corr_levels=mc.corr_levels,
        corr_radius=mc.corr_radius,
        teacher=mc.model_type.endswith("semi"),
        teacher_iters=mc.teacher_iters,
        freeze_bn=frozen_bn(cfg),
        dtype=_DTYPES[mc.compute_dtype],
        corr_dtype=_DTYPES[mc.corr_dtype],
        lookup_backend=mc.lookup_backend,
    )
    return RAFT(rcfg, generator=generator, param_dtype=torch.float32)


MODEL_TYPES = ("raft-baseline", "raft-unsup", "raft-semi")


def _to(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_step(model, cfg: ExperimentConfig, debug_grads: bool = False):
    """The train step of cfg's model type -> step(state, batch) for every
    type (semi's batch is the (sup, unsup) pair); ``debug_grads`` puts the
    gradients the step applied in its log as "_grads"."""
    mc, tc = cfg.model, cfg.train
    if mc.model_type == "raft-semi":
        semi = make_semi_train_step(model, mc, gamma=tc.loss_decay_rate,
                                    sup_loss_type=tc.loss_type, debug_grads=debug_grads)
        return lambda state, batch: semi(state, *batch)
    if mc.model_type == "raft-unsup":
        return make_unsup_train_step(model, mc, debug_grads=debug_grads)
    return make_train_step(model, loss_type=tc.loss_type, gamma=tc.loss_decay_rate,
                           debug_grads=debug_grads)


def train(
    cfg: ExperimentConfig,
    data_iter,
    max_steps: Optional[int] = None,
    device=None,
    pretrained: Optional[dict[str, torch.Tensor]] = None,
):
    """Train for cfg.train.num_steps (or max_steps) -> (model, state).

    ``pretrained``: a baseline model's state dict, transplanted into fnet,
    cnet and the update block (the recipe's start from a baseline
    checkpoint), the update block then copied into raft-semi's teacher head;
    without it the weights are random from cfg.train.seed. ``device``: the
    card (default; raises if there is none) or ``"cpu"``."""
    if cfg.model.model_type not in MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {cfg.model.model_type!r}: the port trains {MODEL_TYPES}"
        )
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("train needs a CUDA device; none is available (pass device='cpu')")
        device = torch.device("cuda")
    model = build_model(cfg, torch.Generator().manual_seed(cfg.train.seed))
    if pretrained is not None:
        sd = ckpt.initialize_from_baseline(model.state_dict(), pretrained)
        model.load_state_dict(ckpt.initialize_teacher_net(sd) if model.cfg.teacher else sd)
    model.to(device)
    tx = make_optimizer(cfg.train, batchnorm_params(model) if model.cfg.freeze_bn else ())
    state = TrainState.create(dict(model.named_parameters()), tx)
    step_fn = make_step(model, cfg)
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    total = cfg.train.num_steps if max_steps is None else max_steps
    last, since = time.perf_counter(), 0
    with open(os.path.join(cfg.ckpt_dir, "metrics.jsonl"), "a") as f:
        for step_i in range(total):
            batch = next(data_iter)
            batch = (tuple(_to(b, device) for b in batch) if isinstance(batch, (tuple, list))
                     else _to(batch, device))
            state, metrics = step_fn(state, batch)
            since += 1
            if (step_i + 1) % cfg.train.log_every == 0:
                row = {k: float(v) for k, v in metrics.items()}  # waits for the device
                now = time.perf_counter()
                row["steps_per_sec"] = since / max(now - last, 1e-9)
                last, since = now, 0
                f.write(json.dumps({"step": step_i + 1, "prefix": "train", **row}) + "\n")
                f.flush()
                print(f"step {step_i + 1}: " + ", ".join(f"{k}={v:.4f}" for k, v in row.items()))
    return model, state
