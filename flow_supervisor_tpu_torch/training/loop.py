"""Training loop (counterpart of flow_supervisor_tpu/training/loop.py):
model build, weight transplants, stepping and metric logging.

    from flow_supervisor_tpu_torch.training.loop import train
    model, state = train(cfg, data_iter, max_steps=100)

The model type picks the model and the step, as in the JAX package: the
prefix ``raft`` or ``gma`` the model (``ModelCfg.small`` the small one), the
suffix ``baseline`` (training/baseline.py), ``unsup`` (training/unsup.py) or
``semi`` (training/semi.py) the step. ``data_iter`` yields one batch dict per step for the
first two and a (sup_batch, unsup_batch) tuple for semi (each step's batch
contract), from ``data.pipeline.fetch_dataloader`` or any source. The loop
moves each batch to the device, steps, and every ``log_every`` steps appends
the log (losses, epe, steps/s) as one JSON row to
``<ckpt_dir>/metrics.jsonl``. Standing validation runs as in the JAX loop:
once before the first step of a new run unless ``skip_validation_at_start``,
then every ``val_step`` steps and after the last, each result a ``"prefix":
"val"`` row of the same file (``evaluation.make_train_validator``: none runs
when no validation set is found). Batch-norm running statistics live in
the model's buffers. Checkpoints (``training/checkpoint.py``) are saved at
every ``val_step`` and after the last step; a run resumes from its
directory's latest one, restoring the optimizer state and the step. That
differs from the JAX loop, which rebuilds the optimizer state on resume, so
its schedules and Adam's bias correction start again from 0. In both
packages the data stream starts again from the seed. Training runs through
every lookup backend. It runs on the card unless the caller passes
``device="cpu"``.

Data parallelism (parallel/mesh.py): ``train`` runs in the world its caller
has joined (the train CLI spawns the ranks, or torchrun starts them), each
rank on its own device with its rows of every global batch in ``data_iter``
(``fetch_dataloader(..., shard=(rank, world))``); the steps average the
gradients and the logs. The global batch must divide the world. Every rank
restores the same checkpoint; rank 0 alone writes ``args.yaml``,
``metrics.jsonl`` and the checkpoints and runs the standing validation,
while the others wait at a barrier.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Optional

import torch

from flow_supervisor_tpu_torch.config import ExperimentConfig
from flow_supervisor_tpu_torch.evaluation import make_train_validator
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from flow_supervisor_tpu_torch.parallel import mesh
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


def build_model(cfg: ExperimentConfig, generator: Optional[torch.Generator] = None,
                update_ckpt: bool = False) -> RAFT:
    """The port's RAFT for a config, random weights from ``generator``;
    ``teacher``, ``freeze_bn``, GMA and the correlation levels and radius
    resolved as in the JAX package (``RAFTConfig.resolved``: ModelCfg's
    corr_levels / corr_radius are not read). Parameters are fp32 masters,
    cast to the compute dtype at each conv call. ``update_ckpt``: remat
    each refinement iteration (``RAFTConfig.update_ckpt``; ModelCfg has no
    such field, as in JAX, where only the train benchmark sets it)."""
    mc = cfg.model
    if mc.dropout != 0.0:
        # the JAX step passes no "dropout" rng, so flax's dropout fails on an
        # unfrozen-BN step; its SmallEncoder never applies the field
        raise NotImplementedError("ModelCfg(dropout > 0) is not ported")
    rcfg = RAFTConfig(
        small=mc.small,
        iters=mc.iters,
        teacher=mc.model_type.endswith("semi"),
        teacher_iters=mc.teacher_iters,
        freeze_bn=frozen_bn(cfg),
        gma=mc.model_type.startswith("gma"),
        num_heads=mc.num_heads,
        position_only=mc.position_only,
        position_and_content=mc.position_and_content,
        dtype=_DTYPES[mc.compute_dtype],
        corr_dtype=_DTYPES[mc.corr_dtype],
        lookup_backend=mc.lookup_backend,
        update_ckpt=update_ckpt,
    ).resolved()
    return RAFT(rcfg, generator=generator, param_dtype=torch.float32)


MODEL_TYPES = tuple(f"{m}-{s}" for m in ("raft", "gma") for s in ("baseline", "unsup", "semi"))


def _to(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_step(model, cfg: ExperimentConfig, debug_grads: bool = False):
    """The train step of cfg's model type -> step(state, batch) for every
    type (semi's batch is the (sup, unsup) pair); ``debug_grads`` puts the
    gradients the step applied in its log as "_grads"."""
    mc, tc = cfg.model, cfg.train
    if mc.model_type.endswith("semi"):
        semi = make_semi_train_step(model, mc, gamma=tc.loss_decay_rate,
                                    sup_loss_type=tc.loss_type, debug_grads=debug_grads)
        return lambda state, batch: semi(state, *batch)
    if mc.model_type.endswith("unsup"):
        return make_unsup_train_step(model, mc, debug_grads=debug_grads)
    return make_train_step(model, loss_type=tc.loss_type, gamma=tc.loss_decay_rate,
                           debug_grads=debug_grads)


def world_of(cfg: ExperimentConfig, device_type: str) -> int:
    """The data-parallel world a run of cfg spans on ``device_type``
    (``mesh.plan_world``): its local ranks are the cards on CUDA, and
    ``data_parallel`` processes on the CPU, which counts as one device."""
    n_local = torch.cuda.device_count() if device_type == "cuda" else 1
    tc = cfg.train
    if device_type == "cpu" and tc.data_parallel > 0:
        n_local = tc.data_parallel
    return mesh.plan_world(tc.batch_size, tc.data_parallel, tc.dcn_parallel, n_local)


def check_config(cfg: ExperimentConfig, device_type: str = "cpu") -> None:
    """Refuse, before any work, a config the port does not train: another
    model type, the frame-triplet stage, a batch that does not divide the
    nodes' world (``world_of``)."""
    if cfg.model.model_type not in MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {cfg.model.model_type!r}: the port trains {MODEL_TYPES}"
        )
    if cfg.train.stage == "sintel_multiframe":
        raise ValueError(
            "stage sintel_multiframe yields frame triplets (image1-3, flow1/2, valid1/2); "
            "no train step reads them (the JAX package hands them to a step that reads "
            "batch['flow'] and fails there)"
        )
    world_of(cfg, device_type)


def _restore_or_init(model: RAFT, cfg: ExperimentConfig):
    """Load the latest checkpoint of cfg.ckpt_dir into ``model`` -> (step,
    its AdamWState), or start from cfg.train.pretrained_ckpt's fnet, cnet and
    update block (the teacher head copied from the update block) -> (0, None)."""
    restored = ckpt.restore_checkpoint(cfg.ckpt_dir, map_location="cpu")
    if restored is not None:
        model.load_state_dict(restored["model"])
        print(f"resumed from {cfg.ckpt_dir} at step {restored['step']}")
        return restored["step"], restored["opt_state"]
    if cfg.train.pretrained_ckpt:
        pre = ckpt.restore_checkpoint(cfg.train.pretrained_ckpt, map_location="cpu")
        if pre is None:
            raise FileNotFoundError(f"no checkpoint in pretrained_ckpt {cfg.train.pretrained_ckpt!r}")
        sd = ckpt.initialize_from_baseline(model.state_dict(), pre["model"])
        model.load_state_dict(ckpt.initialize_teacher_net(sd) if model.cfg.teacher else sd)
        print(f"initialized from pretrained {cfg.train.pretrained_ckpt}")
    return 0, None


class _Trace:
    """A torch.profiler trace of the steps between start() and stop(),
    written to <trace_dir>/trace.json."""

    def __init__(self, trace_dir: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.trace_dir, self.device = trace_dir, device
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.running = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.start()
        self.running = True

    def stop(self) -> None:
        self._sync()
        self.prof.stop()
        self.running = False
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        print(f"trace written to {path}")


def train(
    cfg: ExperimentConfig,
    data_iter,
    max_steps: Optional[int] = None,
    device=None,
    validate_fn: Optional[Callable[[int, TrainState], dict]] = None,
):
    """Train for cfg.train.num_steps (or max_steps) -> (model, state).

    Restore or initialize: the latest checkpoint of cfg.ckpt_dir (the model's
    state dict, the optimizer's state and the step), else
    cfg.train.pretrained_ckpt's fnet / cnet / update block (the teacher head
    of raft-semi copied from the update block), else random weights from
    cfg.train.seed. A checkpoint is saved at every ``val_step`` and after the
    last step, before that step's validation. ``validate_fn(step, state)``:
    the standing validation (default: the validators ``make_train_validator``
    builds from the stage's datasets), run once before the first step of a
    new run unless ``skip_validation_at_start``. ``device``: the card
    (default; raises if there is none) or ``"cpu"``; a rank's own device in
    a data-parallel world, whose rank 0 alone writes files and validates."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("train needs a CUDA device; none is available (pass device='cpu')")
        device = torch.device("cuda")
    device = torch.device(device)
    check_config(cfg, device.type)
    world, main = mesh.world_size(), mesh.is_main()
    if cfg.train.batch_size % world != 0:
        raise ValueError(f"batch_size={cfg.train.batch_size} does not divide over the world's "
                         f"{world} ranks")
    model = build_model(cfg, torch.Generator().manual_seed(cfg.train.seed))
    start_step, opt_state = _restore_or_init(model, cfg)
    model.to(device)
    tx = make_optimizer(cfg.train, batchnorm_params(model) if model.cfg.freeze_bn else ())
    state = TrainState.create(dict(model.named_parameters()), tx)
    if start_step:
        if opt_state is None or opt_state.mu.keys() != state.opt_state.mu.keys():
            raise ValueError(f"the checkpoint of step {start_step} in {cfg.ckpt_dir} holds no "
                             "optimizer state for this model's trained parameters")
        state.step, state.opt_state = start_step, ckpt.optimizer_state_to(opt_state, device)
    step_fn = make_step(model, cfg)
    if validate_fn is None and main:
        validate_fn = make_train_validator(cfg, model)
    if main:
        cfg.save_yaml()
    total = cfg.train.num_steps if max_steps is None else max_steps
    # --trace_dir: trace_steps steps after two warm-up steps, on rank 0
    trace = _Trace(cfg.train.trace_dir, device) if cfg.train.trace_dir and main else None
    last, since = time.perf_counter(), 0
    with open(os.path.join(cfg.ckpt_dir, "metrics.jsonl"), "a") if main else \
            contextlib.nullcontext() as f:

        def run_validation(at_step: int) -> None:
            if not main or validate_fn is None:
                mesh.barrier()
                return
            val = {k: float(v) for k, v in validate_fn(at_step, state).items()}
            f.write(json.dumps({"step": at_step, "prefix": "val", **val}) + "\n")
            f.flush()
            print(f"val {at_step}: " + ", ".join(f"{k}={v:.4f}" for k, v in val.items()))
            mesh.barrier()

        if start_step == 0 and not cfg.train.skip_validation_at_start:
            run_validation(0)
        for step_i in range(start_step, total):
            if trace is not None and step_i == start_step + 2:
                trace.start()
            elif trace is not None and step_i == start_step + 2 + cfg.train.trace_steps:
                trace.stop()
            batch = next(data_iter)
            batch = (tuple(_to(b, device) for b in batch) if isinstance(batch, (tuple, list))
                     else _to(batch, device))
            state, metrics = step_fn(state, batch)
            since += 1
            if (step_i + 1) % cfg.train.log_every == 0 and main:
                row = {k: float(v) for k, v in metrics.items()}  # waits for the device
                now = time.perf_counter()
                row["steps_per_sec"] = since / max(now - last, 1e-9)
                last, since = now, 0
                f.write(json.dumps({"step": step_i + 1, "prefix": "train", **row}) + "\n")
                f.flush()
                print(f"step {step_i + 1}: " + ", ".join(f"{k}={v:.4f}" for k, v in row.items()))
            if (step_i + 1) % cfg.train.val_step == 0 or step_i + 1 == total:
                if main:
                    ckpt.save_checkpoint(cfg.ckpt_dir, step_i + 1, model.state_dict(),
                                         state.opt_state)
                run_validation(step_i + 1)
        if trace is not None and trace.running:  # the run ended inside the trace window
            trace.stop()
    return model, state
