"""The correctness check sees a broken timed path: each cell driven on the
CPU at a tiny size in float32 (so the sound run reads correct), once sound
and once with each fault the cell can have planted in the program
underneath: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced. (No cell spans chips, so
none can leave out an exchange between them.)"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from flowbench import program, registry
from flowbench.run import run_cell

TINY = {
    "infer": dict(batch=2, hw=[64, 96], iters=2, pool_batches=2, check_batches=2),
    "evaluate": dict(hw=[60, 96], iters=2, teacher_iters=2, scene_frames=4, check_pairs=2),
    "train": dict(batch=2, full_hw=[64, 128], sup_hw=[48, 96], unsup_hw=[56, 64], iters=2,
                  teacher_iters=2, pool_steps=5),
}
CELLS = ("raft.infer.b32", "gma.infer.b32", "raft.eval.sintel.fp32", "raft.train.semi.b8")
# The training cell's files, kept out of BENCHMARK.json while its pace,
# paced by the host, spreads differently from machine to machine (PERF.md).
UNLISTED = {"raft.train.semi.b8": {"name": "raft.train.semi.b8", "config": "raft",
                                   "traffic": "train.semi.sintel.b8", "chips": 1}}


def bench_cell(name: str):
    return registry.cell(name, entry=UNLISTED.get(name))


def tiny_run(name: str) -> dict:
    cell = bench_cell(name)
    t = dict(cell.traffic, dtype="float32", lookup_backend="einsum",
             **TINY[cell.traffic["runner"]])
    return run_cell(dataclasses.replace(cell, traffic=t), 2 ** 31 + 99, 0.5, False, "cpu", 0.0)


def no_update(monkeypatch):
    """The refinement step returns its state unchanged (no flow update)."""
    from flow_supervisor_tpu_torch.models import gma, update

    for cls in (update.BasicUpdateBlock, gma.GMAUpdateBlock):
        fwd = cls.forward

        def frozen(self, *args, _fwd=fwd):
            net, mask, delta = _fwd(self, *args)
            return args[0], mask, torch.zeros_like(delta)

        monkeypatch.setattr(cls, "forward", frozen)


def half_batch(monkeypatch):
    """Half of the batch computed, its flows handed out for the rest."""
    from flow_supervisor_tpu_torch.models.raft import RAFT

    fwd = RAFT.forward

    def half(self, image1, image2, **kw):
        n = max(image1.shape[0] // 2, 1)
        out = fwd(self, image1[:n], image2[:n], **kw)
        b = image1.shape[0]
        return {k: torch.cat([v] * b, 1)[:, :b] for k, v in out.items()}

    monkeypatch.setattr(RAFT, "forward", half)


def altered_flow(monkeypatch):
    """Each upsampled flow moved by half a pixel where it is made."""
    from flow_supervisor_tpu_torch.models import raft

    up = raft.upsample_convex
    monkeypatch.setattr(raft, "upsample_convex", lambda *a, **k: up(*a, **k) + 0.5 / 8.0)


def altered_warm_start(monkeypatch):
    """The warm start made from a flow off by one pixel."""
    from flow_supervisor_tpu_torch.utils import warm_start

    splat = warm_start.forward_interpolate
    monkeypatch.setattr(warm_start, "forward_interpolate", lambda f: splat(f) + 1.0)


def altered_low_flow(monkeypatch):
    """The low flow handed on to the next pair's warm start off by a pixel."""
    from flow_supervisor_tpu_torch.evaluation import Evaluator

    predict = Evaluator.predict

    def shifted(self, *args, **kw):
        results, low = predict(self, *args, **kw)
        return results, low + 1.0

    monkeypatch.setattr(Evaluator, "predict", shifted)


def unchanged_state(monkeypatch):
    """The train step leaves the parameters as they were."""
    from flow_supervisor_tpu_torch.training.state import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self, grads: self)


def half_train_batch(monkeypatch):
    """Half of each step's batch left out, the losses' means over the rest."""
    build = program.train_step

    def halved(*args):
        model, state, step = build(*args)

        def half(state, batches):
            return step(state, tuple({k: v[: v.shape[0] // 2] for k, v in b.items()}
                                     for b in batches))

        return model, state, half

    monkeypatch.setattr(program, "train_step", halved)


def altered_loss(monkeypatch):
    """The supervised sequence loss made half again as large where it is made."""
    from flow_supervisor_tpu_torch.training import semi

    loss = semi.sequence_loss
    monkeypatch.setattr(semi, "sequence_loss", lambda *a, **k: 1.5 * loss(*a, **k))


FAULTS = {
    "raft.infer.b32": (no_update, half_batch, altered_flow),
    "gma.infer.b32": (no_update, half_batch, altered_flow),
    "raft.eval.sintel.fp32": (no_update, altered_flow, altered_warm_start, altered_low_flow),
    "raft.train.semi.b8": (unchanged_state, half_train_batch, altered_loss),
}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_reads_correct(name):
    result = tiny_run(name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in FAULTS[n]],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_fault_reads_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = tiny_run(name)
    assert not result["correct"], result["checks"]
