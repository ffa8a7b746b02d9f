"""The train CLI in a data-parallel world of 2 on the CPU
(``python -m flow_supervisor_tpu_torch.train ... --data_parallel 2 --device
cpu``): the command spawns its two ranks (gloo over a FileStore in the
checkpoint directory), each reading its rows of every global batch (B=2)
from a synthetic tree; 2 steps of the 32x48 semi recipe, then a resume to 4.

- Rank 0 alone writes: one checkpoint at each save, one metrics row a step
  and a validation, ``args.yaml``; the store file is gone after the run.
- The resume restores on both ranks (the step and the optimizer count 4).
- The world's run equals 4 steps in this process over the same global
  batches (the stream's first two, twice: the resume starts the data stream
  again): every logged loss within 1e-5 relative, and 99.9 % of the
  parameters within 1e-2 lr of each other. The rest may lie up to lr a step
  apart: an Adam step moves an element by about lr whatever its gradient's
  size, so the elements whose gradient is rounding noise, the conv biases
  that an instance norm follows among them, take their direction from
  rounding.
"""
import glob
import importlib
import json
import os

import pytest
import torch

from flow_supervisor_tpu_torch import config as pconfig
from flow_supervisor_tpu_torch.data import paths as ppaths
from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree
from flow_supervisor_tpu_torch.parallel import dryrun
from flow_supervisor_tpu_torch.training import checkpoint as ckpt

LR = 1e-4
FLAGS = ["--stage", "semi-sintel_unsup_test-things_unsup", "--model_type", "raft-semi",
         "--image_size", "32", "48", "--unsup_image_size", "32", "48", "--full_size", "40", "56",
         "--iters", "1", "--teacher_iters", "1", "--compute_dtype", "float32", "--batch_size", "2",
         "--lr", "1e-4", "--lr_schedule", "exponential", "--lr_decay_steps", "3",
         "--weight_decay", "0.0", "--lfr_loss_type", "robust", "--lfl_loss_decay_rate", "1.0",
         "--val_step", "2", "--val_iters", "1", "--val_max_records", "1", "--log_every", "1",
         "--loader_workers", "0", "--seed", "3", "--data_parallel", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's two CLI runs, and 4 steps in this process."""
    from flow_supervisor_tpu_torch.data.pipeline import fetch_dataloader
    from flow_supervisor_tpu_torch.train import main
    from flow_supervisor_tpu_torch.training.loop import train

    tmp = tmp_path_factory.mktemp("dp_cli")
    root = tmp / "datasets"
    build_synthetic_tree(root)
    old = os.environ.get("FST_DATA_ROOT")
    os.environ["FST_DATA_ROOT"] = str(root)
    importlib.reload(ppaths)
    try:
        run = str(tmp / "run")
        assert main([run, "--num_steps", "2"] + FLAGS) == 0
        at2 = {"steps": ckpt.checkpoint_steps(run), "rows": _rows(run),
               "files": sorted(os.listdir(run))}
        assert main([run, "--num_steps", "4", "--device", "cpu", "--data_parallel", "2"]) == 0
        cfg = pconfig.ExperimentConfig.load_yaml(run)
        cfg.ckpt_dir = str(tmp / "whole")
        loader = fetch_dataloader(cfg.train)
        first = [next(loader), next(loader)]
        loader.close()
        model, state = train(cfg, iter(first + first), device="cpu", validate_fn=lambda s, st: {})
        whole = {"model": model.state_dict(), "rows": _rows(cfg.ckpt_dir)}
    finally:
        if old is None:
            os.environ.pop("FST_DATA_ROOT", None)
        else:
            os.environ["FST_DATA_ROOT"] = old
        importlib.reload(ppaths)
    return run, at2, whole


def _rows(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_rank_zero_alone_writes(runs):
    run, at2, _ = runs
    assert at2["steps"] == [2]
    assert [r["step"] for r in at2["rows"] if r["prefix"] == "train"] == [1, 2]
    assert [r["step"] for r in at2["rows"] if r["prefix"] == "val"] == [0, 2]
    assert at2["files"] == sorted(["args.yaml", "ckpt_2.pt", "metrics.jsonl"])
    assert not glob.glob(os.path.join(run, ".dist_store_*"))
    assert pconfig.ExperimentConfig.load_yaml(run).train.data_parallel == 2


def test_resume_in_a_world_of_two(runs):
    run, _, _ = runs
    assert ckpt.checkpoint_steps(run) == [2, 4]
    rows = _rows(run)
    assert [r["step"] for r in rows if r["prefix"] == "train"] == [1, 2, 3, 4]
    assert [r["step"] for r in rows if r["prefix"] == "val"] == [0, 2, 4]
    at4 = ckpt.restore_checkpoint(run, map_location="cpu")
    assert at4["step"] == 4 and at4["opt_state"].count == 4


def test_world_of_two_equals_one_process(runs):
    run, _, whole = runs
    got = [r for r in _rows(run) if r["prefix"] == "train"]
    want = [r for r in whole["rows"] if r["prefix"] == "train"]
    assert [r["step"] for r in want] == [1, 2, 3, 4]
    for a, b in zip(got, want):
        for k, v in b.items():
            if k not in ("step", "prefix", "steps_per_sec"):
                assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-7), (a["step"], k)
    at4 = ckpt.restore_checkpoint(run, map_location="cpu")["model"]
    diff = torch.cat([(at4[k] - v).abs().flatten() for k, v in whole["model"].items()
                      if k.endswith((".weight", ".bias", "gamma"))]) / LR
    share = float((diff <= 1e-2).float().mean())
    print({"max_param_err_lr": float(diff.max()), "share_within_1e-2_lr": share})
    assert share >= 0.999
