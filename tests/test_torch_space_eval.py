"""Space-parallel evaluation on the CPU: the ``Evaluator`` at
``space_parallel=2`` in a world of 2 gloo ranks, and the evaluate CLI's
``--space_parallel 2``, each against ``space_parallel=1`` at the same pad
bucket (16, the rule's 8 * 2).

- The Evaluator: a flow-supervisor RAFT (fp32, the auto lookup: einsum
  here, 2 student and 1 teacher iteration, weights from a seed) scores a
  synthetic Sintel scene of 3 frames at 44x60 (padded to 48x64: each rank
  holds 24 rows) with its teacher split and warm start. Every rank returns
  the same metrics, within 1e-5 of one process's; the first pair's student
  and teacher flows and its low flow within 1e-5. Asked for pad bucket 8,
  the sharded Evaluator pads to 16 (JAX's rule).
- The CLI on a checkpoint directory (``args.yaml``, ``ckpt_1.pt``): the
  JSON of ``--space_parallel 2`` (spawned ranks; rank 0's results) equals
  that of ``--space_parallel 1 --pad_bucket 16`` within 1e-5 on every
  metric of the synthetic chairs validation pair (48x64); a rank that
  fails (a missing ``--step``) makes the command exit non-zero.
- The refusals: ``Evaluator(space_parallel=2)`` outside a world of 2 names
  both counts, and so does a rank of the CLI (``run_rank``) whose
  ``--space_parallel`` is not its world's size; under torchrun (``RANK`` /
  ``WORLD_SIZE`` set) the CLI exits 2 unless ``--space_parallel`` equals the
  world size; a height off the 8 * space grid: tests/test_torch_space_world.py.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

from flow_supervisor_tpu_torch import evaluate
from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg
from flow_supervisor_tpu_torch.data import datasets as D
from flow_supervisor_tpu_torch.data import paths
from flow_supervisor_tpu_torch.data.pipeline import load_record
from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree
from flow_supervisor_tpu_torch.evaluation import Evaluator
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from flow_supervisor_tpu_torch.training import checkpoint as ckpt
from flow_supervisor_tpu_torch.training.loop import build_model
from test_torch_space_world import run_world

WORLD = 2
LIMIT = 1e-5
SINTEL_HW = (44, 60)
CFG = {"iters": 2, "teacher": True, "teacher_iters": 1, "lookup_backend": "auto"}
TIMING = ("pairs_per_sec", "_ms_per_pair")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("space_eval") / "datasets"
    build_synthetic_tree(root, sizes={"sintel": SINTEL_HW})
    old = os.environ.get("FST_DATA_ROOT")
    os.environ["FST_DATA_ROOT"] = str(root)
    importlib.reload(paths)
    yield root
    if old is None:
        os.environ.pop("FST_DATA_ROOT")
    else:
        os.environ["FST_DATA_ROOT"] = old
    importlib.reload(paths)


def _metrics(res: dict) -> dict:
    return {k: v for k, v in res.items() if not any(t in k for t in TIMING)}


@pytest.fixture(scope="module")
def evaluators(tree):
    model = RAFT(RAFTConfig(**CFG), generator=torch.Generator().manual_seed(4))
    records = D.sintel(True, "clean")
    assert len(records) == 2
    img1, img2, _, _ = load_record(records[0])
    ranks = run_world(WORLD, "evaluate", {
        "cfg": CFG, "state": model.state_dict(), "iters": CFG["iters"], "pad_bucket": 8,
        "records": records, "pair": (img1, img2)})
    one = Evaluator(model, iters=CFG["iters"], pad_bucket=16)
    return ranks, {"results": one.evaluate(records, warm_start=True),
                   "predict": one.predict(img1, img2, "sintel")}


def test_sharded_evaluator_matches_one_process(evaluators):
    ranks, one = evaluators
    want = _metrics(one["results"])
    assert {"student_epe", "teacher_epe", "student_epe_1px"} <= set(want)
    for r in ranks:
        assert r["pad_bucket"] == 16
        got = _metrics(r["results"])
        assert set(got) == set(want)
        for k, w in want.items():
            print(k, got[k], w)
            assert abs(got[k] - w) <= LIMIT, (k, got[k], w)


def test_sharded_predict_matches_one_process(evaluators):
    ranks, one = evaluators
    (want, want_low) = one["predict"]
    assert want["student"].shape == (1, *SINTEL_HW, 2) and want_low.shape == (6, 8, 2)
    for r in ranks:
        got, low = r["predict"]
        for k in ("student", "teacher"):
            assert float(np.abs(got[k] - want[k]).max()) <= LIMIT, k
        assert float(np.abs(low - want_low).max()) <= LIMIT


def test_space_parallel_needs_a_world_of_its_size():
    model = RAFT(RAFTConfig(iters=1))
    with pytest.raises(ValueError, match="space_parallel=2.*a world of 2 ranks.*a world of 1"):
        Evaluator(model, space_parallel=2)


@pytest.fixture(scope="module")
def run_dir(tree, tmp_path_factory):
    run = str(tmp_path_factory.mktemp("space_cli") / "run")
    cfg = ExperimentConfig(ModelCfg(model_type="raft-semi", iters=2, teacher_iters=1,
                                    compute_dtype="float32"), ckpt_dir=run)
    cfg.save_yaml()
    model = build_model(cfg, generator=torch.Generator().manual_seed(6))
    ckpt.save_checkpoint(run, 1, model.state_dict())
    return run


def _cli_json(argv, capsys) -> dict:
    capsys.readouterr()
    assert evaluate.main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_cli_space_parallel_matches_one_process(run_dir, capsys):
    argv = [run_dir, "--dataset", "chairs", "--device", "cpu"]
    got = _metrics(_cli_json(argv + ["--space_parallel", "2"], capsys))
    want = _metrics(_cli_json(argv + ["--pad_bucket", "16"], capsys))
    assert len(want) == 8 and set(got) == set(want)  # the student and the teacher
    for k, w in want.items():
        assert abs(got[k] - w) <= LIMIT, (k, got[k], w)


def test_cli_exits_non_zero_when_a_rank_fails(run_dir, capsys):
    argv = [run_dir, "--dataset", "sintel", "--device", "cpu", "--space_parallel", "2",
            "--step", "7"]
    assert evaluate.main(argv) == 1
    assert "a rank of the space-parallel world failed" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [[], ["--space_parallel", "3"]], ids=["no_flag", "three"])
def test_cli_under_torchrun_refuses_another_space_parallel(run_dir, flag, monkeypatch, capsys):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert evaluate.main([run_dir, "--dataset", "chairs", "--device", "cpu", *flag]) == 2
    n = flag[1] if flag else "1"
    assert f"--space_parallel {n} under torchrun needs a world of {n} ranks; torchrun " \
           "started 2" in capsys.readouterr().err


def test_cli_rank_passes_its_space_parallel_to_the_evaluator(run_dir, tmp_path):
    args = evaluate.build_parser().parse_args(
        [run_dir, "--dataset", "chairs", "--device", "cpu", "--space_parallel", "2"])
    store = "file://" + str(tmp_path / "store")
    with pytest.raises(ValueError, match="space_parallel=2.*a world of 2 ranks.*a world of 1"):
        evaluate.run_rank(0, 1, args, store)
