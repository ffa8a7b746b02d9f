"""The port's evaluate and ckpt_tool CLIs on the CPU.

- Against the JAX package: the repository's ``evaluate.py`` and ``python -m
  flow_supervisor_tpu_torch.evaluate --device cpu`` on one synthetic tree
  (``FST_DATA_ROOT``) with one reference TF checkpoint (a flow supervisor
  with its teacher head, the port model's weights at the reference's
  variable paths): ``<cfg> --tf_ckpt <prefix> --dataset sintel
  --eval_iters 2``. ``<cfg>`` holds an ``args.yaml`` that both packages
  read (1 teacher iteration, scanned iterations in JAX: the JAX CLI's flax
  init and compile take about a minute, its one run in this file). The JSON
  agrees on every metric of both passes: EPE within 1e-3 px, the n-px
  accuracies within 1e-2, as the evaluation tests hold the Evaluator.
- The port alone: the CLI on a port checkpoint directory (a GMA flow
  supervisor: ``args.yaml`` and ``ckpt_<step>.pt``) equals the
  ``Evaluator`` run in the process on the same model, ``--step`` picks the
  checkpoint (``--space_parallel``: tests/test_torch_space_eval.py); ``ckpt_tool list`` and
  ``clean`` (latest and ``--step``) round-trip, and the cleaned directory
  evaluates to the same numbers.
"""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("tensorflow")

from flow_supervisor_tpu_torch import ckpt_tool, evaluate  # noqa: E402
from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg  # noqa: E402
from flow_supervisor_tpu_torch.data import datasets as D  # noqa: E402
from flow_supervisor_tpu_torch.data import paths  # noqa: E402
from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree  # noqa: E402
from flow_supervisor_tpu_torch.evaluation import Evaluator  # noqa: E402
from flow_supervisor_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from flow_supervisor_tpu_torch.training.loop import build_model  # noqa: E402
from test_torch_port_ckpt_bridges import write_reference_tf_checkpoint  # noqa: E402
from test_torch_train_jaxstep import port_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPE_LIMIT = 1e-3  # px
SHARE_LIMIT = 1e-2
TIMING = ("pairs_per_sec", "_ms_per_pair")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic tree, FST_DATA_ROOT pointing at it (the port's paths
    reloaded) for the module's tests."""
    root = tmp_path_factory.mktemp("entry") / "datasets"
    build_synthetic_tree(root)
    old = os.environ.get("FST_DATA_ROOT")
    os.environ["FST_DATA_ROOT"] = str(root)
    importlib.reload(paths)
    yield root
    if old is None:
        os.environ.pop("FST_DATA_ROOT")
    else:
        os.environ["FST_DATA_ROOT"] = old
    importlib.reload(paths)


def _cli_json(main, argv, capsys) -> dict:
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def _metrics(res: dict) -> dict:
    return {k: v for k, v in res.items() if not any(t in k for t in TIMING)}


@pytest.fixture(scope="module")
def tf_run(tree, tmp_path_factory):
    """The JAX CLI's JSON on the TF checkpoint, and the checkpoint."""
    base = tmp_path_factory.mktemp("tf_eval")
    prefix = str(base / "ckpt-100000-weights")
    write_reference_tf_checkpoint(prefix, port_model(teacher=True, freeze_bn=True, seed=3))
    cfg = ExperimentConfig(ModelCfg(iters=1, teacher_iters=1, scan_iters=True),
                           ckpt_dir=str(base / "cfg"))
    cfg.save_yaml()
    env = dict(os.environ, FST_DATA_ROOT=str(tree), JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "evaluate.py"), cfg.ckpt_dir, "--tf_ckpt", prefix,
         "--dataset", "sintel", "--eval_iters", "2"],
        capture_output=True, text=True, env=env, cwd=str(base), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    return json.loads(out[out.index("{\n"):]), prefix, cfg.ckpt_dir


def test_evaluate_cli_matches_jax_on_a_tf_checkpoint(tf_run, capsys):
    want, prefix, cfg_dir = tf_run
    got = _cli_json(evaluate.main, [cfg_dir, "--tf_ckpt", prefix, "--dataset", "sintel",
                                    "--eval_iters", "2", "--device", "cpu"], capsys)
    keys = _metrics(want)
    assert len(keys) == 16 and set(keys) <= set(got)  # student and teacher, both passes
    for k, w in keys.items():
        limit = EPE_LIMIT if k.endswith("_epe") else SHARE_LIMIT
        print(f"{k}: port {got[k]:.6f} JAX {w:.6f}")
        assert abs(got[k] - w) <= limit, (k, got[k], w)


@pytest.fixture(scope="module")
def port_ckpt(tree, tmp_path_factory):
    """A GMA flow supervisor's checkpoint directory (args.yaml, steps 2 and
    5, the optimizer state in both) and its model at step 5."""
    run = str(tmp_path_factory.mktemp("port_ckpt") / "run")
    cfg = ExperimentConfig(ModelCfg(model_type="gma-semi", iters=1, teacher_iters=1,
                                    compute_dtype="float32"), ckpt_dir=run)
    cfg.save_yaml()
    models = {}
    for step, seed in ((2, 1), (5, 2)):
        model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("aggregator.gamma"):
                    p.fill_(0.5)
        opt = ckpt.AdamWState(count=step, mu={k: torch.zeros(1) for k in ("a",)},
                              nu={k: torch.ones(1) for k in ("a",)})
        ckpt.save_checkpoint(run, step, model.state_dict(), opt)
        models[step] = model.eval()
    return run, models


def _in_process(model, iters=1) -> dict:
    ev = Evaluator(model, iters=iters)
    out = {}
    for p in ("clean", "final"):
        out.update({f"{p}_{k}": v for k, v in ev.evaluate(D.sintel(True, p)).items()})
    return _metrics(out)


def _close(got: dict, want: dict, tol=1e-5):
    assert set(_metrics(got)) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= tol * max(1.0, abs(w)), (k, got[k], w)


def test_evaluate_cli_reads_a_port_checkpoint_directory(port_ckpt, capsys):
    run, models = port_ckpt
    argv = [run, "--dataset", "sintel", "--eval_iters", "1", "--device", "cpu"]
    got = _cli_json(evaluate.main, argv, capsys)
    assert "clean_teacher_epe" in got and "final_student_epe_5px" in got
    _close(got, _in_process(models[5]))
    _close(_cli_json(evaluate.main, argv + ["--step", "2"], capsys), _in_process(models[2]))


def test_ckpt_tool_list_and_clean_round_trip(port_ckpt, tmp_path, capsys):
    run, models = port_ckpt
    capsys.readouterr()
    assert ckpt_tool.main(["list", run, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "steps: [2, 5]"
    for argv, step in (([], 5), (["--step", "2"], 2)):
        out = str(tmp_path / f"clean_{step}")
        assert ckpt_tool.main(["clean", run, out, "--device", "cpu", *argv]) == 0
        assert ckpt.checkpoint_steps(out) == [step]
        restored = ckpt.restore_checkpoint(out)
        assert restored["step"] == step and restored["opt_state"] is None
        assert ckpt.restore_checkpoint(run, step)["opt_state"].count == step
        want = models[step].state_dict()
        assert sorted(restored["model"]) == sorted(want)
        for k, v in want.items():
            assert torch.equal(restored["model"][k], v), k
        assert open(os.path.join(out, "args.yaml")).read() == open(
            os.path.join(run, "args.yaml")).read()
    cleaned = _cli_json(evaluate.main, [str(tmp_path / "clean_5"), "--eval_iters", "1",
                                        "--device", "cpu"], capsys)
    original = _cli_json(evaluate.main, [run, "--eval_iters", "1", "--device", "cpu"], capsys)
    assert _metrics(cleaned) == _metrics(original)
    assert ckpt_tool.main(["clean", run, "--device", "cpu"]) == 2
    assert ckpt_tool.main(["list", str(tmp_path / "none"), "--device", "cpu"]) == 0
    assert np.isfinite(list(_metrics(cleaned).values())).all()
