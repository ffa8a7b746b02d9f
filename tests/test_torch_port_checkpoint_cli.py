"""The port's config, checkpoint files and train CLI (config.py,
training/checkpoint.py, training/loop.py, train.py) on the CPU.

- The config: ModelCfg / TrainCfg with the JAX package's fields and
  defaults; the train parser's flags and aliases; ``args.yaml`` written by
  each package and read by the other; ``maybe_restore`` with explicit flags.
- Checkpoint files: save / latest / restore, the atomic rename.
- The CLI: 2 steps of a 32x48 semi run from a synthetic tree, then a resume
  to step 4, which gives the same parameters as 4 uninterrupted steps over
  the same batches (the data stream starts again from the seed on resume,
  in both packages). The resume restores the optimizer state: the JAX loop
  rebuilds it (its count, schedules and Adam's bias correction start again
  from 0), and that rule gives other parameters here.
- ``pretrained_ckpt``: a chairs Baseline checkpoint's fnet, cnet (with its
  batch-norm statistics) and update block, and the teacher head copied from
  the update block.
- GMA: the DAVIS recipe's model type and stage (``--model_type gma-semi
  --stage semi-davis_unsup-ctskh``, the synthetic tree's DAVIS frames are
  baseline JPEG) for 2 steps, then a resume to 4.
- The refusals: ``--stage sintel_multiframe`` and a batch that does not
  divide the data-parallel world (``--dcn_parallel 2`` at batch 1, JAX's
  assert) before the first step.
- ``trace_dir``: a torch.profiler trace after two warm-up steps."""
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch
import yaml

from flow_supervisor_tpu import config as jconfig
from flow_supervisor_tpu_torch import config as pconfig
from flow_supervisor_tpu_torch.data import paths as ppaths
from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree
from flow_supervisor_tpu_torch.training import checkpoint as ckpt

RECIPE = ["--stage", "semi-sintel_unsup_test-things_unsup", "--model_type", "raft-semi",
          "--unsup_weight", "1.0", "--unsup_image_size", "368", "768", "--image_size", "400", "720",
          "--full_size", "432", "1024", "--iters", "12", "--num_steps", "100000", "--val_step", "5000",
          "--lr", "1e-5", "--lr_schedule", "exponential", "--lr_decay_steps", "25000",
          "--weight_decay", "0.0", "--batch_size", "1", "--lfr_weight", "1.0", "--lfl_weight", "1.0",
          "--lfr_loss_type", "robust", "--lfl_loss_decay_rate", "1.0"]


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelCfg", "TrainCfg"])
def test_config_fields_are_the_jax_packages(name):
    assert _fields(getattr(pconfig, name)) == _fields(getattr(jconfig, name))


@pytest.mark.parametrize("argv", [[], RECIPE, RECIPE + ["--max_step", "8", "--learning_rate", "2e-5",
                                                        "--sup_image_size", "320", "640",
                                                        "--main_loss", "l1", "--use_bw", "false"]],
                         ids=["defaults", "sintel_recipe", "aliases"])
def test_parser_matches_jax(argv):
    argv = ["ckpts/x"] + argv
    got = pconfig.config_from_args(pconfig.build_argparser().parse_args(argv))
    want = jconfig.config_from_args(jconfig.build_argparser().parse_args(argv))
    assert got.to_dict() == want.to_dict()
    assert pconfig.explicit_cli_fields(argv) == jconfig.explicit_cli_fields(argv)


def _odd_config(pkg):
    """A config with every kind of value args.yaml holds: None, tuples,
    floats with exponents, empty and awkward strings."""
    cfg = pkg.config_from_args(pkg.build_argparser().parse_args(["run dir: 1"] + RECIPE))
    cfg.train.min_lr = 1e-8
    cfg.train.pretrained_ckpt = "ckpts/it's #1: \"things\""
    cfg.train.trace_dir = ""
    cfg.model.occlusion = "yes"
    cfg.train.full_size = None
    cfg.model.lfr_weight = 1e16
    return cfg


@pytest.mark.parametrize("odd", [False, True], ids=["recipe", "odd_values"])
def test_args_yaml_exchange(tmp_path, odd):
    def make(pkg):
        if odd:
            return _odd_config(pkg)
        return pkg.config_from_args(pkg.build_argparser().parse_args(["ckpts/x"] + RECIPE))

    # JAX writes, the port reads
    jcfg = make(jconfig)
    jpath = jcfg.save_yaml(str(tmp_path / "jax" / "args.yaml"))
    got = pconfig.ExperimentConfig.load_yaml(jpath)
    assert got.to_dict() == jcfg.to_dict()
    # the port writes, yaml and the JAX package read
    pcfg = make(pconfig)
    ppath = pcfg.save_yaml(str(tmp_path / "port" / "args.yaml"))
    with open(ppath) as f:
        loaded = yaml.safe_load(f)
    as_lists = {k: ({k2: list(v2) if isinstance(v2, tuple) else v2 for k2, v2 in v.items()}
                    if isinstance(v, dict) else v) for k, v in pcfg.to_dict().items()}
    assert loaded == as_lists
    assert jconfig.ExperimentConfig.load_yaml(ppath).to_dict() == pcfg.to_dict()


def test_maybe_restore_with_explicit_flags(tmp_path):
    """A first run saves its config; a second command line with --num_steps
    and --lr gets the saved config with those two fields replaced, as the
    JAX package does."""
    out = {}
    for name, pkg in (("port", pconfig), ("jax", jconfig)):
        run = str(tmp_path / name)
        for argv in ([run] + RECIPE, [run, "--num_steps", "8", "--lr", "3e-5", "--iters", "12"]):
            cfg = pkg.config_from_args(pkg.build_argparser().parse_args(argv))
            cfg = pkg.ExperimentConfig.maybe_restore(run, cfg, explicit=pkg.explicit_cli_fields(argv))
        out[name] = cfg.to_dict()
    assert out["port"]["train"]["num_steps"] == 8 and out["port"]["train"]["lr"] == 3e-5
    assert out["port"]["train"]["stage"] == "semi-sintel_unsup_test-things_unsup"
    assert out["port"]["train"]["image_size"] == (400, 720)
    out["jax"]["ckpt_dir"] = out["port"]["ckpt_dir"]
    assert out["port"] == out["jax"]


def test_checkpoint_files(tmp_path):
    from flow_supervisor_tpu_torch.training.optim import AdamWState

    run = str(tmp_path / "run")
    assert ckpt.latest_step(run) is None and ckpt.restore_checkpoint(run) is None
    g = torch.Generator().manual_seed(0)
    for step in (3, 12, 6):
        model = {"a.weight": torch.randn(4, 3, generator=g), "bn.running_mean": torch.randn(3, generator=g)}
        opt = AdamWState(step, {"a.weight": torch.randn(4, 3, generator=g)},
                         {"a.weight": torch.rand(4, 3, generator=g)})
        ckpt.save_checkpoint(run, step, model, opt)
    assert ckpt.checkpoint_steps(run) == [3, 6, 12] and ckpt.latest_step(run) == 12
    assert sorted(os.listdir(run)) == ["ckpt_12.pt", "ckpt_3.pt", "ckpt_6.pt"]  # no temporary left
    got = ckpt.restore_checkpoint(run, step=6, map_location="cpu")
    assert got["step"] == 6 and got["opt_state"].count == 6
    assert torch.equal(got["model"]["a.weight"], model["a.weight"])
    assert torch.equal(got["opt_state"].nu["a.weight"], opt.nu["a.weight"])
    assert ckpt.restore_checkpoint(run)["step"] == 12


# the CLI's small semi run: 32x48 crops of the tree's 48x64 frames, 1 + 1
# iterations, fp32, the recipe's optimizer settings
SMALL = ["--stage", "semi-sintel_unsup_test-things_unsup", "--model_type", "raft-semi",
         "--image_size", "32", "48", "--unsup_image_size", "32", "48", "--full_size", "40", "56",
         "--iters", "1", "--teacher_iters", "1", "--compute_dtype", "float32", "--batch_size", "1",
         "--lr", "1e-4", "--lr_schedule", "exponential", "--lr_decay_steps", "3",
         "--weight_decay", "0.0", "--lfr_loss_type", "robust", "--lfl_loss_decay_rate", "1.0",
         "--val_step", "2", "--val_iters", "1", "--val_max_records", "1", "--log_every", "1",
         "--loader_workers", "2", "--seed", "3", "--device", "cpu"]


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    root = tmp_path / "datasets"
    build_synthetic_tree(root)
    monkeypatch.setenv("FST_DATA_ROOT", str(root))
    importlib.reload(ppaths)
    yield root
    monkeypatch.undo()
    importlib.reload(ppaths)


def _cli(argv):
    from flow_supervisor_tpu_torch.train import main

    assert main(argv) == 0


def _rows(run):
    import json

    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_resume_equals_an_uninterrupted_run(tree, tmp_path):
    from flow_supervisor_tpu_torch.data.pipeline import fetch_dataloader
    from flow_supervisor_tpu_torch.training.loop import build_model, make_step, train
    from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
    from flow_supervisor_tpu_torch.training.state import TrainState

    run = str(tmp_path / "run")
    _cli([run, "--num_steps", "2"] + SMALL)
    assert ckpt.checkpoint_steps(run) == [2]
    _cli([run, "--num_steps", "4", "--device", "cpu"])  # the rest from args.yaml
    assert ckpt.checkpoint_steps(run) == [2, 4]
    rows = _rows(run)
    assert [r["step"] for r in rows if r["prefix"] == "train"] == [1, 2, 3, 4]
    assert [r["step"] for r in rows if r["prefix"] == "val"] == [0, 2, 4]  # none at the resume
    assert all(np.isfinite(v) for r in rows for v in r.values() if isinstance(v, float))
    resumed = ckpt.restore_checkpoint(run, map_location="cpu")
    assert resumed["step"] == 4 and resumed["opt_state"].count == 4

    # 4 uninterrupted steps over the batches the two runs read: the stream's
    # first two, twice
    cfg = pconfig.ExperimentConfig.load_yaml(run)
    cfg.ckpt_dir = str(tmp_path / "whole")
    loader = fetch_dataloader(cfg.train)
    first = [next(loader), next(loader)]
    loader.close()
    model, state = train(cfg, iter(first + first), device="cpu", validate_fn=lambda s, st: {})
    assert state.step == 4 and state.opt_state.count == 4
    whole = model.state_dict()
    assert whole.keys() == resumed["model"].keys()
    for k, v in whole.items():
        assert torch.equal(v, resumed["model"][k]), k
    for k, v in state.opt_state.mu.items():
        assert torch.equal(v, resumed["opt_state"].mu[k]), k

    # the JAX loop's resume rule: step 2's weights, a new optimizer state
    at2 = ckpt.restore_checkpoint(run, step=2, map_location="cpu")
    model = build_model(cfg)
    model.load_state_dict(at2["model"])
    st = TrainState.create(dict(model.named_parameters()),
                           make_optimizer(cfg.train, batchnorm_params(model)))
    st.step = 2
    step = make_step(model, cfg)
    from flow_supervisor_tpu_torch.training.loop import _to

    for sup, unsup in first:
        st, _ = step(st, (_to(sup, "cpu"), _to(unsup, "cpu")))
    assert st.opt_state.count == 2
    moved = max(float((model.state_dict()[k] - whole[k]).abs().max()) for k in whole)
    assert moved > 1e-6


def test_pretrained_ckpt_transplant_and_teacher_copy(tree, tmp_path):
    from flow_supervisor_tpu_torch.training.loop import train

    base = str(tmp_path / "chairs")
    _cli([base, "--stage", "chairs", "--image_size", "32", "48", "--iters", "1", "--batch_size", "2",
          "--compute_dtype", "float32", "--num_steps", "1", "--lr", "4e-4", "--weight_decay", "1e-4",
          "--skip_validation_at_start", "true", "--val_iters", "1", "--val_max_records", "1",
          "--loader_workers", "0", "--device", "cpu"])
    pre = ckpt.restore_checkpoint(base)["model"]
    assert any(k.startswith("cnet.") and "running_mean" in k for k in pre)

    cfg = pconfig.ExperimentConfig(
        pconfig.ModelCfg(model_type="raft-semi", iters=1, teacher_iters=1, compute_dtype="float32"),
        pconfig.TrainCfg(stage="semi-sintel_unsup_test-things_unsup", pretrained_ckpt=base,
                         skip_validation_at_start=True),
        ckpt_dir=str(tmp_path / "semi"))
    model, state = train(cfg, iter([]), max_steps=0, device="cpu", validate_fn=lambda s, st: {})
    sd = model.state_dict()
    moved = [k for k in pre if k.split(".")[0] in ("fnet", "cnet", "update_block")]
    assert len(moved) == len(pre)  # a Baseline model has nothing else
    for k in moved:
        assert torch.equal(sd[k], pre[k]), k
    teacher = [k for k in sd if k.startswith("teacher_update_block.")]
    assert teacher and all(torch.equal(sd[k], pre[k[len("teacher_"):]]) for k in teacher)
    assert state.step == 0 and ckpt.latest_step(cfg.ckpt_dir) is None


GMA_SMALL = ["--stage", "semi-davis_unsup-ctskh", "--model_type", "gma-semi",
             "--image_size", "32", "48", "--unsup_image_size", "32", "48", "--full_size", "40", "56",
             "--iters", "1", "--teacher_iters", "1", "--compute_dtype", "float32",
             "--batch_size", "1", "--lr", "1e-4", "--lr_schedule", "exponential",
             "--lr_decay_steps", "25000", "--weight_decay", "0.0", "--lfr_loss_type", "robust",
             "--lfl_loss_decay_rate", "0.8", "--val_step", "2", "--val_iters", "1",
             "--val_max_records", "1", "--log_every", "1", "--loader_workers", "0", "--seed", "5",
             "--device", "cpu"]


def test_cli_trains_and_resumes_the_gma_davis_recipe(tree, tmp_path):
    """train.sh:47-53's model type and stage at 32x48: 2 steps, a checkpoint
    and standing validation at 2, then the resume to 4 from args.yaml."""
    run = str(tmp_path / "gma")
    _cli([run, "--num_steps", "2"] + GMA_SMALL)
    assert ckpt.checkpoint_steps(run) == [2]
    at2 = ckpt.restore_checkpoint(run, map_location="cpu")
    assert "att.to_qk.weight" in at2["model"]
    assert "teacher_update_block.aggregator.to_v.weight" in at2["model"]
    assert "att.to_qk.weight" in at2["opt_state"].mu  # the attention trains
    assert pconfig.ExperimentConfig.load_yaml(run).model.model_type == "gma-semi"
    _cli([run, "--num_steps", "4", "--device", "cpu"])
    assert ckpt.checkpoint_steps(run) == [2, 4]
    rows = _rows(run)
    assert [r["step"] for r in rows if r["prefix"] == "train"] == [1, 2, 3, 4]
    assert [r["step"] for r in rows if r["prefix"] == "val"] == [0, 2, 4]
    assert all(np.isfinite(v) for r in rows for v in r.values() if isinstance(v, float))
    at4 = ckpt.restore_checkpoint(run, map_location="cpu")
    assert at4["step"] == 4 and at4["opt_state"].count == 4
    assert not torch.equal(at4["model"]["att.to_qk.weight"], at2["model"]["att.to_qk.weight"])


@pytest.mark.parametrize("flags,error", [
    (["--stage", "sintel_multiframe"], ValueError),
    (["--dcn_parallel", "2"], ValueError),
], ids=["sintel_multiframe", "dcn_world_does_not_divide"])
def test_cli_refuses_before_the_first_step(tree, tmp_path, flags, error):
    from flow_supervisor_tpu_torch.train import main

    run = str(tmp_path / "run")
    with pytest.raises(error, match="frame triplets|must divide evenly over the world"):
        main([run] + SMALL + ["--num_steps", "1"] + flags)
    assert ckpt.latest_step(run) is None
    assert not os.path.exists(os.path.join(run, "metrics.jsonl"))


@pytest.mark.parametrize("steps,trace_steps", [(4, 1), (3, 3)], ids=["window", "ends_inside"])
def test_trace_dir_writes_a_profiler_trace(tmp_path, steps, trace_steps):
    """--trace_dir: a torch.profiler trace of trace_steps steps after two
    warm-up steps, also when the run ends inside the window."""
    import json

    from flow_supervisor_tpu_torch.training.loop import train

    rng = np.random.default_rng(0)
    batch = {"image1": rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32),
             "image2": rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32),
             "flow": rng.normal(0, 1, (1, 32, 48, 2)).astype(np.float32)}
    cfg = pconfig.ExperimentConfig(
        pconfig.ModelCfg(iters=1, compute_dtype="float32", lookup_backend="fused"),
        pconfig.TrainCfg(stage="things", trace_dir=str(tmp_path / "trace"), trace_steps=trace_steps,
                         skip_validation_at_start=True),
        ckpt_dir=str(tmp_path / "run"))
    train(cfg, iter([batch] * steps), max_steps=steps, device="cpu", validate_fn=lambda s, st: {})
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
