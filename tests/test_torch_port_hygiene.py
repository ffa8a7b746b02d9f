"""The port stands alone: it imports no JAX, no flax, no yaml, no cv2, no
PIL, no TensorFlow, no orbax and nothing of the JAX package (every module,
the data readers, the host I/O library's bindings, augmentors, loaders,
checkpoints and their bridges, config, the train, evaluate, extract_flow
and ckpt_tool CLIs and evaluation included), on CPU tensors its wrappers
take the plain PyTorch versions without launching (or building) any
kernel, and its entry points refuse to run without a card unless the
caller asks for the CPU."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "flow_supervisor_tpu_torch")

_CPU_FORWARD = """
import sys, json
import torch
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from flow_supervisor_tpu_torch.kernels import (
    _build, conv3x3, corr_fused, corr_lookup, corr_lookup_v2, corr_plane, norm)
import flow_supervisor_tpu_torch.evaluation, flow_supervisor_tpu_torch.extract_flow
import flow_supervisor_tpu_torch.profile_forward, flow_supervisor_tpu_torch.config
import flow_supervisor_tpu_torch.training.loop, flow_supervisor_tpu_torch.training.semi
import flow_supervisor_tpu_torch.training.unsup, flow_supervisor_tpu_torch.training.baseline
import flow_supervisor_tpu_torch.losses.unsupervised, flow_supervisor_tpu_torch.ops.warp
import flow_supervisor_tpu_torch.data.paths, flow_supervisor_tpu_torch.data.io
import flow_supervisor_tpu_torch.data.datasets, flow_supervisor_tpu_torch.data.pipeline
import flow_supervisor_tpu_torch.metrics, flow_supervisor_tpu_torch.utils.warm_start
import flow_supervisor_tpu_torch.submission, flow_supervisor_tpu_torch.data.augment
import flow_supervisor_tpu_torch.data.synthetic, flow_supervisor_tpu_torch.training.checkpoint
import flow_supervisor_tpu_torch.train, flow_supervisor_tpu_torch.evaluate
import flow_supervisor_tpu_torch.ckpt_tool, flow_supervisor_tpu_torch.tf_bundle
import flow_supervisor_tpu_torch.utils.viz, flow_supervisor_tpu_torch.data.native
import flow_supervisor_tpu_torch.convert
import flow_supervisor_tpu_torch.parallel.mesh, flow_supervisor_tpu_torch.parallel.dryrun
g = torch.Generator().manual_seed(0)
model = RAFT(RAFTConfig(iters=2, lookup_backend=BACKEND, **MODEL_KW), generator=g)
img = torch.rand(BATCH, 32, 48, 3, generator=g)
out = model(img, img.flip(1), final_flow_only=True)
print(json.dumps({
    "finite": bool(torch.isfinite(out["flow_up"]).all()),
    "shape": list(out["flow_up"].shape),
    "launches": LAUNCHES,
    "lib_loaded": _build._lib is not None,
    "leaked": LEAKED,
}))
"""
_LAUNCHES = """[corr_plane.launches, conv3x3.launches, norm.stats_launches,
    norm.apply_launches, conv3x3.bare_launches, corr_fused.all_launches,
    corr_fused.level_launches, corr_fused.bwd_df1_launches, corr_fused.bwd_df2_launches,
    corr_lookup_v2.launches, corr_lookup.launches, conv3x3.tc_launches,
    norm.vector_launches, corr_plane.bwd_launches]"""
N_KERNELS = 14  # twelve kernels' counters, the conv's tensor-core body, the norm's vector body
_LEAKED = """sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "flow_supervisor_tpu", "cv2", "optax", "orbax", "yaml", "PIL",
    "tensorflow"))"""
_CPU_FORWARD = _CPU_FORWARD.replace("LAUNCHES", _LAUNCHES).replace("LEAKED", _LEAKED)

_CPU_STEP = """
import sys, json
import numpy as np
import torch
from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg
from flow_supervisor_tpu_torch.kernels import (
    _build, conv3x3, corr_fused, corr_lookup, corr_lookup_v2, corr_plane, norm)
from flow_supervisor_tpu_torch.training.loop import train
rng = np.random.default_rng(0)
img = lambda s: rng.uniform(0, 1, s).astype(np.float32)
sup = {"image1": img((1, 32, 48, 3)), "image2": img((1, 32, 48, 3)),
       "orig_image1": img((1, 48, 64, 3)), "orig_image2": img((1, 48, 64, 3)),
       "crop_yx": np.asarray([[8, 16]]), "flow": img((1, 32, 48, 2)),
       "valid": np.ones((1, 32, 48, 1), np.float32)}
unsup = {k: v for k, v in sup.items() if k not in ("flow", "valid")}
labeled = {k: np.concatenate([v, v]) for k, v in sup.items() if k in ("image1", "image2", "flow", "valid")}
batch = ((sup, unsup) if MODEL_TYPE.endswith("semi") else unsup if MODEL_TYPE.endswith("unsup")
         else labeled)
cfg = ExperimentConfig(
    ModelCfg(model_type=MODEL_TYPE, iters=1, teacher_iters=1, compute_dtype="float32",
             lookup_backend="fused", **MODEL_KW),
    TrainCfg(stage=STAGE, log_every=1), ckpt_dir=CKPT)
model, state = train(cfg, iter([batch]), max_steps=1, device="cpu")
rows = [json.loads(l) for l in open(CKPT + "/metrics.jsonl")]
print(json.dumps({
    "step": state.step, "row": rows[-1],
    "launches": LAUNCHES,
    "lib_loaded": _build._lib is not None,
    "leaked": LEAKED,
}))
""".replace("LAUNCHES", _LAUNCHES).replace("LEAKED", _LEAKED)
# model type -> (stage, extra ModelCfg fields, the log's keys)
_STEPS = {
    "raft-semi": ("semi", {}, ["sup_label_loss", "lfl_loss", "sup_loss", "epe", "lfr_loss",
                               "unsup_loss"]),
    "raft-unsup": ("sintel_unsup", {}, ["loss", "census", "smooth1", "selfsup"]),
    "raft-baseline": ("chairs", {}, ["loss", "epe"]),
    "raft-semi-smurf": ("semi", {"teacher_smurf_weight": 1.0, "occlusion": "brox"},
                        ["sup_label_loss", "lfl_loss", "sup_loss", "epe", "teacher_smurf_loss",
                         "lfr_loss", "unsup_loss"]),
    "gma-semi": ("semi-davis_unsup-ctskh", {"num_heads": 2, "position_and_content": True},
                 ["sup_label_loss", "lfl_loss", "sup_loss", "epe", "lfr_loss", "unsup_loss"]),
    "raft-baseline-small": ("chairs", {"small": True}, ["loss", "epe"]),
}


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )


def _cpu_forward(backend: str, batch: int, model_kw: dict | None = None) -> dict:
    import json

    code = (_CPU_FORWARD.replace("BACKEND", repr(backend)).replace("BATCH", str(batch))
            .replace("MODEL_KW", repr(model_kw or {})))
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cpu_forward_imports_no_jax_and_launches_nothing():
    res = _cpu_forward("plane", 1)
    assert res["leaked"] == []
    assert res["finite"] and res["shape"] == [1, 1, 32, 48, 2]
    assert res["launches"] == [0] * N_KERNELS
    assert not res["lib_loaded"]


@pytest.mark.parametrize(
    "backend,batch",
    [("fused", 1), ("fused", 2), ("pallas", 1), ("einsum", 1), ("zero", 1), ("auto", 1)],
    ids=["fused", "fused_b2", "pallas", "einsum", "zero", "auto"],
)
def test_cpu_forward_per_lookup_backend_launches_nothing(backend, batch):
    res = _cpu_forward(backend, batch)
    assert res["leaked"] == []
    assert res["finite"] and res["shape"] == [1, batch, 32, 48, 2]
    assert res["launches"] == [0] * N_KERNELS
    assert not res["lib_loaded"]


@pytest.mark.parametrize("model_kw,backend", [
    (dict(gma=True, num_heads=2, position_and_content=True), "fused"), (dict(small=True), "plane"),
], ids=["gma_fused", "small_plane"])
def test_cpu_gma_and_small_forwards_launch_nothing(model_kw, backend):
    """GMA (its attention and aggregation are torch.matmul, no kernel) and the
    small model (every norm of its fnet an instance norm, radius 3) on the CPU:
    the plain versions, nothing launched or built, nothing of JAX imported."""
    res = _cpu_forward(backend, 1, model_kw)
    assert res["leaked"] == []
    assert res["finite"] and res["shape"] == [1, 1, 32, 48, 2]
    assert res["launches"] == [0] * N_KERNELS
    assert not res["lib_loaded"]


def _cpu_train_step(model_type: str, tmp_path) -> None:
    """One step of ``training.loop.train`` on the CPU (the fused lookup and its
    backward as plain PyTorch): finite logs in metrics.jsonl, no kernel
    launched or built, nothing of JAX, flax or yaml imported."""
    import json

    stage, extra, keys = _STEPS[model_type]
    code = (_CPU_STEP.replace("CKPT", repr(str(tmp_path)))
            .replace("MODEL_TYPE", repr(model_type.replace("-smurf", "").replace("-small", "")))
            .replace("MODEL_KW", repr(extra)).replace("STAGE", repr(stage)))
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    assert res["step"] == 1
    assert sorted(res["row"]) == sorted(keys + ["steps_per_sec", "step", "prefix"])
    for k in keys + ["steps_per_sec"]:
        assert isinstance(res["row"][k], float) and res["row"][k] == res["row"][k], k
    assert res["launches"] == [0] * N_KERNELS
    assert not res["lib_loaded"]


def test_cpu_semi_train_step_imports_no_jax_and_launches_nothing(tmp_path):
    _cpu_train_step("raft-semi", tmp_path)


@pytest.mark.parametrize("model_type", ["gma-semi", "raft-baseline-small"])
def test_cpu_gma_semi_and_small_baseline_steps_import_no_jax_and_launch_nothing(model_type,
                                                                                 tmp_path):
    """The gma-semi step (2 heads, position and content) and the small
    model's chairs Baseline step, each one step through ``training.loop.train``
    on the CPU."""
    _cpu_train_step(model_type, tmp_path)


@pytest.mark.parametrize("model_type", ["raft-unsup", "raft-baseline", "raft-semi-smurf"])
def test_cpu_unsup_baseline_and_smurf_steps_import_no_jax_and_launch_nothing(model_type, tmp_path):
    """The Unsup step (frozen batch norm), the Baseline step (chairs: unfrozen
    batch norm, B=2) and the semi step with the teacher SMURF loss, each one
    step through ``training.loop.train`` on the CPU."""
    _cpu_train_step(model_type, tmp_path)


def test_no_source_file_imports_jax():
    """No file of the port, nor chip_smoke.py, imports jax, flax, yaml, cv2,
    PIL, TensorFlow, orbax or the JAX package."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, n) for n in files
                  if n.endswith((".py", ".cu", ".cuh", ".cc"))]
    assert os.path.join(PKG, "models", "gma.py") in paths
    assert os.path.join(PKG, "native", "fst_io.cc") in paths
    offenders = []
    for path in paths:
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import jax", "from jax", "import flax", "from flax",
                                 "import yaml", "from yaml", "import cv2", "from cv2",
                                 "import PIL", "from PIL", "import tensorflow",
                                 "from tensorflow", "import orbax", "from orbax",
                                 "from flow_supervisor_tpu.", "import flow_supervisor_tpu.",
                                 "from flow_supervisor_tpu import")):
                    offenders.append(f"{path}: {s}")
    assert offenders == []


_CPU_CLI_STEP = """
import sys, json
from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree
build_synthetic_tree(ROOT)
from flow_supervisor_tpu_torch.kernels import (
    _build, conv3x3, corr_fused, corr_lookup, corr_lookup_v2, corr_plane, norm)
from flow_supervisor_tpu_torch.train import main
rc = main([CKPT, "--device", "cpu", "--stage", "semi-sintel_unsup_test-things_unsup",
           "--model_type", "raft-semi", "--lookup_backend", "fused", "--image_size", "32", "48",
           "--unsup_image_size", "32", "48", "--full_size", "40", "56", "--iters", "1",
           "--teacher_iters", "1", "--batch_size", "1", "--num_steps", "1", "--log_every", "1",
           "--skip_validation_at_start", "true", "--val_iters", "1", "--val_max_records", "1",
           "--loader_workers", "2"])
rows = [json.loads(l) for l in open(CKPT + "/metrics.jsonl")]
print(json.dumps({"rc": rc, "rows": [r["prefix"] for r in rows], "launches": LAUNCHES,
                  "lib_loaded": _build._lib is not None, "leaked": LEAKED}))
""".replace("LAUNCHES", _LAUNCHES).replace("LEAKED", _LEAKED)


def test_cpu_cli_step_imports_no_jax_and_launches_nothing(tmp_path):
    """One semi step of ``python -m flow_supervisor_tpu_torch.train --device
    cpu`` from a synthetic tree (the fused lookup, the threaded loader,
    a checkpoint, standing validation): no kernel launched or built, nothing
    of JAX, flax, yaml, cv2 or PIL imported."""
    import json

    code = (_CPU_CLI_STEP.replace("ROOT", repr(str(tmp_path / "datasets")))
            .replace("CKPT", repr(str(tmp_path / "run"))))
    env = dict(os.environ, PYTHONPATH=REPO, FST_DATA_ROOT=str(tmp_path / "datasets"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and res["rows"] == ["train", "val"]
    assert res["leaked"] == []
    assert res["launches"] == [0] * N_KERNELS
    assert not res["lib_loaded"]
    assert os.path.exists(tmp_path / "run" / "ckpt_1.pt")


def test_extract_flow_requires_a_cuda_device(tmp_path):
    proc = _run(
        "import sys; from flow_supervisor_tpu_torch.extract_flow import main; "
        f"sys.exit(main(['--source_dirs', {str(tmp_path)!r}, '--target_dirs', {str(tmp_path)!r}]))"
    )
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0
    assert "needs a CUDA device" in proc.stderr


_CLIS = {  # module -> its arguments; each also runs with --device cpu
    "evaluate": lambda d: [d, "--eval_iters", "1"],
    "extract_flow": lambda d: ["--source_dirs", d, "--target_dirs", d],
    "ckpt_tool": lambda d: ["list", d],
}


@pytest.mark.parametrize("entry", ["profile_forward", "train", "train_cli", "evaluate_cli",
                                   "extract_flow_cli", "ckpt_tool_cli"])
def test_entry_points_require_a_cuda_device(entry, tmp_path):
    """Without a card, profile_forward raises, train raises unless the
    caller passes device='cpu', and the train, evaluate, extract_flow and
    ckpt_tool CLIs exit non-zero unless given --device cpu (with it, the
    evaluate CLI fails on the empty directory's missing args.yaml, the other
    two run)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if entry == "profile_forward":
        code = ("from flow_supervisor_tpu_torch.profile_forward import main; "
                "main(['--hw', '16', '16', '--iters', '1'])")
    elif entry == "train_cli":
        code = ("import sys; from flow_supervisor_tpu_torch.train import main; "
                f"sys.exit(main([{str(tmp_path)!r}, '--num_steps', '1']))")
    elif entry.endswith("_cli"):
        module = entry[: -len("_cli")]
        args = _CLIS[module](str(tmp_path))
        code = (f"import sys; from flow_supervisor_tpu_torch.{module} import main; "
                "sys.exit(main(ARGS))")
        on_cpu = _run(code.replace("ARGS", repr(args + ["--device", "cpu"])))
        if module == "evaluate":
            assert on_cpu.returncode != 0 and "args.yaml" in on_cpu.stderr
        else:
            assert on_cpu.returncode == 0, on_cpu.stderr
        code = code.replace("ARGS", repr(args))
    else:
        code = ("from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg; "
                "from flow_supervisor_tpu_torch.training.loop import train; "
                "train(ExperimentConfig(ModelCfg(model_type='raft-semi', lookup_backend='fused'), "
                f"ckpt_dir={str(tmp_path)!r}), iter([]), max_steps=1)")
    proc = _run(code)
    assert proc.returncode != 0
    assert "needs a CUDA device" in proc.stderr


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], capture_output=True,
        text=True, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
