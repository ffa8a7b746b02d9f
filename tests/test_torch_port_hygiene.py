"""The port stands alone: it imports no JAX, no flax and nothing of the JAX
package, and on CPU tensors its wrappers take the plain PyTorch versions
without launching (or building) any kernel."""
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
from flow_supervisor_tpu_torch.kernels import _build, conv3x3, corr_plane, norm
import flow_supervisor_tpu_torch.evaluation, flow_supervisor_tpu_torch.extract_flow
g = torch.Generator().manual_seed(0)
model = RAFT(RAFTConfig(iters=2), generator=g)
img = torch.rand(1, 32, 48, 3, generator=g)
out = model(img, img.flip(1), final_flow_only=True)
print(json.dumps({
    "finite": bool(torch.isfinite(out["flow_up"]).all()),
    "shape": list(out["flow_up"].shape),
    "launches": [corr_plane.launches, conv3x3.launches, norm.stats_launches,
                 norm.apply_launches],
    "lib_loaded": _build._lib is not None,
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "flow_supervisor_tpu", "cv2",
                                            "optax", "orbax", "yaml")),
}))
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )


def test_cpu_forward_imports_no_jax_and_launches_nothing():
    import json

    proc = _run(_CPU_FORWARD)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    assert res["finite"] and res["shape"] == [1, 1, 32, 48, 2]
    assert res["launches"] == [0, 0, 0, 0]
    assert not res["lib_loaded"]


def test_no_source_file_imports_jax():
    offenders = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                with open(path) as f:
                    for line in f:
                        s = line.strip()
                        if s.startswith(("import jax", "from jax", "import flax", "from flax",
                                         "from flow_supervisor_tpu.", "import flow_supervisor_tpu.")):
                            offenders.append(f"{path}: {s}")
    assert offenders == []


def test_extract_flow_requires_a_cuda_device(tmp_path):
    proc = _run(
        "from flow_supervisor_tpu_torch.extract_flow import main; "
        f"main(['--source_dir', {str(tmp_path)!r}, '--target_dir', {str(tmp_path)!r}])"
    )
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
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
