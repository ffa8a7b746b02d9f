"""The harness's own rules, on the CPU: what it imports, that it finds a
cell's parts by name, the shape of its result line, and that the
measurement path refuses to run without a card."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "flowbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "flow_supervisor_tpu"}
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def imported_tops(path: Path) -> set:
    """Top-level names (the part before the first dot) of every import."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "flow_supervisor_tpu_torch" not in tops
    assert tops <= {"__future__", "math", "contextlib", "typing", "torch", "numpy", "scipy",
                    "flowbench"}


def test_the_benchmark_file_names_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """Files and entries added to a copy are found without editing a file."""
    from flowbench import registry

    shutil.copytree(BENCH, tmp_path / "flowbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "raft.json").read_text())
    (tmp_path / "flowbench" / "configs" / "wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "infer.b32.json").read_text())
    traffic["batch"] = 4
    (tmp_path / "flowbench" / "traffic" / "infer.b4.json").write_text(json.dumps(traffic))
    (tmp_path / "flowbench" / "workloads" / "wide.infer.b4.json").write_text(
        json.dumps({"limits": {"flow_gap_rel": 0.5}}))
    (tmp_path / "flowbench" / "metrics" / "pairs_traced.infer.py").write_text(
        "def read(record):\n    return record['pairs']\n")
    bench["configs"].append({"name": "wide", "source": "s", "file": "flowbench/configs/wide.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "wide.infer.b4", "config": "wide", "traffic": "infer.b4",
                               "chips": 1, "why": "w"})
    for m in bench["end_to_end"]:
        if "raft.infer.b32" in m.get("workloads", ()):
            m["workloads"].append("wide.infer.b4")
    bench["per_layer"].append({"name": "pairs_traced.infer", "unit": "pairs", "better": "higher",
                               "source": "device_trace", "layer": "host dispatch",
                               "moves": "pairs_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.cell("wide.infer.b4", tmp_path)
    assert cell.traffic["batch"] == 4 and cell.limits == {"flow_gap_rel": 0.5}
    assert "pairs_traced.infer" in [m["name"] for m in cell.per_layer]
    assert registry.reader("pairs_traced.infer", tmp_path)({"pairs": 24}) == 24
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s", "latency_ms_p95", "setup_s"}


def test_the_result_line_has_its_keys():
    """A whole (tiny) run on the CPU: the keys of the last line, the checks last."""
    import dataclasses

    from flowbench import registry
    from flowbench.run import run_cell

    cell = registry.cell("raft.infer.b32")
    t = dict(cell.traffic, batch=1, hw=[64, 96], iters=1, pool_batches=1, check_batches=1)
    result = run_cell(dataclasses.replace(cell, traffic=t), 2 ** 31 + 7, 0.2, False, "cpu", 0.0)
    assert set(result) == RESULT_KEYS and list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"pairs_per_s", "latency_ms_p95", "setup_s"}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    json.dumps(result)


def test_without_a_card_the_run_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "flowbench.run", "--workload", "raft.infer.b32",
                           "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_measurement_path_raises_without_a_card():
    from flowbench import registry
    from flowbench.run import NoDevice, device_for

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoDevice):
        device_for(registry.cell("raft.infer.b32"))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from flowbench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "flow_supervisor_tpu_torch.models", object())
    assert "flow_supervisor_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in forbidden_modules()
