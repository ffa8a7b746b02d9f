"""Finds a cell's parts by name: ``BENCHMARK.json`` at the checkout's root
names each cell's configuration and traffic; the files are
``flowbench/configs/<config>.json``, ``flowbench/traffic/<traffic>.json``
(whose ``runner`` names ``flowbench/runners/<runner>.py``),
``flowbench/workloads/<cell>.json`` (the cell's correctness limits) and
``flowbench/metrics/<metric>.py`` (a per-layer metric's reader)."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with ``workloads`` is reported in those cells; one without,
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT, entry: dict | None = None) -> Cell:
    """The cell ``name`` of root/BENCHMARK.json with its files; ``entry``, a
    workloads entry, builds a cell that the file does not list (it reports
    only the metrics that every cell reports)."""
    bench = benchmark(root)
    if entry is None:
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    here = root / "flowbench"
    config = _json(here / "configs" / f"{entry['config']}.json")
    traffic = _json(here / "traffic" / f"{entry['traffic']}.json")
    limits = _json(here / "workloads" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, entry["chips"], config, traffic, limits, e2e, per_layer)


def runner(name: str):
    return importlib.import_module(f"flowbench.runners.{name}")


def reader(metric: str, root: Path = ROOT):
    """The ``read(record)`` function of flowbench/metrics/<metric>.py."""
    path = root / "flowbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"flowbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
