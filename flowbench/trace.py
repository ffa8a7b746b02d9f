"""The traced pass: ``torch.profiler`` over a few units of work (batches,
pairs or steps) after the measured window, reduced to what the per-layer
readers and the result's ``breakdown`` take.

- device operations: every kernel, copy and memset the profiler saw on the
  card, by name, with its category (``categories.json``);
- busy seconds: the union of their intervals; the profiled seconds: the
  host clock from the first unit's dispatch to the last one's completion,
  which the profiler's own host cost stretches (the readers take the
  measured window's pace instead: flowbench/metrics/__init__.py);
- idle gaps: the intervals between device operations, each put down to the
  innermost host operation running at its middle ("python" where none).
"""
from __future__ import annotations

import bisect
import json
import time
from pathlib import Path

import torch

_CAT = json.loads((Path(__file__).resolve().parent / "categories.json").read_text())
OTHER = _CAT["other"]


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CAT["categories"]:
        if any(k.lower() in low for k in keys):
            return cat
    return OTHER


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(spans):
    spans = sorted(spans)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_of_gaps(cpu, gaps, scan: int = 4000):
    """Seconds of idle device time by the innermost host op containing each
    gap's middle; cpu: (start, end, name) sorted by start, in us."""
    starts = [c[0] for c in cpu]
    by = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        best, best_len = "python", float("inf")
        for j in range(i, max(i - scan, -1), -1):
            cs, ce, name = cpu[j]
            if ce >= mid and ce - cs < best_len:
                best, best_len = name, ce - cs
        by[best] = by.get(best, 0.0) + (e - s) * 1e-6
    return by


def profile(unit_fn, units: int, device) -> dict:
    """Run ``unit_fn()`` ``units`` times under the profiler, then wait for
    the card -> the record the readers read: units, profiled_s, busy_s, ops
    [(name, seconds, category)], launches (kernels, not copies), breakdown."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize(device)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            unit_fn()
        torch.cuda.synchronize(device)
        profiled_s = time.perf_counter() - t0
    dev, cpu = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.time_range.end > e.time_range.start:
                dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.time_range.end > e.time_range.start:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    merged = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    cpu.sort()
    idle = _host_of_gaps(cpu, sorted(gaps, key=lambda g: g[0] - g[1])[:400])
    ops, by_name = [], {}
    for s, e, name in dev:
        sec = (e - s) * 1e-6
        ops.append((name, sec, category(name)))
        by_name[name] = by_name.get(name, 0.0) + sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "units": units, "profiled_s": profiled_s, "busy_s": busy_s, "ops": ops,
        "launches": sum(1 for name, _, _ in ops if not is_copy(name)),
        "breakdown": {
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def seconds_in(record: dict, categories) -> float:
    """Device seconds of the record's operations in any of ``categories``."""
    return sum(sec for _, sec, cat in record["ops"] if cat in categories)
