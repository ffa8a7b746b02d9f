"""The program's spans in a profiled pass: for each ``fst.*`` range that
the port opens (flow_supervisor_tpu_torch/tracing.py), what ran on the card
while it was open.

``reduce(events)`` takes a ``torch.profiler`` pass's events and gives, by
span name:

- ``calls`` and ``host_s`` (the ranges' host seconds), and ``parent``: the
  name of the innermost span that holds it on its thread, most often;
- ``device_s``, ``copy_s`` and ``launches``, inclusive: each device
  operation is filed under every span open when its runtime call ran
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...: the call and the
  operation share a correlation id). Spans match by time, not by thread:
  autograd launches the backward's kernels from a thread of its own. A
  name's ranges are merged first, so an operation counts once under it.
  ``other_s``: the kernels of ``device_s`` in the "other" category of
  categories.json;
- ``idle_s``: the gaps between device operations (trace.py's gaps) whose
  middle falls inside the span.

Device operations are those trace.py takes (every CUDA event of non-zero
length), so the spans' totals add up against the record's.

    python -m flowbench.spans --workload <cell> --seed <n> --seconds <s> [--out f.json]

runs a cell's window and its traced pass as ``run.py --trace 1`` does, and
prints one JSON object: the per-layer metrics of the record, its totals a
unit, each span's numbers a unit, and the device ms a unit of the largest
kernels by the innermost span open at their launch. A program without
spans (one older than its tracing module) gives an empty ``spans``.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import itertools
import json
import sys
from unittest import mock

import torch

from flowbench import trace

PREFIX = "fst."
_CUDA = torch.autograd.DeviceType.CUDA


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _split(events):
    """-> (device ops [(start, end, name, id)] as trace.py takes them,
    launch times by correlation id, span ranges [(start, end, name, thread)])."""
    dev, launched, ranges = [], {}, []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == _CUDA:
            if t > s:
                dev.append((s, t, e.name, e.id))
        elif e.name.startswith(PREFIX):
            ranges.append((s, t, e.name, e.thread))
        elif e.name.startswith("cu"):
            launched[e.id] = s
    return dev, launched, ranges


def _parents(ranges) -> dict:
    """The most common enclosing span name of each span name, on its thread."""
    seen = collections.defaultdict(collections.Counter)
    by_thread = collections.defaultdict(list)
    for r in ranges:
        by_thread[r[3]].append(r)
    for rs in by_thread.values():
        stack = []
        for s, e, name, _ in sorted(rs, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][1] < e:
                stack.pop()
            seen[name][stack[-1][2] if stack else None] += 1
            stack.append((s, e, name))
    return {name: c.most_common(1)[0][0] for name, c in seen.items()}


def reduce(events, category=trace.category) -> dict:
    """{span name: {calls, host_s, parent, device_s, copy_s, launches,
    other_s, idle_s}} of a profiler's events (module docstring)."""
    dev, launched, ranges = _split(events)
    if not ranges:
        return {}
    ops = sorted((launched[i], (e - s) * 1e-6, name) for s, e, name, i in dev if i in launched)
    at = [op[0] for op in ops]

    def prefix(values):
        return [0.0, *itertools.accumulate(values)]

    cum = {
        "device_s": prefix(sec for _, sec, _ in ops),
        "copy_s": prefix(sec if trace.is_copy(n) else 0.0 for _, sec, n in ops),
        "launches": prefix(0 if trace.is_copy(n) else 1 for _, _, n in ops),
        "other_s": prefix(sec if not trace.is_copy(n) and category(n) == trace.OTHER else 0.0
                          for _, sec, n in ops),
    }
    busy = _merged((s, e) for s, e, _, _ in dev)
    gaps = sorted((0.5 * (a[1] + b[0]), (b[0] - a[1]) * 1e-6)
                  for a, b in zip(busy, busy[1:]) if b[0] > a[1])
    mids, idle = [g[0] for g in gaps], prefix(g[1] for g in gaps)
    parents = _parents(ranges)
    by_name = collections.defaultdict(list)
    for s, e, name, _ in ranges:
        by_name[name].append((s, e))
    out = {}
    for name, rs in sorted(by_name.items()):
        row = {"calls": len(rs), "host_s": sum(e - s for s, e in rs) * 1e-6,
               "parent": parents[name]}
        merged = _merged(rs)
        for key, c in cum.items():
            row[key] = sum(c[bisect.bisect_right(at, e)] - c[bisect.bisect_left(at, s)]
                           for s, e in merged)
        row["idle_s"] = sum(idle[bisect.bisect_right(mids, e)] - idle[bisect.bisect_left(mids, s)]
                            for s, e in merged)
        out[name] = row
    return out


def innermost(events, top: int = 10) -> dict:
    """Device seconds of the ``top`` largest kernel names by the innermost
    span open at their launch (the open range that started last, any
    thread): {kernel name: {span name or None: seconds}}."""
    dev, launched, ranges = _split(events)
    total = collections.Counter()
    for s, e, name, _ in dev:
        if not trace.is_copy(name):
            total[name] += (e - s) * 1e-6
    names = {n for n, _ in total.most_common(top)}
    ranges.sort()
    starts = [r[0] for r in ranges]
    out = {n: collections.Counter() for n in names}
    for s, e, name, i in dev:
        if name not in names:
            continue
        t, where = launched.get(i), None
        if t is not None:
            for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                if ranges[j][1] >= t:
                    where = ranges[j][2]
                    break
        out[name][where] += (e - s) * 1e-6
    return {n: dict(out[n]) for n in sorted(names, key=lambda n: -total[n])}


def traced(run):
    """The runner's traced pass, ``run.profile()`` as run.py takes it ->
    (its record, unchanged; the profiler's events)."""
    caught = []

    class Catching(torch.profiler.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            caught.append(self)
            return out

    with mock.patch.object(torch.profiler, "profile", Catching):
        record = run.profile()
    return record, caught[-1].events()


def summary(record: dict, events, per_layer=()) -> dict:
    """The numbers ``main`` prints, a unit of the record's work."""
    from flowbench import registry

    n = record["work"]
    spans = reduce(events)
    kernel_s = sum(sec for name, sec, _ in record["ops"] if not trace.is_copy(name))
    per_unit = {name: {k: v if k == "parent" else v / n for k, v in row.items()}
                for name, row in spans.items()}
    return {
        "unit": record["unit"], "units": n,
        "metrics": {m["name"]: registry.reader(m["name"])(record) for m in per_layer},
        "window_s_per_unit": record["window_s"] / record["window_work"],
        "profiled_s_per_unit": record["profiled_s"] / n,
        "busy_s_per_unit": record["busy_s"] / n,
        "kernel_s_per_unit": kernel_s / n,
        "launches_per_unit": record["launches"] / n,
        "idle_gaps": record["breakdown"]["idle_gaps"],
        "spans_per_unit": per_unit,
        "innermost_s_per_unit": {k: {str(w): s / n for w, s in v.items()}
                                 for k, v in innermost(events).items()},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None, help="also write the object to this file")
    args = p.parse_args(argv)

    from flowbench import registry
    from flowbench.run import NoDevice, device_for

    torch.set_num_threads(2)
    cell = registry.cell(args.workload)
    try:
        device = device_for(cell)
    except NoDevice as e:
        print(f"flowbench.spans: {e}", file=sys.stderr)
        return 2
    run = registry.runner(cell.traffic["runner"]).Run(cell, args.seed, device)
    window = run.window(args.seconds)
    record, events = traced(run)
    record.update(window_s=window["seconds"], window_work=window["attempted"])
    out = {"cell": cell.name, "gpu": torch.cuda.get_device_name(device),
           "window": window["metrics"], **summary(record, events, cell.per_layer)}
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
