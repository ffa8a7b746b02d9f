"""Per-layer metric readers, one file a metric, named as the metric in
BENCHMARK.json: ``read(record) -> float | None`` over the traced run's
record (flowbench/trace.py, the runners' ``profile`` and run.py). A reader
that finds nothing to read returns None, and the run leaves the metric out.

The record's ``work`` is the profiled pass's units (pairs or steps),
``window_work`` and ``window_s`` the measured window's units and seconds.
A share of the window's time takes the profiled pass's device seconds a
unit against the window's seconds a unit: the profiler's own host cost
stretches the profiled pass, never the window.
"""
from __future__ import annotations

from flowbench.counts.lookup import PEAKS


def window_s_per_unit(record) -> float:
    return record["window_s"] / record["window_work"]


def mfu(record, unit: str):
    """The model FLOPs of a unit at the window's pace over the card's peak
    for the cell's precision, in %."""
    if record.get("unit") != unit:
        return None
    flops_per_unit = record["flops"] / record["work"]
    peak = PEAKS["ops_per_s"][record["dtype"]]
    return 100.0 * flops_per_unit / (window_s_per_unit(record) * peak)


def idle_share(record, unit: str):
    """Share of the window in which no operation ran on the card, in %: one
    minus the profiled device seconds a unit over the window's seconds a
    unit."""
    if record.get("unit") != unit:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["work"] / window_s_per_unit(record))


def launches(record, unit: str):
    """Kernel launches (copies not counted) a unit."""
    if record.get("unit") != unit:
        return None
    return record["launches"] / record["work"]


def device_ms(record, unit: str, categories, silent_at_zero: bool = False):
    """Device ms a unit in kernels of ``categories``."""
    from flowbench.trace import seconds_in

    if record.get("unit") != unit:
        return None
    seconds = seconds_in(record, categories)
    if silent_at_zero and seconds <= 0:
        return None
    return 1e3 * seconds / record["work"]


def roofline(record, unit: str, key: str):
    """The least time of the work under ``key`` over its kernels' device
    time, in %; nothing where no such kernel ran or where the kernels' own
    launch counters disagree with the trace."""
    from flowbench.trace import seconds_in

    lk = record.get(key)
    if record.get("unit") != unit or lk is None or not lk.get("counters_agree", True):
        return None
    seconds = seconds_in(record, lk["categories"])
    return 100.0 * lk["least_s"] / seconds if seconds > 0 else None
