"""flowbench/spans.py on hand-built profiler events: inclusive filing by
launch time, from another thread by time, idle gaps by their middle, and the
traced pass's record left as the runner made it."""
from __future__ import annotations

import copy
import types

import pytest
import torch

from flowbench import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, thread=1):
    return types.SimpleNamespace(name=name, device_type=device, id=id, thread=thread,
                                 time_range=types.SimpleNamespace(start=start, end=end))


# us on the profiler's clock. Thread 1 runs a forward with two update
# blocks and a lookup; thread 2 (autograd's) launches a backward kernel
# while thread 1's backward span is open.
EVENTS = [
    ev("fst.forward", 0, 100), ev("fst.update", 10, 20), ev("fst.lookup", 21, 29),
    ev("fst.update", 30, 40), ev("fst.train.backward", 200, 300),
    ev("aten::cat", 11, 13), ev("cudaLaunchKernel", 12, 13, id=7),
    ev("cudaLaunchKernel", 22, 23, id=8), ev("cudaMemcpyAsync", 31, 32, id=9),
    ev("cudaLaunchKernel", 50, 51, id=10), ev("cudaLaunchKernel", 250, 251, id=11, thread=2),
    ev("aten::mm", 251, 252, id=11, thread=2),  # an op's id: another id space, not a launch
    ev("CatArrayBatchedCopy", 60, 64, CUDA, id=7),
    ev("corr_fused_level_kernel", 64, 70, CUDA, id=8),
    ev("Memcpy HtoD (Pageable -> Device)", 70, 71, CUDA, id=9),
    ev("elementwise_kernel", 71, 80, CUDA, id=10),
    ev("bwd_df2_kernel", 400, 410, CUDA, id=11),
    ev("empty", 90, 90, CUDA, id=12),  # zero length: not a device operation (trace.py)
]


def test_each_operation_is_filed_under_every_span_open_at_its_launch():
    got = spans.reduce(EVENTS)
    assert set(got) == {"fst.forward", "fst.update", "fst.lookup", "fst.train.backward"}
    fwd, upd, look = got["fst.forward"], got["fst.update"], got["fst.lookup"]
    assert fwd["device_s"] == pytest.approx(20e-6) and fwd["launches"] == 3
    assert fwd["copy_s"] == pytest.approx(1e-6)
    assert upd["device_s"] == pytest.approx(5e-6) and upd["launches"] == 1
    assert upd["copy_s"] == pytest.approx(1e-6) and upd["calls"] == 2
    assert upd["host_s"] == pytest.approx(20e-6)
    assert look["device_s"] == pytest.approx(6e-6) and look["other_s"] == 0.0
    # "other": the cat and the elementwise kernel, not K7 and not the copy
    assert fwd["other_s"] == pytest.approx(13e-6)
    assert {k: v["parent"] for k, v in got.items()} == {
        "fst.forward": None, "fst.update": "fst.forward", "fst.lookup": "fst.forward",
        "fst.train.backward": None}


def test_a_launch_from_another_thread_is_filed_by_time():
    back = spans.reduce(EVENTS)["fst.train.backward"]
    assert back["device_s"] == pytest.approx(10e-6) and back["launches"] == 1


def test_idle_gaps_go_to_the_spans_that_hold_their_middle():
    got = spans.reduce(EVENTS)
    # gaps between device operations: (80, 400), middle 240, inside the backward
    assert got["fst.train.backward"]["idle_s"] == pytest.approx(320e-6)
    assert got["fst.forward"]["idle_s"] == 0.0
    shifted = EVENTS + [ev("fst.eval.pad", 230, 260, thread=3)]
    assert spans.reduce(shifted)["fst.eval.pad"]["idle_s"] == pytest.approx(320e-6)


def test_a_names_ranges_are_merged_so_an_operation_counts_once():
    two = EVENTS + [ev("fst.update", 11, 14, thread=2)]  # overlaps thread 1's first update
    assert spans.reduce(two)["fst.update"]["device_s"] == pytest.approx(5e-6)


def test_a_program_without_spans_gives_none():
    assert spans.reduce([e for e in EVENTS if not e.name.startswith("fst.")]) == {}


def test_innermost_files_each_kernel_under_the_last_span_opened():
    got = spans.innermost(EVENTS)
    assert got["CatArrayBatchedCopy"] == {"fst.update": pytest.approx(4e-6)}
    assert got["corr_fused_level_kernel"] == {"fst.lookup": pytest.approx(6e-6)}
    assert got["elementwise_kernel"] == {"fst.forward": pytest.approx(9e-6)}
    assert got["bwd_df2_kernel"] == {"fst.train.backward": pytest.approx(10e-6)}


class _Run:
    """A runner whose traced pass profiles a unit that opens a span, on the CPU."""

    def profile(self):
        from torch._C._profiler import _RecordFunctionFast
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with _RecordFunctionFast("fst.forward"):
                torch.ones(4).sum()
        ops = [(e.name, 1e-6, trace.category(e.name)) for e in prof.events()]
        return {"unit": "pair", "work": 1, "ops": ops, "launches": 0, "busy_s": 0.0,
                "profiled_s": 1.0, "breakdown": {"idle_gaps": []}}


def test_the_traced_pass_keeps_the_runners_record_as_it_made_it():
    run = _Run()
    record, events = spans.traced(run)
    assert set(record) == set(run.profile()) and record["launches"] == 0
    assert [e.name for e in events if e.name.startswith("fst.")] == ["fst.forward"]
    record.update(window_s=2.0, window_work=4)
    before = copy.deepcopy(record)
    out = spans.summary(record, events)
    assert record == before
    assert out["spans_per_unit"]["fst.forward"]["calls"] == 1
    assert out["window_s_per_unit"] == 0.5
