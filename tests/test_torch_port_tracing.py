"""The port's spans (flow_supervisor_tpu_torch/tracing.py) on the CPU: each
``fst.*`` span of a RAFT and a GMA forward, an Evaluator pair and a Baseline
step appears in a profiler run, nested as documented, with names only from
``SPANS``; with no profiler a span is its name's shared no-op and the
outputs are the traced run's bit for bit; the Evaluator's host timers."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flow_supervisor_tpu_torch import evaluation, tracing
from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg
from flow_supervisor_tpu_torch.data.datasets import FlowRecord
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from flow_supervisor_tpu_torch.profile_forward import span_device_us
from flow_supervisor_tpu_torch.tracing import SPANS, span
from flow_supervisor_tpu_torch.training.loop import train

HW = (64, 64)
MODEL = ("fst.features", "fst.context", "fst.build_corr", "fst.attention", "fst.lookup",
         "fst.update", "fst.upsample")


def _model(gma=False, teacher=False) -> RAFT:
    cfg = RAFTConfig(iters=2, lookup_backend="einsum", gma=gma, teacher=teacher,
                     teacher_iters=2)
    return RAFT(cfg, generator=torch.Generator().manual_seed(3))


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (*HW, 3)).astype(np.float32) for _ in range(2)]


def _traced(fn):
    """fn()'s result and {span name: (calls, {enclosing span names})} of a
    CPU profiler run of it, and every fst.* event."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    seen, fst = {}, []
    for e in prof.events():
        if not e.name.startswith("fst."):
            continue
        fst.append(e)
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("fst."):
            parent = parent.cpu_parent
        calls, parents = seen.get(e.name, (0, set()))
        seen[e.name] = (calls + 1, parents | {None if parent is None else parent.name})
    return out, seen, fst


def _nesting(seen) -> dict:
    return {name: parents for name, (_, parents) in seen.items()}


@pytest.mark.parametrize("gma", [False, True], ids=["raft", "gma"])
def test_forward_spans_nest_as_documented_and_change_nothing(gma):
    model = _model(gma)
    img1, img2 = (torch.from_numpy(x)[None] for x in _pair())
    forward = lambda: model(img1, img2, final_flow_only=True)  # noqa: E731
    plain = forward()
    traced, seen, events = _traced(forward)
    want = {"fst.forward": {None}, **{n: {"fst.forward"} for n in MODEL}}
    if gma:
        want["fst.aggregate"] = {"fst.update"}
    assert _nesting(seen) == want
    assert seen["fst.lookup"][0] == seen["fst.update"][0] == 2 and seen["fst.upsample"][0] == 1
    assert len(events) == 6 + 2 * (3 if gma else 2)  # 30 / 42 a forward at 12 iterations
    # function-scope ranges: the profiler copies no user annotation to the device
    assert not any(e.is_user_annotation for e in events)
    for k in ("flow_up", "flow_low"):
        assert torch.equal(plain[k], traced[k])


def _records(monkeypatch, n=2):
    frames = [_pair(seed) for seed in range(n)]
    gt = np.zeros((*HW, 2), np.float32), np.ones((*HW, 1), np.float32)
    monkeypatch.setattr(evaluation, "load_record",
                        lambda rec: (*frames[int(rec.images[0])], *gt))
    return [FlowRecord(images=(str(i), str(i)), extra=("scene",)) for i in range(n)]


def test_evaluator_pair_spans_and_its_host_timers(monkeypatch):
    model = _model(teacher=True)
    records = _records(monkeypatch)
    ev = evaluation.Evaluator(model, iters=2, use_teacher=True)
    plain = ev.evaluate(records, warm_start=True)
    traced, seen, _ = _traced(lambda: ev.evaluate(records, warm_start=True))
    want = {n: {None} for n in ("fst.eval.decode", "fst.eval.pad", "fst.eval.forward",
                                "fst.eval.fetch", "fst.warm_start")}
    want.update({n: {"fst.eval.forward"} for n in MODEL})
    assert _nesting(seen) == want
    assert seen["fst.eval.forward"][0] == 2 and seen["fst.warm_start"][0] == 1
    assert seen["fst.update"][0] == 2 * (2 + 2)  # the student's and the teacher's iterations
    timers = {"decode_ms_per_pair", "warm_start_ms_per_pair", "forward_ms_per_pair"}
    for out in (plain, traced):
        assert timers <= set(out) and all(out[k] > 0 for k in timers)
        assert not {"pad_ms_per_pair", "fetch_ms_per_pair"} & set(out)
    for k in set(plain) - timers - {"pairs_per_sec"}:
        assert plain[k] == traced[k], k


def test_baseline_step_spans(tmp_path):
    rng = np.random.default_rng(1)
    img = lambda *s: rng.uniform(0, 1, s).astype(np.float32)  # noqa: E731
    batch = {"image1": img(1, 32, 48, 3), "image2": img(1, 32, 48, 3),
             "flow": img(1, 32, 48, 2), "valid": np.ones((1, 32, 48, 1), np.float32)}
    cfg = ExperimentConfig(
        ModelCfg(model_type="raft-baseline", iters=1, compute_dtype="float32",
                 lookup_backend="einsum"),
        TrainCfg(stage="chairs", log_every=1, skip_validation_at_start=True),
        ckpt_dir=str(tmp_path))
    _, seen, _ = _traced(lambda: train(cfg, iter([batch]), max_steps=1, device="cpu",
                                       validate_fn=lambda step, state: {}))
    want = {n: {None} for n in ("fst.train.h2d", "fst.train.forward", "fst.train.loss",
                                "fst.train.backward", "fst.train.optimizer")}
    want["fst.forward"] = {"fst.train.forward"}
    want.update({n: {"fst.forward"} for n in MODEL})
    assert _nesting(seen) == want


def test_off_a_span_is_its_names_shared_no_op():
    for name in SPANS:
        assert name.startswith("fst.")
        assert span(name) is span(name) is tracing._OFF[name]
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("fst.update") is not tracing._OFF["fst.update"]
    with pytest.raises(ValueError):
        span("fst.nowhere")


def test_host_seconds_go_under_the_short_name_and_decorators_open_the_span():
    host = {}
    with span("fst.eval.pad", host):
        pass
    with span("fst.eval.pad", host):
        pass
    with span("fst.warm_start", host):
        pass
    assert set(host) == {"pad", "warm_start"} and all(v > 0 for v in host.values())

    @span("fst.lookup")
    def f(x):
        return x + 1

    assert f(1) == 2
    _, seen, _ = _traced(lambda: f(2))
    assert seen == {"fst.lookup": (1, {None})}


def test_span_device_time_files_each_operation_under_every_open_span():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, start, end, dev=cpu, id=0, us=0.0):
        return types.SimpleNamespace(name=name, device_type=dev, id=id, device_time=us,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    events = [ev("fst.forward", 0, 100), ev("fst.update", 10, 20), ev("fst.update", 30, 40),
              ev("cudaLaunchKernel", 12, 13, id=7), ev("cudaLaunchKernel", 50, 51, id=8),
              ev("aten::add", 31, 32, id=8)]  # an op's id in another id space
    ops = [ev("k", 60, 64, cuda, id=7, us=4.0), ev("k", 64, 70, cuda, id=8, us=6.0)]
    assert span_device_us(events + ops, ops) == {"fst.forward": 10.0, "fst.update": 4.0}
