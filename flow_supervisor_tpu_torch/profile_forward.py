"""Where the time of one RAFT inference forward goes, on the GPU.

    python -m flow_supervisor_tpu_torch.profile_forward [--hw 448 1024] [--iters 12]
        [--batch 1] [--dtype bfloat16] [--lookup_backend plane|fused|pallas]
        [--trace out.json]

Prints one JSON object: the forward's time (CUDA events), and a
torch.profiler summary of a few whole forwards: device time by kernel, by
category and by span (``span_ms_per_forward``: the device ms of each
``fst.*`` span of tracing.py, inclusive of the spans inside it), and the
share of the window in which the device ran no kernel. Weights are random
from a seed. A CUDA device is required.
"""
from __future__ import annotations

import argparse
import bisect
import itertools
import json

import torch

from flow_supervisor_tpu_torch.models.raft import LOOKUP_BACKENDS, RAFT, RAFTConfig
from flow_supervisor_tpu_torch.tracing import SPANS

# substrings of kernel names -> category (first match wins)
CATEGORIES = (
    # K1 (plane), K10 (pallas) and K11 run one body, csrc/window.cuh's
    ("K1 / K10 / K11 window lookup", ("window_kernel",)),
    ("K12 plane lookup backward", ("plane_bwd_kernel",)),
    ("K6 corr_fused_all", ("corr_fused_all_kernel",)),
    ("K7 corr_fused_level", ("corr_fused_level_kernel",)),
    ("K8 bwd_df1", ("bwd_df1_kernel",)),
    ("K9 bwd_df2", ("bwd_df2_kernel",)),
    # both bodies of csrc/conv3x3.cu and K2's statistics finalize (in
    # csrc/norm.cu); before cuDNN's, whose keys match "conv"
    ("K2 conv3x3_stats / K5 conv3x3", ("conv3x3_kernel", "conv3x3_tc_kernel",
                                       "stats_finalize_kernel")),
    ("K3/K4 instance norm", ("norm_stats_kernel", "norm_apply_kernel")),
    ("cuDNN conv", ("fprop", "conv", "implicit", "winograd", "cudnn")),
    ("matmul", ("gemm", "cutlass")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other (elementwise, copies, reductions)"


def _events_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def span_device_us(events, device_ops) -> dict[str, float]:
    """Device us under each span of ``SPANS`` in a profiler's ``events``:
    each of ``device_ops`` is filed under every span open when its runtime
    call ran (``cudaLaunchKernel`` and the like, whose event shares the
    operation's correlation id), each span's open intervals merged first."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    launched = {e.id: e.time_range.start for e in cpu if e.name.startswith("cu")}
    ops = sorted((launched[e.id], e.device_time) for e in device_ops if e.id in launched)
    at = [t for t, _ in ops]
    cum = [0.0, *itertools.accumulate(us for _, us in ops)]
    opened: dict[str, list] = {}
    for e in cpu:
        if e.name in SPANS:
            opened.setdefault(e.name, []).append([e.time_range.start, e.time_range.end])
    out = {}
    for name, spans in opened.items():
        spans.sort()
        merged = [spans[0]]
        for s, e in spans[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        out[name] = sum(cum[bisect.bisect_right(at, e)] - cum[bisect.bisect_left(at, s)]
                        for s, e in merged)
    return out


def profile(fn, n: int = 3, trace: str | None = None) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time > 0
    ]
    if not kernels:
        return {"error": "the profiler recorded no device time"}
    by_name: dict[str, float] = {}
    by_cat: dict[str, float] = {}
    launches_by_cat: dict[str, int] = {}
    spans = []
    for e in kernels:
        us = e.device_time
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        launches_by_cat[cat] = launches_by_cat.get(cat, 0) + 1
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    by_span = span_device_us(prof.events(), kernels)
    return {
        "forwards": n,
        "device_ms_per_forward": total / 1000.0 / n,
        "window_ms_per_forward": window / 1000.0 / n,
        "device_idle_share": 1.0 - busy / window,
        "launches_per_forward": len(kernels) / n,
        "by_category_ms_per_forward": {
            k: v / 1000.0 / n for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])
        },
        "launches_by_category_per_forward": {
            k: launches_by_cat[k] / n for k in sorted(by_cat, key=lambda k: -by_cat[k])
        },
        "top_kernels_ms_per_forward": [[k[:120], v / 1000.0 / n] for k, v in top],
        "span_ms_per_forward": {k: by_span[k] / 1000.0 / n for k in SPANS if k in by_span},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hw", type=int, nargs=2, default=(448, 1024))
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--lookup_backend", default="plane", choices=LOOKUP_BACKENDS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default=None, help="write a chrome trace here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_forward needs a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator().manual_seed(args.seed)
    cfg = RAFTConfig(iters=args.iters, dtype=dtype, corr_dtype=dtype,
                     lookup_backend=args.lookup_backend)
    model = RAFT(cfg, generator=gen)
    model.to(dev)
    img1 = torch.rand(args.batch, *args.hw, 3, generator=gen).to(dev)
    img2 = torch.rand(args.batch, *args.hw, 3, generator=gen).to(dev)

    def forward():
        return model(img1, img2, final_flow_only=True)

    for _ in range(3):
        forward()
    fwd = sum(_events_ms(forward) for _ in range(10)) / 10
    out = {
        "gpu": torch.cuda.get_device_name(0), "hw": list(args.hw), "batch": args.batch,
        "iters": args.iters, "dtype": args.dtype, "lookup_backend": args.lookup_backend,
        "fwd_ms": fwd, "profile": profile(forward, trace=args.trace),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
