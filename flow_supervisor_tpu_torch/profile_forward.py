"""Where the time of one RAFT inference forward goes, on the GPU.

    python -m flow_supervisor_tpu_torch.profile_forward [--hw 448 1024] [--iters 12]
        [--batch 1] [--dtype bfloat16] [--lookup_backend plane|fused|pallas]
        [--trace out.json]

Prints one JSON object: the forward's time split by stage (CUDA events
around fnet, the correlation build, cnet, and the refinement loop with its
final upsample, each run as the forward runs it), and a torch.profiler summary of
a few whole forwards: device time by kernel and by category, and the share
of the window in which the device ran no kernel. Weights are random from a
seed. A CUDA device is required.
"""
from __future__ import annotations

import argparse
import json

import torch

from flow_supervisor_tpu_torch.models.raft import LOOKUP_BACKENDS, RAFT, RAFTConfig
from flow_supervisor_tpu_torch.ops.coords import coords_grid, downsample_shape

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


def stage_times(model: RAFT, img1, img2, iters: int, reps: int = 5) -> dict[str, float]:
    """Mean ms of each forward stage, timed one stage at a time."""
    b, h, w, _ = img1.shape
    h8, w8 = downsample_shape(h), downsample_shape(w)
    acc: dict[str, float] = {}
    for _ in range(reps):
        st: dict = {}
        t = {
            "fnet": _events_ms(lambda: st.update(f=model.features(img1, img2))),
            "corr_build": _events_ms(lambda: st.update(p=model.build_corr(*st["f"]))),
            "cnet": _events_ms(lambda: st.update(c=model.context(img1))),
        }
        c0 = coords_grid(b, h8, w8, device=img1.device)
        t["refine_x%d" % iters] = _events_ms(lambda: st.update(r=model.iterate(
            *st["c"], st["p"], c0, c0, (h, w), iters, final_flow_only=True)))
        for k, v in t.items():
            acc[k] = acc.get(k, 0.0) + v / reps
    return acc


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
    with torch.no_grad():
        stages = stage_times(model, img1, img2, args.iters)
    fwd = sum(_events_ms(forward) for _ in range(10)) / 10
    out = {
        "gpu": torch.cuda.get_device_name(0), "hw": list(args.hw), "batch": args.batch,
        "iters": args.iters, "dtype": args.dtype, "lookup_backend": args.lookup_backend,
        "fwd_ms": fwd,
        "stage_ms": stages, "profile": profile(forward, trace=args.trace),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
