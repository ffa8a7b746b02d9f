"""A/B timing of K3's and K4's design steps on the GPU, per fnet norm shape.

    python -m flow_supervisor_tpu_torch.probe_k3k4 [--configs plane_b1 fused_b8 chairs_b10]
        [--reps 20]

Builds ``csrc/probe/k3k4_variants.cu`` (the first K3 and K4, K3's partial
rows with a separate fold kernel or with K2's finalize, the library's
one-launch K3 at several grids, caps of partial rows and unrolls, and
without its fold (a diagnostic), and the library's K4 body at several grids
and unrolls; see the file's head) with nvcc into the git-ignored ``_build/``. Then, at the
bf16 instance-norm shapes of the fnet (the stem and layer1 at C = 64,
layer2 at 96, layer3 at 128; K3 runs 1, 2 and 2 times an encoder call,
K4 5 times each) of three configurations:

- plane_b1: a 448x1024 forward at B=1 (the fnet takes 2 images);
- fused_b8: a 448x1024 forward at B=8 (16 images);
- chairs_b10: the chairs Baseline step's 368x496 frames at B=10 (20 images),

it checks every K3 variant but the diagnostic against
``norm.instance_norm_stats_plain`` (atol 1e-5) and for the same bits on a
second launch, and every K4 variant for
bits equal to ``norm.instance_norm_apply_plain``'s (relu on), then times
each, with the library's wrappers, in turns. Times are device ms per call
(calls queued behind a spin kernel); each line also gives ms per encoder
call (per-call ms x calls) and the bound (bytes at 3.35 TB/s). x is
3 N(0, 1) + 1.5 from a seed. Prints ptxas's register and shared-memory
report and one JSON line per shape and one per configuration. A CUDA
device is required.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

from flow_supervisor_tpu_torch.kernels import _build, norm

CONFIGS = {"plane_b1": (2, 448, 1024), "fused_b8": (16, 448, 1024), "chairs_b10": (20, 368, 496)}
# (stride of the map, C, K3 calls, K4 calls) per fnet norm stage
STAGES = [(2, 64, 1, 5), (4, 96, 2, 5), (8, 128, 2, 5)]
# name -> (variant, blocks an SM, rows in flight, most partial rows a
# sample); the library's: k3_one_launch_2_u4_cap64, k4_8_u4
NO_CAP = 1 << 30
K3_VARIANTS = {"first_k3": (0, 0, 0, 0), "k3_rows_fold_kernel_2_u4_cap64": (1, 2, 4, 64),
               "k3_rows_k2_finalize_2_u4_cap64": (2, 2, 4, 64),
               "k3_one_launch_2_u4_cap64": (3, 2, 4, 64), "k3_one_launch_2_u4": (3, 2, 4, NO_CAP),
               "k3_one_launch_1_u4": (3, 1, 4, NO_CAP), "k3_one_launch_2_u4_cap32": (3, 2, 4, 32),
               "k3_one_launch_2_u8_cap64": (3, 2, 8, 64),
               "diagnostic_k3_no_fold": (6, 2, 4, 64)}
DIAGNOSTIC = {"diagnostic_k3_no_fold"}  # timing only: it writes no statistics
K4_VARIANTS = {"first_k4": (4, 0, 0, 0), "k4_4_u4": (5, 4, 4, 0), "k4_8_u4": (5, 8, 4, 0),
               "k4_16_u4": (5, 16, 4, 0), "k4_8_u1": (5, 8, 1, 0), "k4_8_u2": (5, 8, 2, 0)}
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES_PER_S = 2.0e9


def build() -> ctypes.CDLL:
    src = _build.CSRC / "probe" / "k3k4_variants.cu"
    deps = [src, _build.CSRC / "norm.cu", _build.CSRC / "common.cuh"]
    out = _build.BUILD_DIR / f"libk3k4_probe_{_build._digest(deps)}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}")
    handle = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.k3k4_probe.argtypes = [i, i, i, i, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    handle.k3k4_probe.restype = i
    handle.k3k4_probe_chunks.argtypes = [i] * 9
    handle.k3k4_probe_chunks.restype = i
    return handle


def time_ms(fn, reps: int) -> float:
    """Device ms per call: the calls queue behind a spin kernel that outlasts
    their enqueue, so the events see the device alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_PER_S) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def probe_shape(lib, gpu, config, shape, n_stats, n_apply, reps):
    gen = torch.Generator().manual_seed(11)
    x = (3 * torch.randn(*shape, generator=gen) + 1.5).to("cuda", torch.bfloat16)
    b, h, w, c = shape
    m = h * w
    vec = int(norm.vector_body(x))
    code = _build.dtype_code(x)
    want_st = norm.instance_norm_stats_plain(x)
    want_y = norm.instance_norm_apply_plain(x, want_st, True)
    parts = max(lib.k3k4_probe_chunks(v, k, u, cap, b, m, c, code, vec)
                for v, k, u, cap in K3_VARIANTS.values())
    partials = torch.empty(b * parts * 2 * c, dtype=torch.float32, device="cuda")
    counters = torch.zeros(b, dtype=torch.int32, device="cuda")
    st = torch.empty_like(want_st)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def variant(v, per_sm, unroll, cap, stats):
        def run():
            rc = lib.k3k4_probe(v, per_sm, unroll, cap, x.data_ptr(), partials.data_ptr(),
                                counters.data_ptr(), stats.data_ptr(), y.data_ptr(), b, m, c,
                                code, vec, 1, norm.EPS, stream)
            if rc != 0:
                raise RuntimeError(f"variant {v} ({per_sm}, {unroll}, {cap}): CUDA error {rc}")
        return run

    res = {"gpu": gpu, "config": config, "shape": list(shape), "k3_calls": n_stats,
           "k4_calls": n_apply, "vector_body": bool(vec),
           "k3_bound_ms": x.numel() * 2 / HBM_BYTES_PER_S * 1e3,
           "k4_bound_ms": 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3, "variants": {}}
    fns = {"library_k3": lambda: norm.instance_norm_stats(x),
           "library_k4": lambda: norm.instance_norm_apply(x, want_st, True)}
    for name, (v, per_sm, unroll, cap) in K3_VARIANTS.items():
        fns[name] = variant(v, per_sm, unroll, cap, st)
        if name in DIAGNOSTIC:
            continue
        st.fill_(float("nan"))
        fns[name]()
        first = st.clone()
        fns[name]()
        torch.cuda.synchronize()
        err = (first - want_st).abs()
        res["variants"][name] = {"ok": bool(torch.isfinite(first).all() and (err <= 1e-5).all()),
                                 "max_abs_err": float(err.max()),
                                 "same_bits_twice": bool(torch.equal(first, st))}
    for name, (v, per_sm, unroll, cap) in K4_VARIANTS.items():
        y.fill_(float("nan"))
        variant(v, per_sm, unroll, cap, want_st)()
        torch.cuda.synchronize()
        res["variants"][name] = {"ok": bool(torch.equal(y, want_y)),
                                 "max_abs_err": float((y.float() - want_y.float()).abs().max())}
        fns[name] = variant(v, per_sm, unroll, cap, want_st)
    library_st = norm.instance_norm_stats(x)
    fns["k3_one_launch_2_u4_cap64"]()
    res["library_k3_equals_k3_one_launch_2_u4_cap64"] = bool(torch.equal(library_st, st))
    res["library_k4_equals_plain"] = bool(torch.equal(norm.instance_norm_apply(x, want_st, True),
                                                      want_y))
    order = list(fns)
    ms = {k: [] for k in order}
    for name in order + order[::-1]:
        ms[name].append(time_ms(fns[name], reps))
    res["ms"] = {k: sum(v) / len(v) for k, v in ms.items()}
    res["ms_runs"] = ms
    print(json.dumps(res), flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k3k4 needs a CUDA device")
    lib = build()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for config in args.configs:
        n, hh, ww = CONFIGS[config]
        rows = [probe_shape(lib, gpu, config, (n, hh // s, ww // s, c), n3, n4, args.reps)
                for s, c, n3, n4 in STAGES]
        per_encoder = {}
        for r in rows:
            for name, t in r["ms"].items():
                calls = r["k4_calls"] if "k4" in name else r["k3_calls"]
                per_encoder[name] = per_encoder.get(name, 0.0) + calls * t
        print(json.dumps({
            "gpu": gpu, "config": config, "ms_per_encoder_call": per_encoder,
            "k3_bound_ms": sum(r["k3_calls"] * r["k3_bound_ms"] for r in rows),
            "k4_bound_ms": sum(r["k4_calls"] * r["k4_bound_ms"] for r in rows),
            "all_ok": all(v["ok"] for r in rows for v in r["variants"].values()),
        }), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
