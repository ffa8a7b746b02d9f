"""A/B timing of K8's design steps on the GPU, level by level.

    python -m flow_supervisor_tpu_torch.probe_k8 [--reps 20]

Run from the repository root (it takes the recipes' batches and the lookup
inputs from ``chip_smoke.py``). Builds ``csrc/probe/k8_variants.cu`` (the
first K8, a warp per query; the tile design's layout A, a block per tile and
channel slice summing the levels in registers, at slices of 256 (the
library's), 128 and 64 channels; layout B, a block per level and a second
kernel that sums the levels; layout A on the CUDA cores; diagnostics, the
library's without its mma.sync, its D build, its staging of the box rows, or
all three; and the library's with D's low part zeroed; see the file's head)
with nvcc into the git-ignored ``_build/``, then, at two lookup-backward
shapes of the train steps, checks every variant but the diagnostics against
``corr_fused.bwd_df1_plain`` (within 2^-8 of the fp32 value plus 1e-4, at
most one bf16 ulp: ``chip_smoke.check_ulp``'s limit, which D without its low
part must fail) and for bitwise-equal results on two calls, and times it,
each level alone and all four levels, beside the library's
``corr_fused.bwd_df1``:

- sup: the Sintel semi step's supervised crop, 400x720 (50x90 queries, B=1);
- chairs: the Baseline step's chairs batch, B=10 at 368x496 (46x62).

The inputs are those of ``chip_smoke.train_bwd_timing`` (``probe_k9``'s
``lookup_inputs``): the fused pyramid of a bf16 model with random weights
from a seed, and coords at the pixel grid plus the model's flow before its
last iteration; g is random. Times are device ms per call (calls queued
behind a spin kernel). Prints ptxas's register and shared-memory report and
one JSON line per shape. A CUDA device is required.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess

import torch

from flow_supervisor_tpu_torch.kernels import _build, corr_fused
from flow_supervisor_tpu_torch.probe_k9 import lookup_inputs, time_ms

NAMES = ["first_k8", "layout_a_256", "layout_a_128", "layout_a_64", "layout_b_256", "cuda_cores",
         "diagnostic_no_mma", "diagnostic_no_d_build", "diagnostic_no_staging",
         "diagnostic_prologues_only", "d_high_part_only"]
DIAGNOSTIC = {n for n in NAMES if n.startswith("diagnostic")}  # timing only: wrong sums
LAYOUT_B = NAMES.index("layout_b_256")
LEVELS, RADIUS = 4, 4


def build() -> ctypes.CDLL:
    src = _build.CSRC / "probe" / "k8_variants.cu"
    deps = [src, _build.CSRC / "corr_fused_bwd.cu", _build.CSRC / "common.cuh",
            _build.CSRC / "tiles.cuh"]
    out = _build.BUILD_DIR / f"libk8_probe_{_build._digest(deps)}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}")
    handle = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.k8_probe.argtypes = [i, p, p, p, i, i, i, p, p, p, p, i, i, i, i, i, i, p]
    handle.k8_probe.restype = i
    return handle


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k8 needs a CUDA device")
    import chip_smoke as cs

    dev = torch.device("cuda")
    lib = build()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gen = torch.Generator().manual_seed(9)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (pyr, coords) in lookup_inputs(cs, dev).items():
        f1, f2s = pyr.f1, pyr.f2s
        b, q, c = f1.shape
        g = torch.randn(b * q, LEVELS * (2 * RADIUS + 1) ** 2, generator=gen).to(dev, f1.dtype)
        want = corr_fused.bwd_df1_plain(f1.float(), [f.float() for f in f2s], coords, g, RADIUS)
        out = torch.empty_like(f1)
        scratch = torch.empty((LEVELS, b * q, c), dtype=torch.float32, device=dev)
        ptrs = (ctypes.c_void_p * LEVELS)(*[f.data_ptr() for f in f2s])
        h2s = (ctypes.c_int * LEVELS)(*[f.shape[1] for f in f2s])
        w2s = (ctypes.c_int * LEVELS)(*[f.shape[2] for f in f2s])

        def variant(v, lo, hi):
            def run():
                rc = lib.k8_probe(v, ctypes.cast(ptrs, ctypes.c_void_p),
                                  ctypes.cast(h2s, ctypes.c_void_p),
                                  ctypes.cast(w2s, ctypes.c_void_p), LEVELS, lo, hi,
                                  coords.data_ptr(), g.data_ptr(), out.data_ptr(),
                                  scratch.data_ptr() if v == LAYOUT_B else None, b * q, q, c,
                                  RADIUS, _build.dtype_code(f1), _build.dtype_code(g), stream)
                if rc != 0:
                    raise RuntimeError(f"variant {NAMES[v]}: CUDA error {rc}")
            return run

        res = {"gpu": gpu, "shape": name, "batch": b, "queries_per_sample": list(f2s[0].shape[1:3]),
               "dtype": str(f1.dtype), "tile_paths": cs.tile_paths(f1, f2s, coords), "variants": {}}
        for v, vname in enumerate(NAMES):
            if vname in DIAGNOSTIC:
                continue
            out.fill_(float("nan"))
            variant(v, 0, LEVELS)()
            first = out.clone()
            variant(v, 0, LEVELS)()
            torch.cuda.synchronize()
            diff = (out.float() - want).abs()
            over = int(diff.gt(1e-4 + 2.0 ** -8 * want.abs()).sum())
            res["variants"][vname] = {"ok": over == 0, "over_limit": over,
                                      "max_abs_err": float(diff.max()),
                                      "bitwise_equal_twice": bool(torch.equal(first, out))}
        res["layout_a_256_is_the_library"] = bool(torch.equal(
            corr_fused.bwd_df1(f1, f2s, coords, g, RADIUS), (variant(1, 0, LEVELS)(), out)[1]))
        fns = {"library_bwd_df1": lambda: corr_fused.bwd_df1(f1, f2s, coords, g, RADIUS)}
        for (v, vname), lvl in itertools.product(enumerate(NAMES), [None, *range(LEVELS)]):
            key = f"{vname}/all" if lvl is None else f"{vname}/level{lvl}"
            fns[key] = variant(v, 0, LEVELS) if lvl is None else variant(v, lvl, lvl + 1)
        order = list(fns)
        ms = {k: [] for k in order}
        for key in order + order[::-1]:
            ms[key].append(time_ms(fns[key], args.reps))
        res["ms_per_call"] = {k: sum(v) / len(v) for k, v in ms.items()}
        res["ms_per_call_runs"] = ms
        print(json.dumps(res), flush=True)
        del want, out, scratch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
