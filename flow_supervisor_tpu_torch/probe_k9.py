"""A/B timing of K9's design steps on the GPU, level by level.

    python -m flow_supervisor_tpu_torch.probe_k9 [--reps 20]

Run from the repository root (it takes the recipes' batches and the lookup
inputs from ``chip_smoke.py``). Builds ``csrc/probe/k9_variants.cu`` (the
first K9; the tile design at 8x8 and 16x8 query tiles with its contraction
on the CUDA cores; 8x8 tiles with the contraction on the tensor cores for
bf16 f1, the library's; and a diagnostic, the library's without its
flush, for the atomics' share; see the file's head)
with nvcc into the git-ignored ``_build/``, then, at two lookup-backward
shapes of the train steps, checks every variant against
``corr_fused.bwd_df2_plain`` (one bf16 ulp of the fp32 value) and times it,
each level alone and all four levels in one launch, beside the library's
``corr_fused.bwd_df2`` (which also zeroes and casts its accumulators):

- sup: the Sintel semi step's supervised crop, 400x720 (50x90 queries, B=1);
- chairs: the Baseline step's chairs batch, B=10 at 368x496 (46x62).

The inputs are those of ``chip_smoke.train_bwd_timing``: the fused pyramid
of a bf16 model with random weights from a seed, and coords at the pixel grid
plus the model's flow before its last iteration; g is random. Times are
device ms per call (calls queued behind a spin kernel). Prints ptxas's
register and shared-memory report and one JSON line per shape. A CUDA
device is required.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import time

import torch

from flow_supervisor_tpu_torch.kernels import _build, corr_fused

NAMES = ["first_k9", "tile_8x8_cuda_cores", "tile_16x8_cuda_cores", "tile_8x8_tensor_cores",
         "diagnostic_no_flush"]
DIAGNOSTIC = {"diagnostic_no_flush"}  # timing only: their sums are not added
LEVELS, RADIUS = 4, 4
SPIN_CYCLES_PER_S = 2.0e9


def build() -> ctypes.CDLL:
    src = _build.CSRC / "probe" / "k9_variants.cu"
    deps = [src, _build.CSRC / "corr_fused_bwd.cu", _build.CSRC / "common.cuh"]
    out = _build.BUILD_DIR / f"libk9_probe_{_build._digest(deps)}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}")
    handle = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.k9_probe.argtypes = [i, p, p, p, p, i, i, i, p, p, i, i, i, i, i, i, p]
    handle.k9_probe.restype = i
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


def lookup_inputs(cs, dev):
    """{shape name: (fused pyramid, coords)} at the train steps' shapes, from
    the chip_smoke module cs."""
    from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg
    from flow_supervisor_tpu_torch.training.loop import build_model

    gen = torch.Generator().manual_seed(7)
    sup, _ = cs.recipe_batches(cs.TRAIN_SUP, cs.TRAIN_UNSUP, cs.TRAIN_FULL, gen, (16, 152),
                               (32, 128))
    chairs = cs.labeled_batch(cs.CHAIRS_BATCH, cs.CHAIRS_HW, gen)
    out = {}
    for name, kind, batch in (("sup", "semi", sup), ("chairs", "baseline", chairs)):
        model_kw, train_kw = cs.STEP_RECIPES[kind]
        cfg = ExperimentConfig(ModelCfg(**model_kw, compute_dtype="bfloat16"), TrainCfg(**train_kw))
        model = build_model(cfg, torch.Generator().manual_seed(0)).to(dev)
        out[name] = cs.bwd_lookup_inputs(model, cs.to_device(batch, dev), kind)
        del model
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k9 needs a CUDA device")
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
        want = corr_fused.bwd_df2_plain(f1.float(), [f.float() for f in f2s], coords, g, RADIUS)
        accs = [torch.zeros(f2.shape, dtype=torch.float32, device=dev) for f2 in f2s]
        ptrs = (ctypes.c_void_p * LEVELS)(*[a.data_ptr() for a in accs])
        h2s = (ctypes.c_int * LEVELS)(*[f2.shape[1] for f2 in f2s])
        w2s = (ctypes.c_int * LEVELS)(*[f2.shape[2] for f2 in f2s])

        def variant(v, lo, hi):
            def run():
                rc = lib.k9_probe(v, f1.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p),
                                  ctypes.cast(h2s, ctypes.c_void_p),
                                  ctypes.cast(w2s, ctypes.c_void_p), LEVELS, lo, hi, coords.data_ptr(), g.data_ptr(), b * q, q, c,
                                  RADIUS, _build.dtype_code(f1), _build.dtype_code(g), stream)
                if rc != 0:
                    raise RuntimeError(f"variant {NAMES[v]}: CUDA error {rc}")
            return run

        res = {"gpu": gpu, "shape": name, "batch": b, "queries_per_sample": list(f2s[0].shape[1:3]),
               "dtype": str(f1.dtype), "k9_paths": cs.tile_paths(f1, f2s, coords), "variants": {}}
        for v, vname in enumerate(NAMES):
            if vname in DIAGNOSTIC:
                continue
            for a in accs:
                a.zero_()
            variant(v, 0, LEVELS)()
            torch.cuda.synchronize()
            err = max(float((a - w).abs().max()) for a, w in zip(accs, want))
            ok = all(bool((a.to(f1.dtype).float() - w).abs().le(1e-4 + 1e-2 * w.abs()).all())
                     for a, w in zip(accs, want))
            res["variants"][vname] = {"ok": ok, "max_abs_err_fp32_acc": err}
        fns = {"library_bwd_df2": lambda: corr_fused.bwd_df2(f1, f2s, coords, g, RADIUS)}
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
        del want, accs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
