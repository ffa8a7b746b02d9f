"""A/B timing of K1's design steps on the GPU.

    python -m flow_supervisor_tpu_torch.probe_k1 [--batches 1 8] [--reps 20]

Builds ``csrc/probe/k1_variants.cu`` (the first K1 and the steps of its
redesign, one switch at a time; see the file's head) with nvcc into the
git-ignored ``_build/``, then, at the plane backend's main-path shapes
(448x1024 frames: 56x128 planes, 4 levels, radius 4, bf16 planes and output,
B = 1 and 8), checks every variant against ``corr_plane.corr_lookup_plain``
and times it, with the library's K1 (``corr_plane.corr_lookup``) and
``F.grid_sample`` (one call per level, fp32 copies of the planes), in turns.
Times are device time per forward's 12 lookups (calls queued behind a spin
kernel). The feature maps are random from a seed and the coords are the
pixel grid plus a uniform flow of up to 8 px (some windows leave the plane).
Prints ptxas's register and shared-memory report and one JSON line per
batch. A CUDA device is required.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import torch
import torch.nn.functional as F

from flow_supervisor_tpu_torch.kernels import _build, corr_plane

H8, W8, LEVELS, RADIUS, ITERS = 56, 128, 4, 4, 12
NAMES = ["first_k1", "warp_direct", "warp_regs", "warp_regs_wide8", "warp_regs_wide16",
         "persistent_prefetch", "cp_async_words", "radius_argument", "warp_direct_4warps",
         "warp_direct_16warps", "warp_direct_wide"]
SPIN_CYCLES_PER_S = 2.0e9


def build() -> ctypes.CDLL:
    src = _build.CSRC / "probe" / "k1_variants.cu"
    deps = [src, _build.CSRC / "corr_plane.cu", _build.CSRC / "common.cuh"]
    out = _build.BUILD_DIR / f"libk1_probe_{_build._digest(deps)}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}")
    # ptxas's report of the library's K1 too
    lib_src = _build.CSRC / "corr_plane.cu"
    obj = _build.BUILD_DIR / "corr_plane_probe.o"
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-Xptxas", "-v",
                           "-c", "-o", str(obj), str(lib_src)], capture_output=True, text=True)
    print(proc.stderr, flush=True)
    os.remove(obj)
    handle = ctypes.CDLL(str(out))
    handle.k1_probe.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 3, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    handle.k1_probe.restype = ctypes.c_int
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


def grid_sample_fn(planes, coords):
    bq = coords.shape[0]
    d = torch.arange(-RADIUS, RADIUS + 1, device=coords.device, dtype=torch.float32)
    k = 2 * RADIUS + 1
    calls = []
    for lvl, plane in enumerate(planes):
        h2, w2 = plane.shape[1:]
        c = coords * (1.0 / 2 ** lvl)
        gx = (c[:, 0, None, None] + d[None, :, None]).expand(bq, k, k)
        gy = (c[:, 1, None, None] + d[None, None, :]).expand(bq, k, k)
        grid = torch.stack([2 * gx / max(w2 - 1, 1) - 1, 2 * gy / max(h2 - 1, 1) - 1], -1)
        calls.append((plane.float()[:, None], grid))
    return lambda: [F.grid_sample(p, g, mode="bilinear", padding_mode="zeros",
                                  align_corners=True) for p, g in calls]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k1 needs a CUDA device")
    dev = torch.device("cuda")
    lib = build()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    bf16 = torch.bfloat16
    for b in args.batches:
        gen = torch.Generator().manual_seed(7)
        f1 = torch.randn(b, H8, W8, 256, generator=gen).to(dev, bf16)
        f2 = torch.randn(b, H8, W8, 256, generator=gen).to(dev, bf16)
        planes = corr_plane.build_plane_pyramid(f1, f2, LEVELS, bf16)
        del f1, f2
        ys, xs = torch.meshgrid(torch.arange(H8), torch.arange(W8), indexing="ij")
        grid = torch.stack([xs, ys], -1).float().expand(b, H8, W8, 2).reshape(-1, 2)
        coords = (grid + 16 * torch.rand(grid.shape, generator=gen) - 8).to(dev).contiguous()
        bq = coords.shape[0]
        want = corr_plane.corr_lookup_plain(planes, coords, RADIUS, torch.float32)
        ref = corr_plane.corr_lookup(planes, coords, RADIUS, bf16)
        ptrs = (ctypes.c_void_p * LEVELS)(*[p.data_ptr() for p in planes])
        h2s = (ctypes.c_int * LEVELS)(*[p.shape[1] for p in planes])
        w2s = (ctypes.c_int * LEVELS)(*[p.shape[2] for p in planes])
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty_like(ref)

        def variant(v):
            def run():
                rc = lib.k1_probe(v, ctypes.cast(ptrs, ctypes.c_void_p),
                                  ctypes.cast(h2s, ctypes.c_void_p),
                                  ctypes.cast(w2s, ctypes.c_void_p), LEVELS,
                                  coords.data_ptr(), out.data_ptr(), bq, stream)
                if rc != 0:
                    raise RuntimeError(f"variant {NAMES[v]}: CUDA error {rc}")
            return run

        res = {"gpu": gpu, "batch": b, "queries": bq, "variants": {}}
        for v, name in enumerate(NAMES):
            out.fill_(float("nan"))
            variant(v)()
            torch.cuda.synchronize()
            err = (out.float() - want).abs()
            ok = bool(torch.isfinite(out).all() and (err <= 1e-5 + 1e-2 * want.abs()).all())
            res["variants"][name] = {"ok": ok, "max_abs_err": float(err.max()),
                                     "equal_to_library_k1": bool(torch.equal(out, ref))}
        fns = {"library_k1": lambda: corr_plane.corr_lookup(planes, coords, RADIUS, bf16),
               "grid_sample": grid_sample_fn(planes, coords)}
        fns.update({name: variant(v) for v, name in enumerate(NAMES)})
        order = list(fns)
        ms = {k: [] for k in order}
        for name in order + order[::-1]:
            ms[name].append(time_ms(fns[name], args.reps) * ITERS)
        res["ms_per_forward"] = {k: sum(v) / len(v) for k, v in ms.items()}
        res["ms_per_forward_runs"] = ms
        print(json.dumps(res), flush=True)
        del planes, want, ref, out, fns
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
