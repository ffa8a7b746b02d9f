"""A/B timing of K1's design steps, and of K10's and K11's, on the GPU.

    python -m flow_supervisor_tpu_torch.probe_k1 [--kernels k1 k10k11] [--batches 1 8] [--reps 20]

``k1``: builds ``csrc/probe/k1_variants.cu`` (the first K1 and the steps of
its redesign, one switch at a time; see the file's head) with nvcc into the
git-ignored ``_build/``, then, at the plane backend's main-path shapes
(448x1024 frames: 56x128 planes, 4 levels, radius 4, bf16 planes and output,
B = 1 and 8), checks every variant against ``corr_plane.corr_lookup_plain``
and times it, with the library's K1 (``corr_plane.corr_lookup``) and
``F.grid_sample`` (one call per level, fp32 copies of the planes), in turns.

``k10k11``: builds ``csrc/probe/k10k11_variants.cu`` (the first K10 and K11,
before they took csrc/window.cuh's body, and that body with all levels'
loads issued into registers first) and, at the same shapes, times the
library's K10 (``corr_pyramid_lookup_v2``, bf16 planes, fp32 out) against
the first K10 alone and with the PyTorch combine the pallas backend ran
behind it, and the library's K11 (``corr_pyramid_lookup_pallas``, the same
planes as an fp32 volume pyramid) against the first K11 (a launch per
level), each beside the register variant, the library's K1 and
``F.grid_sample``; every output is checked against its plain version.

Times are device time per forward's 12 lookups (calls queued behind a spin
kernel). The feature maps are random from a seed and the coords are the
pixel grid plus a uniform flow of up to 8 px (some windows leave the plane).
Prints ptxas's register and shared-memory report and one JSON line per
batch and kernel set. A CUDA device is required.
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

from flow_supervisor_tpu_torch.kernels import _build, corr_lookup, corr_lookup_v2, corr_plane
from flow_supervisor_tpu_torch.ops.corr import combine_support

H8, W8, LEVELS, RADIUS, ITERS = 56, 128, 4, 4, 12
NAMES = ["first_k1", "warp_direct", "warp_regs", "warp_regs_wide8", "warp_regs_wide16",
         "persistent_prefetch", "cp_async_words", "radius_argument", "warp_direct_4warps",
         "warp_direct_16warps", "warp_direct_wide"]
SPIN_CYCLES_PER_S = 2.0e9


def _compile(src, name: str, deps) -> ctypes.CDLL:
    out = _build.BUILD_DIR / f"lib{name}_{_build._digest([src, *deps])}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}")
    return ctypes.CDLL(str(out))


def build() -> ctypes.CDLL:
    csrc = _build.CSRC
    handle = _compile(csrc / "probe" / "k1_variants.cu", "k1_probe",
                      [csrc / "corr_plane.cu", csrc / "window.cuh", csrc / "common.cuh"])
    # ptxas's report of the library's K1 too
    obj = _build.BUILD_DIR / "corr_plane_probe.o"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-Xptxas", "-v",
                           "-c", "-o", str(obj), str(csrc / "corr_plane.cu")],
                          capture_output=True, text=True)
    print(proc.stderr, flush=True)
    os.remove(obj)
    handle.k1_probe.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 3, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    handle.k1_probe.restype = ctypes.c_int
    return handle


def build_k10k11() -> ctypes.CDLL:
    csrc = _build.CSRC
    handle = _compile(csrc / "probe" / "k10k11_variants.cu", "k10k11_probe",
                      [csrc / "window.cuh", csrc / "common.cuh"])
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {"probe_first_k10": [P, I, I, P, P, I, I, I, P],
            "probe_first_k11": [P, I, I, P, I, P, I, I, I, I, P],
            "probe_regs": [P, P, P, I, P, P, I, I, P]}
    for name, argtypes in sigs.items():
        fn = getattr(handle, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
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


def inputs(b: int, dev):
    """bf16 planes of B frames at the main-path shapes, and their coords."""
    gen = torch.Generator().manual_seed(7)
    f1 = torch.randn(b, H8, W8, 256, generator=gen).to(dev, torch.bfloat16)
    f2 = torch.randn(b, H8, W8, 256, generator=gen).to(dev, torch.bfloat16)
    planes = corr_plane.build_plane_pyramid(f1, f2, LEVELS, torch.bfloat16)
    ys, xs = torch.meshgrid(torch.arange(H8), torch.arange(W8), indexing="ij")
    grid = torch.stack([xs, ys], -1).float().expand(b, H8, W8, 2).reshape(-1, 2)
    coords = (grid + 16 * torch.rand(grid.shape, generator=gen) - 8).to(dev).contiguous()
    return planes, coords


def in_turns(fns: dict, reps: int) -> dict:
    """ms per forward's 12 lookups of each function, timed in turns forward
    then backward; the mean and the runs."""
    order = list(fns)
    ms = {k: [] for k in order}
    for name in order + order[::-1]:
        ms[name].append(time_ms(fns[name], reps) * ITERS)
    return {"ms_per_forward": {k: sum(v) / len(v) for k, v in ms.items()},
            "ms_per_forward_runs": ms}


def probe_k1(lib, b: int, reps: int, gpu: str, dev) -> None:
    bf16 = torch.bfloat16
    planes, coords = inputs(b, dev)
    bq = coords.shape[0]
    want = corr_plane.corr_lookup_plain(planes, coords, RADIUS, torch.float32)
    ref = corr_plane.corr_lookup(planes, coords, RADIUS, bf16)
    args = corr_plane.level_arrays(planes)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(ref)

    def variant(v):
        def run():
            rc = lib.k1_probe(v, *args, LEVELS, coords.data_ptr(), out.data_ptr(), bq, stream)
            if rc != 0:
                raise RuntimeError(f"variant {NAMES[v]}: CUDA error {rc}")
        return run

    res = {"gpu": gpu, "kernels": "k1", "batch": b, "queries": bq, "variants": {}}
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
    res.update(in_turns(fns, reps))
    print(json.dumps(res), flush=True)


def probe_k10k11(lib, b: int, reps: int, gpu: str, dev) -> None:
    """K10 on the bf16 planes and K11 on them as an fp32 volume pyramid."""
    planes, coords = inputs(b, dev)
    vols = [p.float().reshape(b, H8, W8, *p.shape[1:]) for p in planes]
    bq = coords.shape[0]
    k2 = (2 * RADIUS + 1) ** 2
    stream = torch.cuda.current_stream().cuda_stream
    cls = [(coords * (1.0 / 2 ** lvl)).contiguous() for lvl in range(LEVELS)]
    sups = [torch.empty((bq, 2 * RADIUS + 2, 2 * RADIUS + 2), device=dev) for _ in range(LEVELS)]
    out = torch.empty((bq, LEVELS * k2), device=dev)
    c4 = coords.reshape(b, H8, W8, 2)

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    def first_k10():
        for plane, cl, sup in zip(planes, cls, sups):
            check(lib.probe_first_k10(plane.data_ptr(), plane.shape[1], plane.shape[2],
                                      cl.data_ptr(), sup.data_ptr(), bq, RADIUS, 1, stream),
                  "first_k10")
        return sups

    def first_k10_combined():
        # the pallas backend before the fused K10: the scaled coords, the
        # support kernel and PyTorch's combine per level, then the concat
        outs = []
        for lvl, plane in enumerate(planes):
            cl = (coords * (1.0 / 2.0 ** lvl)).contiguous()
            sup = torch.empty((bq, 2 * RADIUS + 2, 2 * RADIUS + 2), device=dev)
            check(lib.probe_first_k10(plane.data_ptr(), plane.shape[1], plane.shape[2],
                                      cl.data_ptr(), sup.data_ptr(), bq, RADIUS, 1, stream),
                  "first_k10")
            outs.append(combine_support(sup, cl, RADIUS))
        return torch.cat(outs, dim=1)

    def first_k11():
        for lvl, vol in enumerate(vols):
            check(lib.probe_first_k11(vol.data_ptr(), vol.shape[3], vol.shape[4],
                                      coords.data_ptr(), lvl, out[:, lvl * k2:].data_ptr(),
                                      LEVELS * k2, bq, RADIUS, 0, stream), "first_k11")
        return out

    def regs(pyramid, dtype_code):
        def run():
            check(lib.probe_regs(*corr_plane.level_arrays(pyramid), LEVELS, coords.data_ptr(),
                                 out.data_ptr(), bq, dtype_code, stream), "regs")
            return out
        return run

    fns = {
        "library_k10": lambda: corr_lookup_v2.corr_pyramid_lookup_v2(planes, c4, RADIUS),
        "first_k10_with_pytorch_combine": first_k10_combined,
        "first_k10_alone": first_k10,
        "regs_k10": regs(planes, 1),
        "library_k11": lambda: corr_lookup.corr_pyramid_lookup_pallas(vols, c4, RADIUS),
        "first_k11": first_k11,
        "regs_k11": regs(vols, 0),
        "library_k1": lambda: corr_plane.corr_lookup(planes, coords, RADIUS, torch.bfloat16),
        "grid_sample": grid_sample_fn(planes, coords),
    }
    want = corr_plane.corr_lookup_plain(planes, coords, RADIUS, torch.float32)
    want_sup = torch.cat([s.reshape(bq, -1) for s in (
        corr_lookup_v2.level_support(p, cl, RADIUS) for p, cl in zip(planes, cls))], 1)
    res = {"gpu": gpu, "kernels": "k10k11", "batch": b, "queries": bq, "checks": {}}
    for name in ("library_k10", "first_k10_with_pytorch_combine", "first_k10_alone",
                 "regs_k10", "library_k11", "first_k11", "regs_k11"):
        out.fill_(float("nan"))
        got = fns[name]()
        torch.cuda.synchronize()
        if name == "first_k10_alone":
            got, ref = torch.cat([s.reshape(bq, -1) for s in got], 1), want_sup
        else:
            got, ref = got.reshape(bq, -1), want
        err = (got - ref).abs()
        res["checks"][name] = {"ok": bool(torch.isfinite(got).all() and (err <= 1e-5).all()),
                               "max_abs_err": float(err.max()),
                               "equal_to_plain": bool(torch.equal(got, ref))}
    res.update(in_turns(fns, reps))
    print(json.dumps(res), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", nargs="+", choices=["k1", "k10k11"], default=["k1", "k10k11"])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k1 needs a CUDA device")
    dev = torch.device("cuda")
    runs = {"k1": (build, probe_k1), "k10k11": (build_k10k11, probe_k10k11)}
    libs = {k: runs[k][0]() for k in args.kernels}
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for k in args.kernels:
        for b in args.batches:
            runs[k][1](libs[k], b, args.reps, gpu, dev)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
