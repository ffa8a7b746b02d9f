#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's RAFT inference path on one NVIDIA GPU.

    python3 chip_smoke.py

Prints the card's name and power limit (as nvidia-smi gives them), builds
the hand-written CUDA kernels of flow_supervisor_tpu_torch from the sources
in this checkout (one nvcc per source, in parallel), then runs four phases,
each printing one JSON line per check or configuration:

1. kernels: K1 (corr_plane), K2 (conv3x3 + stats), K3/K4 (instance norm),
   K6/K7 (corr_fused, all levels / per level) and K10 (corr_window) on the
   card against their plain PyTorch versions at the main path's shapes and a
   ragged one, fp32 (TF32 off) and bf16, with lookup coords in bounds, partly
   out and far out of bounds;
2. parity: a 216x512, 12-iteration fp32 forward on the card (kernels) against
   the same model and weights on the CPU (plain versions), for each lookup
   backend (plane, fused, pallas);
3. main_path: for each configuration (lookup backend, batch) one 448x1024,
   12-iteration bf16 forward with the launch counters reset, which must
   launch each kernel the expected number of times; then pairs/s over 20
   back-to-back forwards, peak device memory, and the configuration's lookup
   kernel timed against its plain version on the inputs of the forward's
   last lookup; the encoder kernels K2-K4 are timed at B=1. Kernel, plain
   and library times are device time (the timed calls queue behind a spin
   kernel); the forward's time is back to back, host included;
4. requests: ``run_pair`` on three Sintel-size pairs, writing and reading
   back ``.flo`` files.

Then it prints a JSON line of the kernels (launches in their configuration's
main-path run, max error, kernel, plain and library ms per forward, and the
least time the card could take for the same work) and last
``{"ok": true, "device": {...}}``. Any failure raises and the script exits
non-zero; so does a machine without a CUDA device. It imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

MAIN_HW = (448, 1024)
ITERS = 12
LEVELS = 4
RADIUS = 4
K2 = (2 * RADIUS + 1) ** 2
# the card's published rates (H100 SXM; dense, no sparsity): memory bytes/s,
# and operations/s by input type (bf16 on the tensor cores, fp32 outside)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# flops per lookup output: 4 tap products and 3 adds (weights not counted)
COMBINE_FLOPS = 7
# an upper bound of the SM clock (H100 SXM boosts to 1.98 GHz), to size the
# spin that keeps the device busy while the host enqueues timed calls
SPIN_CYCLES_PER_S = 2.0e9

SOURCES = {
    "corr_plane": ("flow_supervisor_tpu_torch/csrc/corr_plane.cu",
                   "flow_supervisor_tpu/kernels/corr_plane.py:271"),
    "conv3x3_stats": ("flow_supervisor_tpu_torch/csrc/conv3x3.cu",
                      "flow_supervisor_tpu/kernels/conv3x3.py:67"),
    "norm_stats": ("flow_supervisor_tpu_torch/csrc/norm.cu",
                   "flow_supervisor_tpu/kernels/norm.py:55"),
    "norm_apply": ("flow_supervisor_tpu_torch/csrc/norm.cu",
                   "flow_supervisor_tpu/kernels/norm.py:90"),
    "corr_fused_all": ("flow_supervisor_tpu_torch/csrc/corr_fused.cu",
                       "flow_supervisor_tpu/kernels/corr_fused.py:317"),
    "corr_fused_level": ("flow_supervisor_tpu_torch/csrc/corr_fused.cu",
                         "flow_supervisor_tpu/kernels/corr_fused.py:439"),
    "corr_window": ("flow_supervisor_tpu_torch/csrc/corr_window.cu",
                    "flow_supervisor_tpu/kernels/corr_lookup_v2.py:134"),
}
# launches of each kernel in one 448x1024 forward, at any batch: fnet runs
# once over the 2B images, with 10 3x3 stride-1 conv -> instance-norm -> relu
# pairs (K2 + K4) and 5 other instance norms (stem, two stride-2 conv1s, two
# downsamples: K3 + K4); then 12 lookups, each one launch of K1 or K6, or one
# per level (4) of K7 or K10
ENCODER_LAUNCHES = {"conv3x3_stats": 10, "norm_stats": 5, "norm_apply": 15}
LOOKUP_KERNEL = {("plane", 1): "corr_plane", ("fused", 1): "corr_fused_all",
                 ("fused", 8): "corr_fused_level", ("pallas", 1): "corr_window",
                 ("plane", 8): "corr_plane"}
LOOKUP_LAUNCHES = {"corr_plane": ITERS, "corr_fused_all": ITERS,
                   "corr_fused_level": ITERS * LEVELS, "corr_window": ITERS * LEVELS}
# (backend, batch) in the order they run; plane at B=8 is there for comparison
CONFIGS = [("plane", 1), ("fused", 1), ("fused", 8), ("pallas", 1), ("plane", 8)]
# the configuration whose main-path run gives each kernel's launches
HOME_CONFIG = {"corr_plane": ("plane", 1), "conv3x3_stats": ("plane", 1),
               "norm_stats": ("plane", 1), "norm_apply": ("plane", 1),
               "corr_fused_all": ("fused", 1), "corr_fused_level": ("fused", 8),
               "corr_window": ("pallas", 1)}
# fnet shapes at 448x1024 (B=1: the pair runs through fnet together) and how
# many times one forward runs each kernel there
CONV_SHAPES = [((2, 224, 512, 64), 64, 4), ((2, 112, 256, 96), 96, 3), ((2, 56, 128, 128), 128, 3)]
STATS_SHAPES = [((2, 224, 512, 64), 1), ((2, 112, 256, 96), 2), ((2, 56, 128, 128), 2)]
APPLY_SHAPES = [((2, 224, 512, 64), 5), ((2, 112, 256, 96), 5), ((2, 56, 128, 128), 5)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    from flow_supervisor_tpu_torch.kernels import conv3x3, corr_fused, corr_lookup_v2, corr_plane, norm

    return {"corr_plane": corr_plane.launches, "conv3x3_stats": conv3x3.launches,
            "norm_stats": norm.stats_launches, "norm_apply": norm.apply_launches,
            "corr_fused_all": corr_fused.all_launches,
            "corr_fused_level": corr_fused.level_launches,
            "corr_window": corr_lookup_v2.launches}


def reset_launch_counts() -> None:
    from flow_supervisor_tpu_torch.kernels import conv3x3, corr_fused, corr_lookup_v2, corr_plane, norm

    corr_plane.launches = conv3x3.launches = norm.stats_launches = norm.apply_launches = 0
    corr_fused.all_launches = corr_fused.level_launches = corr_lookup_v2.launches = 0


def time_ms(fn, reps=20, warm=3, device_only=False) -> float:
    """Mean time of fn() in ms, by CUDA events around `reps` calls.

    device_only: the timed calls are queued behind a spin kernel that lasts
    twice as long as the host took to enqueue `reps` calls, so the events see
    the device's time alone; back to back, a small kernel would be timed at
    the host's launch rate instead."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if device_only:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_PER_S) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ab_ms(kernel_fn, plain_fn, reps=20):
    """(kernel ms, plain ms) of device time, in turns plain, kernel, kernel, plain."""
    p1 = time_ms(plain_fn, reps, device_only=True)
    k1 = time_ms(kernel_fn, reps, device_only=True)
    k2 = time_ms(kernel_fn, reps, device_only=True)
    p2 = time_ms(plain_fn, reps, device_only=True)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, ops: float, dtype) -> tuple[float, float]:
    """(ms the card needs at least to move nbytes, ms for ops at the input type's peak)."""
    name = str(dtype).replace("torch.", "")
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[name] * 1e3


def check_close(name, got, want, rtol, atol):
    """Max |got - want|; raises if any element exceeds atol + rtol * |want|."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {got.numel()} elements outside rtol={rtol} "
            f"atol={atol}; max abs err {float(err.max())}"
        )
    return float(err.max())


def synthetic_pair(b, h, w, gen, shift=(3, 5)):
    """Smooth random image pair [B, H, W, 3] in [0, 1], the second shifted."""
    import torch
    import torch.nn.functional as F

    low = torch.rand(b, 3, h // 16 + 2, w // 16 + 2, generator=gen)
    img = F.interpolate(low, size=(h + 8, w + 8), mode="bilinear", align_corners=False)
    img1 = img[:, :, :h, :w]
    img2 = img[:, :, shift[0] : shift[0] + h, shift[1] : shift[1] + w]
    return (img1.permute(0, 2, 3, 1).contiguous(), img2.permute(0, 2, 3, 1).contiguous())


def check_coords(bq, h8, w8, gen, dev):
    """[BQ, 2] coords with windows in, partly in and fully out of bounds, and
    a few far out of bounds (up to 3e38)."""
    import torch

    u = torch.rand(bq, 2, generator=gen)
    coords = torch.stack([u[:, 0] * (w8 + 40) - 20, u[:, 1] * (h8 + 40) - 20], 1)
    far = torch.tensor([[1e9, -1e9], [-3e38, 3e38], [5e5, 7.5], [-2.5, -4e6]])
    coords[: len(far)] = far
    return coords.to(dev).contiguous()


def fmaps(b, h8, w8, dtype, gen, dev):
    import torch

    f1 = torch.randn(b, h8, w8, 256, generator=gen).to(dev, dtype)
    f2 = torch.randn(b, h8, w8, 256, generator=gen).to(dev, dtype)
    return f1, f2


def support_taps(coords, shapes) -> int:
    """Support taps inside the maps, over all queries and the given levels
    ((level, (h2, w2)) pairs): what a lookup at these coords has to read."""
    import torch

    sup = 2 * RADIUS + 2
    total = 0
    for lvl, (h2, w2) in shapes:
        fl = torch.floor(coords.float() * (1.0 / 2.0 ** lvl))
        bx = torch.clamp(fl[:, 0] - RADIUS, -sup, w2)
        by = torch.clamp(fl[:, 1] - RADIUS, -sup, h2)
        nx = torch.clamp(torch.clamp(bx + sup, max=w2) - torch.clamp(bx, min=0), min=0)
        ny = torch.clamp(torch.clamp(by + sup, max=h2) - torch.clamp(by, min=0), min=0)
        total += int((nx * ny).sum())
    return total


def phase_kernels(dev):
    import torch

    from flow_supervisor_tpu_torch.kernels import conv3x3, corr_fused, corr_lookup_v2, corr_plane, norm
    from flow_supervisor_tpu_torch.kernels.corr_plane import build_plane_pyramid
    from flow_supervisor_tpu_torch.ops.corr import window_support

    gen = torch.Generator().manual_seed(1)
    errs, checks = {k: 0.0 for k in SOURCES}, []
    main8 = (MAIN_HW[0] // 8, MAIN_HW[1] // 8)
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        # bf16: within 1 bf16 ulp of the plain fp32-accumulated value
        rtol = 1e-2 if bf16 else 0.0
        # lookups: main shape (BQ = 7168) and a ragged one (55 * 127 = 6985)
        for h8, w8 in (main8, (55, 127)):
            main = (h8, w8) == main8
            f1, f2 = fmaps(1, h8, w8, dtype, gen, dev)
            coords = check_coords(h8 * w8, h8, w8, gen, dev)
            planes = build_plane_pyramid(f1, f2, LEVELS, dtype)
            got = corr_plane.corr_lookup(planes, coords, RADIUS, dtype)
            want = corr_plane.corr_lookup_plain(planes, coords, RADIUS, torch.float32)
            e = check_close(f"K1 {h8}x{w8} {dtype}", got, want, rtol, 1e-5)
            checks.append({"kernel": "corr_plane", "shape": [h8, w8], "dtype": str(dtype), "err": e})
            if bf16 and main:
                errs["corr_plane"] = e
            # K10: a copy of plane values, so equal
            for lvl, plane in enumerate(planes):
                cl = (coords * (1.0 / 2 ** lvl)).contiguous()
                e = check_close(f"K10 {h8}x{w8} level {lvl} {dtype}",
                                corr_lookup_v2.level_support(plane, cl, RADIUS),
                                window_support(plane, cl, RADIUS), 0.0, 0.0)
                checks.append({"kernel": "corr_window", "shape": [h8, w8], "level": lvl,
                               "dtype": str(dtype), "err": e})
            del planes
            # K6: fp32 sums of 256 products in another order (rtol 1e-5 for fp32)
            pyr = corr_fused.build_fused_pyramid(f1, f2, LEVELS)
            got = corr_fused.corr_fused_all(pyr.f1, pyr.f2s, coords, RADIUS, dtype)
            want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, RADIUS, torch.float32)
            e = check_close(f"K6 {h8}x{w8} {dtype}", got, want, rtol or 1e-5, 1e-5)
            checks.append({"kernel": "corr_fused_all", "shape": [h8, w8], "dtype": str(dtype),
                           "err": e})
            if bf16 and main:
                errs["corr_fused_all"] = e
        # K7: B=1 and B=8 at the main shape, B=8 at the ragged one
        for b, (h8, w8) in ((1, main8), (8, main8), (8, (55, 127))):
            f1, f2 = fmaps(b, h8, w8, dtype, gen, dev)
            coords = check_coords(b * h8 * w8, h8, w8, gen, dev)
            pyr = corr_fused.build_fused_pyramid(f1, f2, LEVELS)
            got = torch.full((coords.shape[0], LEVELS * K2), float("nan"), device=dev, dtype=dtype)
            for lvl, f2l in enumerate(pyr.f2s):
                corr_fused.corr_fused_level(pyr.f1, f2l, lvl, coords, RADIUS, got)
            want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, RADIUS, torch.float32)
            e = check_close(f"K7 B={b} {h8}x{w8} {dtype}", got, want, rtol or 1e-5, 1e-5)
            checks.append({"kernel": "corr_fused_level", "batch": b, "shape": [h8, w8],
                           "dtype": str(dtype), "err": e})
            if bf16 and b == 8 and (h8, w8) == main8:
                errs["corr_fused_level"] = e
        # K2: the three stage shapes and a width that is not a multiple of 8
        for shape, cout, _ in CONV_SHAPES + [((2, 55, 90, 128), 128, 0)]:
            c = shape[3]
            x = torch.randn(*shape, generator=gen).to(dev, dtype)
            w = (torch.randn(3, 3, c, cout, generator=gen) * (2.0 / (9 * cout)) ** 0.5).to(dev, dtype)
            b = (0.1 * torch.randn(cout, generator=gen)).to(dev, dtype)
            y, st = conv3x3.conv3x3_stats(x, w, b)
            y_ref, st_ref = conv3x3.conv3x3_stats_plain(x, w, b)
            # fp32: only the summation order of 9*C <= 1152 terms differs
            e = check_close(f"K2 y {shape} {dtype}", y, y_ref, 1e-2 if bf16 else 1e-4, 1e-5)
            es = check_close(f"K2 stats {shape} {dtype}", st, st_ref, 1e-4, 1e-5)
            checks.append({"kernel": "conv3x3_stats", "shape": list(shape), "dtype": str(dtype),
                           "err": e, "stats_err": es})
            if bf16 and shape[1] != 55:
                errs["conv3x3_stats"] = max(errs["conv3x3_stats"], e)
        # K3 / K4, relu on and off
        for shape, _ in STATS_SHAPES:
            x = (3 * torch.randn(*shape, generator=gen) + 1.5).to(dev, dtype)
            st = norm.instance_norm_stats(x)
            st_ref = norm.instance_norm_stats_plain(x)
            e = check_close(f"K3 {shape} {dtype}", st, st_ref, 0.0, 1e-5)
            checks.append({"kernel": "norm_stats", "shape": list(shape), "dtype": str(dtype), "err": e})
            for relu in (False, True):
                y = norm.instance_norm_apply(x, st_ref, relu)
                y_ref = norm.instance_norm_apply_plain(x, st_ref, relu)
                ea = check_close(f"K4 {shape} relu={relu} {dtype}", y, y_ref, rtol, 1e-5)
                checks.append({"kernel": "norm_apply", "shape": list(shape), "dtype": str(dtype),
                               "relu": relu, "err": ea})
                if bf16:
                    errs["norm_apply"] = max(errs["norm_apply"], ea)
            if bf16:
                errs["norm_stats"] = max(errs["norm_stats"], e)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "ok": True, "checks": checks})
    return errs


def phase_parity(dev):
    import torch

    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

    gen = torch.Generator().manual_seed(2)
    base = RAFT(RAFTConfig(iters=ITERS), generator=gen)
    img1, img2 = synthetic_pair(1, 216, 512, gen)
    for backend in ("plane", "fused", "pallas"):
        model = RAFT(RAFTConfig(iters=ITERS, lookup_backend=backend))
        model.load_state_dict(base.state_dict())
        cpu = model(img1, img2, final_flow_only=True)["flow_up"][-1]
        model.to(dev)
        gpu = model(img1.to(dev), img2.to(dev), final_flow_only=True)["flow_up"][-1].cpu()
        d = (gpu - cpu).abs()
        res = {"phase": "parity", "lookup_backend": backend, "hw": [216, 512], "iters": ITERS,
               "dtype": "float32", "mean_abs_diff_px": float(d.mean()),
               "max_abs_diff_px": float(d.max()), "max_abs_flow_px": float(cpu.abs().max())}
        res["ok"] = bool(torch.isfinite(gpu).all() and res["mean_abs_diff_px"] < 1e-3
                         and res["max_abs_diff_px"] < 2e-2)
        emit(res)
        if not res["ok"]:
            raise AssertionError(f"end-to-end parity failed: {res}")


def lookup_timing(backend, batch, pyramid, coords, dev):
    """The configuration's lookup kernel against its plain version (and a
    library call where one computes the same function) on the inputs of the
    forward's last lookup: ms per forward, and the card's least time for it."""
    import torch
    import torch.nn.functional as F

    from flow_supervisor_tpu_torch.kernels import corr_fused, corr_lookup_v2, corr_plane
    from flow_supervisor_tpu_torch.ops.corr import window_support

    bf16 = torch.bfloat16
    bq = coords.shape[0]
    name = LOOKUP_KERNEL[(backend, batch)]
    out_bytes = bq * LEVELS * K2 * 2
    library_ms = None
    if backend == "plane":
        planes = pyramid
        shapes = [(lvl, tuple(p.shape[1:])) for lvl, p in enumerate(planes)]
        k, p = ab_ms(lambda: corr_plane.corr_lookup(planes, coords, RADIUS, bf16),
                     lambda: corr_plane.corr_lookup_plain(planes, coords, RADIUS, bf16))
        nbytes = support_taps(coords, shapes) * 2 + coords.numel() * 4 + out_bytes
        ops = bq * LEVELS * K2 * COMBINE_FLOPS
        # RAFT's own sampler: F.grid_sample over [BQ, 1, h2, w2] fp32 copies of
        # the planes (a bf16 grid cannot hold the coords), one call per level,
        # the grid laid out so that the output is dx-major
        d = torch.arange(-RADIUS, RADIUS + 1, device=dev, dtype=torch.float32)
        p32, grids = [], []
        for lvl, plane in enumerate(planes):
            h2, w2 = plane.shape[1:]
            c = coords * (1.0 / 2 ** lvl)
            gx = (c[:, 0, None, None] + d[None, :, None]).expand(bq, 2 * RADIUS + 1, 2 * RADIUS + 1)
            gy = (c[:, 1, None, None] + d[None, None, :]).expand(bq, 2 * RADIUS + 1, 2 * RADIUS + 1)
            grids.append(torch.stack([2 * gx / max(w2 - 1, 1) - 1, 2 * gy / max(h2 - 1, 1) - 1], -1))
            p32.append(plane.float()[:, None])

        def library():
            return [F.grid_sample(pl, g, mode="bilinear", padding_mode="zeros", align_corners=True)
                    for pl, g in zip(p32, grids)]

        lib_out = torch.cat([o.reshape(bq, K2) for o in library()], 1)
        library_err = float((lib_out - corr_plane.corr_lookup_plain(
            planes, coords, RADIUS, torch.float32)).abs().max())
        library_ms = time_ms(library, device_only=True) * ITERS
        del p32, grids, lib_out
        in_dtype = planes[0].dtype
    elif backend == "fused":
        f1, f2s = pyramid.f1, pyramid.f2s
        shapes = [(lvl, tuple(f2.shape[1:3])) for lvl, f2 in enumerate(f2s)]
        c = f1.shape[2]
        fixed = f1.numel() * f1.element_size() + coords.numel() * 4
        if batch == 1:
            k, p = ab_ms(lambda: corr_fused.corr_fused_all(f1, f2s, coords, RADIUS, bf16),
                         lambda: corr_fused.corr_fused_plain(f1, f2s, coords, RADIUS, bf16))
            nbytes = fixed + sum(f2.numel() * f2.element_size() for f2 in f2s) + out_bytes
        else:
            out = torch.empty((bq, LEVELS * K2), device=dev, dtype=bf16)

            def kernel():
                for lvl, f2 in enumerate(f2s):
                    corr_fused.corr_fused_level(f1, f2, lvl, coords, RADIUS, out)

            def plain():
                for lvl, f2 in enumerate(f2s):
                    out[:, lvl * K2 : (lvl + 1) * K2] = corr_fused.corr_fused_plain(
                        f1, [f2], coords, RADIUS, bf16, first_level=lvl)

            k, p = ab_ms(kernel, plain)
            # one launch per level: each reads f1 and the coords once
            nbytes = LEVELS * fixed + sum(f2.numel() * f2.element_size() for f2 in f2s) + out_bytes
        ops = 2 * c * support_taps(coords, shapes) + bq * LEVELS * K2 * COMBINE_FLOPS
        in_dtype = f1.dtype
        library_err = None
    else:  # pallas
        planes = pyramid
        shapes = [(lvl, tuple(p.shape[1:])) for lvl, p in enumerate(planes)]
        cls = [(coords * (1.0 / 2 ** lvl)).contiguous() for lvl in range(LEVELS)]
        k, p = ab_ms(lambda: [corr_lookup_v2.level_support(pl, cl, RADIUS) for pl, cl in zip(planes, cls)],
                     lambda: [window_support(pl, cl, RADIUS) for pl, cl in zip(planes, cls)])
        sup = 2 * RADIUS + 2
        nbytes = support_taps(coords, shapes) * 2 + LEVELS * (coords.numel() * 4 + bq * sup * sup * 4)
        ops = 0
        in_dtype = planes[0].dtype
        library_err = None
    t_bytes, t_ops = bound(nbytes, ops, in_dtype)
    return name, {"ms": k * ITERS, "plain_ms": p * ITERS, "library_ms": library_ms,
                  "library_max_abs_err": library_err,
                  "bound_ms": max(t_bytes, t_ops) * ITERS,
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "bytes_per_call": nbytes, "ops_per_call": ops}


def encoder_timing(dev):
    """K2-K4 against their plain versions and a library call, at the fnet
    shapes of a B=1 forward, as ms per forward (per-call time x calls)."""
    import torch
    import torch.nn.functional as F

    from flow_supervisor_tpu_torch.kernels import conv3x3, norm

    gen = torch.Generator().manual_seed(5)
    bf16 = torch.bfloat16
    times = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                 "t_bytes": 0.0, "t_ops": 0.0, "per_call": []}
             for n in ("conv3x3_stats", "norm_stats", "norm_apply")}

    def add(name, n, k, p, lib, nbytes, ops, shape):
        t = times[name]
        tb, to = bound(nbytes, ops, bf16)
        t["ms"] += n * k
        t["plain_ms"] += n * p
        t["library_ms"] += n * lib
        t["bound_ms"] += n * max(tb, to)
        t["t_bytes"] += n * tb
        t["t_ops"] += n * to
        t["per_call"].append([list(shape), k, p, lib])

    for shape, cout, n in CONV_SHAPES:
        bsz, h, w, c = shape
        x = torch.randn(*shape, generator=gen).to(dev, bf16)
        wt = (0.05 * torch.randn(3, 3, c, cout, generator=gen)).to(dev, bf16)
        b = torch.zeros(cout, device=dev, dtype=bf16)
        k, p = ab_ms(lambda: conv3x3.conv3x3_stats(x, wt, b),
                     lambda: conv3x3.conv3x3_stats_plain(x, wt, b))
        # cuDNN's bf16 conv alone (no statistics epilogue has a single call)
        xn = x.permute(0, 3, 1, 2)
        wn = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = time_ms(lambda: F.conv2d(xn, wn, b, padding=1), device_only=True)
        nbytes = 2 * (x.numel() + wt.numel() + cout + bsz * h * w * cout) + bsz * 2 * cout * 4
        add("conv3x3_stats", n, k, p, lib, nbytes, 2 * bsz * h * w * cout * 9 * c, shape)
    for (shape, n_stats), (_, n_apply) in zip(STATS_SHAPES, APPLY_SHAPES):
        bsz, _, _, c = shape
        x = torch.randn(*shape, generator=gen).to(dev, bf16)
        st = norm.instance_norm_stats_plain(x)
        xn = x.permute(0, 3, 1, 2)
        k, p = ab_ms(lambda: norm.instance_norm_stats(x), lambda: norm.instance_norm_stats_plain(x))
        # the same statistics (mean and variance per sample and channel) in one call
        lib = time_ms(lambda: torch.var_mean(x, dim=(1, 2), correction=0), device_only=True)
        add("norm_stats", n_stats, k, p, lib, x.numel() * 2 + bsz * 2 * c * 4, 3 * x.numel(), shape)
        k, p = ab_ms(lambda: norm.instance_norm_apply(x, st, True),
                     lambda: norm.instance_norm_apply_plain(x, st, True))
        # no call applies given statistics: the whole norm (statistics and apply)
        lib = time_ms(lambda: F.instance_norm(xn), device_only=True)
        add("norm_apply", n_apply, k, p, lib, 2 * x.numel() * 2 + bsz * 2 * c * 4, 3 * x.numel(), shape)
    for t in times.values():
        t["bound_by"] = "bytes" if t.pop("t_bytes") >= t.pop("t_ops") else "operations"
    return times


def phase_main_path(dev):
    import torch

    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
    from flow_supervisor_tpu_torch.ops.coords import coords_grid

    bf16 = torch.bfloat16
    launches, times, summary = {}, {}, []
    for backend, batch in CONFIGS:
        gen = torch.Generator().manual_seed(3)
        cfg = RAFTConfig(iters=ITERS, dtype=bf16, corr_dtype=bf16, lookup_backend=backend)
        model = RAFT(cfg, generator=gen).to(dev)
        img1, img2 = (t.to(dev) for t in synthetic_pair(batch, *MAIN_HW, gen))

        def forward():
            return model(img1, img2, final_flow_only=True)

        forward()  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        reset_launch_counts()
        out = forward()
        torch.cuda.synchronize()
        got = launch_counts()
        want = {k: 0 for k in SOURCES}
        want.update(ENCODER_LAUNCHES)
        lookup = LOOKUP_KERNEL[(backend, batch)]
        want[lookup] = LOOKUP_LAUNCHES[lookup]
        flow = out["flow_up"]
        if tuple(flow.shape) != (1, batch, *MAIN_HW, 2) or not torch.isfinite(flow).all():
            raise AssertionError(f"{backend} B={batch}: main path output bad, shape {tuple(flow.shape)}")
        if got != want:
            raise AssertionError(f"{backend} B={batch}: launch counts {got} != expected {want}")
        launches[(backend, batch)] = got
        # the coords of the last (12th) lookup: coords0 + the flow after 11 updates
        h8, w8 = MAIN_HW[0] // 8, MAIN_HW[1] // 8
        coords = (coords_grid(batch, h8, w8, device=dev) + out["flow_low"][-2]).reshape(-1, 2)
        coords = coords.float().contiguous()
        del out, flow

        torch.cuda.reset_peak_memory_stats()
        fwd_ms = time_ms(forward, reps=20, warm=3)
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            pyramid = model.build_corr(*model.features(img1, img2))
        name, t = lookup_timing(backend, batch, pyramid, coords, dev)
        t["launches"] = got[name]
        times[(backend, batch)] = {name: t}
        del pyramid, model, img1, img2
        torch.cuda.empty_cache()
        res = {"phase": "main_path", "ok": True, "lookup_backend": backend, "batch": batch,
               "hw": list(MAIN_HW), "iters": ITERS, "dtype": "bfloat16", "launches": got,
               "fwd_ms": fwd_ms, "pairs_per_s": 1000.0 * batch / fwd_ms,
               "peak_mem_bytes": peak, "lookup_kernel": {name: t}}
        emit(res)
        summary.append(res)
    enc = encoder_timing(dev)
    for name, t in enc.items():
        t["launches"] = launches[("plane", 1)][name]
    times[("plane", 1)].update(enc)
    emit({"phase": "main_path", "ok": True, "encoder_kernels_b1": enc})
    peaks = {(r["lookup_backend"], r["batch"]): r["peak_mem_bytes"] for r in summary}
    saved = peaks[("plane", 8)] - peaks[("fused", 8)]
    emit({"phase": "main_path", "ok": True, "peak_mem_saved_fused_vs_plane_b8_bytes": saved})
    if saved < 1e9:
        raise AssertionError(f"fused B=8 peak memory only {saved} bytes below plane B=8")
    return launches, times


def phase_requests(dev):
    import numpy as np
    import torch

    from flow_supervisor_tpu_torch.evaluation import run_pair
    from flow_supervisor_tpu_torch.flo import read_flo, write_flo
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

    gen = torch.Generator().manual_seed(4)
    model = RAFT(RAFTConfig(iters=ITERS), generator=gen).to(dev)
    done = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(3):
            img1, img2 = synthetic_pair(1, 436, 1024, gen, shift=(i + 1, 2 * i + 3))
            t0 = time.perf_counter()
            flow, _ = run_pair(model, img1[0].numpy(), img2[0].numpy(), "sintel", iters=ITERS)
            secs = time.perf_counter() - t0
            path = os.path.join(tmp, f"frame_{i:04d}.flo")
            write_flo(path, flow)
            back = read_flo(path)
            if back.shape != (436, 1024, 2) or not np.isfinite(back).all():
                raise AssertionError(f"{path}: bad flow read back, shape {back.shape}")
            if not np.array_equal(back, flow):
                raise AssertionError(f"{path}: read back differs from what was written")
            done.append({"file": os.path.basename(path), "shape": list(back.shape),
                         "seconds": secs, "mean_flow_px": float(np.abs(back).mean())})
    emit({"phase": "requests", "ok": True, "mode": "sintel", "padded_hw": [440, 1024],
          "dtype": "float32", "pairs": done})


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flow_supervisor_tpu_torch.kernels import _build

    smi = gpu_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # TF32 off: the fp32 comparisons need full fp32 convs and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _build.lib()
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": _build.library_path().name})

    errs = phase_kernels(dev)
    phase_parity(dev)
    launches, times = phase_main_path(dev)
    phase_requests(dev)

    kernels = []
    for name, (src, rep) in SOURCES.items():
        home = HOME_CONFIG[name]
        t = times[home][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[home][name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "config": {"lookup_backend": home[0], "batch": home[1]},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
