#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's RAFT inference path on one NVIDIA GPU.

    python3 chip_smoke.py

Prints the card's name and power limit (as nvidia-smi gives them), builds
the hand-written CUDA kernels of flow_supervisor_tpu_torch from the sources
in this checkout, then runs four phases, each printing one JSON line:

1. kernels: K1 (corr_plane), K2 (conv3x3 + stats), K3/K4 (instance norm) on
   the card against their plain PyTorch versions at the main path's shapes
   (448x1024, B=1), fp32 and bf16;
2. parity: a 216x512, 12-iteration fp32 forward on the card (kernels) against
   the same model and weights on the CPU (plain versions);
3. main_path: one 448x1024, 12-iteration bf16 forward with the launch
   counters reset, which must launch every kernel the expected number of
   times; then pairs/s over 20 timed forwards and each kernel's time against
   its plain version;
4. requests: ``run_pair`` on three Sintel-size pairs, writing and reading
   back ``.flo`` files.

Then it prints a JSON line of the kernels (launches in the main-path run,
max error, kernel and plain ms per forward) and last
``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero; so does a machine without a CUDA device. It imports nothing
of JAX.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

MAIN_HW = (448, 1024)
ITERS = 12
# launches of each kernel in one 448x1024 forward: fnet has 10 3x3 stride-1
# conv -> instance-norm -> relu pairs (K2 + K4) and 5 other instance norms
# (stem, two stride-2 conv1s, two downsamples: K3 + K4); 12 lookups (K1)
EXPECTED_LAUNCHES = {"corr_plane": 12, "conv3x3_stats": 10, "norm_stats": 5, "norm_apply": 15}
SOURCES = {
    "corr_plane": ("flow_supervisor_tpu_torch/csrc/corr_plane.cu",
                   "flow_supervisor_tpu/kernels/corr_plane.py:271"),
    "conv3x3_stats": ("flow_supervisor_tpu_torch/csrc/conv3x3.cu",
                      "flow_supervisor_tpu/kernels/conv3x3.py:67"),
    "norm_stats": ("flow_supervisor_tpu_torch/csrc/norm.cu",
                   "flow_supervisor_tpu/kernels/norm.py:55"),
    "norm_apply": ("flow_supervisor_tpu_torch/csrc/norm.cu",
                   "flow_supervisor_tpu/kernels/norm.py:90"),
}
# fnet shapes at 448x1024 (B=2: the pair runs through fnet together) and how
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


def time_ms(fn, reps=20, warm=3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ab_ms(kernel_fn, plain_fn, reps=20):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = time_ms(plain_fn, reps)
    k1 = time_ms(kernel_fn, reps)
    k2 = time_ms(kernel_fn, reps)
    p2 = time_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def lookup_inputs(b, h8, w8, dtype, gen, dev):
    """Planes from random fmaps and coords with windows in, partly in and fully
    out of bounds."""
    import torch

    from flow_supervisor_tpu_torch.kernels.corr_plane import build_plane_pyramid

    f1 = torch.randn(b, h8, w8, 256, generator=gen).to(dev)
    f2 = torch.randn(b, h8, w8, 256, generator=gen).to(dev)
    planes = build_plane_pyramid(f1, f2, 4, dtype)
    bq = b * h8 * w8
    u = torch.rand(bq, 2, generator=gen)
    coords = torch.stack([u[:, 0] * (w8 + 40) - 20, u[:, 1] * (h8 + 40) - 20], 1)
    return planes, coords.to(dev).contiguous()


def phase_kernels(dev):
    import torch

    from flow_supervisor_tpu_torch.kernels import conv3x3, corr_plane, norm

    gen = torch.Generator().manual_seed(1)
    errs, checks = {k: 0.0 for k in SOURCES}, []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        # bf16: within 1 bf16 ulp of the plain fp32-accumulated value
        rtol = 1e-2 if bf16 else 0.0
        # K1: main shape (BQ = 7168) and a ragged BQ (55 * 127 = 6985)
        for h8, w8 in ((56, 128), (55, 127)):
            planes, coords = lookup_inputs(1, h8, w8, dtype, gen, dev)
            got = corr_plane.corr_lookup(planes, coords, 4, dtype)
            want = corr_plane.corr_lookup_plain(planes, coords, 4, torch.float32)
            e = check_close(f"K1 {h8}x{w8} {dtype}", got, want, rtol, 1e-5)
            checks.append({"kernel": "corr_plane", "shape": [h8, w8], "dtype": str(dtype), "err": e})
            if bf16 and (h8, w8) == (56, 128):
                errs["corr_plane"] = e
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
    model = RAFT(RAFTConfig(iters=ITERS), generator=gen)
    img1, img2 = synthetic_pair(1, 216, 512, gen)
    cpu = model(img1, img2, final_flow_only=True)["flow_up"][-1]
    model.to(dev)
    gpu = model(img1.to(dev), img2.to(dev), final_flow_only=True)["flow_up"][-1].cpu()
    d = (gpu - cpu).abs()
    res = {"phase": "parity", "hw": [216, 512], "iters": ITERS, "dtype": "float32",
           "mean_abs_diff_px": float(d.mean()), "max_abs_diff_px": float(d.max()),
           "max_abs_flow_px": float(cpu.abs().max())}
    res["ok"] = bool(torch.isfinite(gpu).all() and res["mean_abs_diff_px"] < 1e-3
                     and res["max_abs_diff_px"] < 2e-2)
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"end-to-end parity failed: {res}")


def phase_main_path(dev):
    import torch

    from flow_supervisor_tpu_torch.kernels import conv3x3, corr_plane, norm
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

    gen = torch.Generator().manual_seed(3)
    cfg = RAFTConfig(iters=ITERS, dtype=torch.bfloat16, corr_dtype=torch.bfloat16)
    model = RAFT(cfg, generator=gen).to(dev)
    img1, img2 = (t.to(dev) for t in synthetic_pair(1, *MAIN_HW, gen))

    def forward():
        return model(img1, img2, final_flow_only=True)

    forward()  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    corr_plane.launches = conv3x3.launches = norm.stats_launches = norm.apply_launches = 0
    out = forward()
    torch.cuda.synchronize()
    launches = {"corr_plane": corr_plane.launches, "conv3x3_stats": conv3x3.launches,
                "norm_stats": norm.stats_launches, "norm_apply": norm.apply_launches}
    flow = out["flow_up"]
    if tuple(flow.shape) != (1, 1, *MAIN_HW, 2) or not torch.isfinite(flow).all():
        raise AssertionError(f"main path output bad: shape {tuple(flow.shape)}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches} != expected {EXPECTED_LAUNCHES}")

    torch.cuda.reset_peak_memory_stats()
    fwd_ms = time_ms(forward, reps=20, warm=3)
    peak = torch.cuda.max_memory_allocated()

    # each kernel against its plain version at the main path's shapes, as ms
    # per forward (per-call time x calls per forward)
    times = {}
    planes, coords = lookup_inputs(1, MAIN_HW[0] // 8, MAIN_HW[1] // 8, torch.bfloat16, gen, dev)
    k, p = ab_ms(lambda: corr_plane.corr_lookup(planes, coords, 4, torch.bfloat16),
                 lambda: corr_plane.corr_lookup_plain(planes, coords, 4, torch.bfloat16))
    times["corr_plane"] = {"ms": k * ITERS, "plain_ms": p * ITERS,
                           "per_call": [[coords.shape[0], k, p]]}
    for name in ("conv3x3_stats", "norm_stats", "norm_apply"):
        times[name] = {"ms": 0.0, "plain_ms": 0.0, "per_call": []}
    for shape, cout, n in CONV_SHAPES:
        x = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
        w = (0.05 * torch.randn(3, 3, shape[3], cout, generator=gen)).to(dev, torch.bfloat16)
        b = torch.zeros(cout, device=dev, dtype=torch.bfloat16)
        k, p = ab_ms(lambda: conv3x3.conv3x3_stats(x, w, b),
                     lambda: conv3x3.conv3x3_stats_plain(x, w, b))
        t = times["conv3x3_stats"]
        t["ms"] += n * k
        t["plain_ms"] += n * p
        t["per_call"].append([list(shape), k, p])
    for (shape, n_stats), (_, n_apply) in zip(STATS_SHAPES, APPLY_SHAPES):
        x = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
        st = norm.instance_norm_stats_plain(x)
        for name, n, kfn, pfn in (
            ("norm_stats", n_stats, lambda: norm.instance_norm_stats(x),
             lambda: norm.instance_norm_stats_plain(x)),
            ("norm_apply", n_apply, lambda: norm.instance_norm_apply(x, st, True),
             lambda: norm.instance_norm_apply_plain(x, st, True)),
        ):
            k, p = ab_ms(kfn, pfn)
            t = times[name]
            t["ms"] += n * k
            t["plain_ms"] += n * p
            t["per_call"].append([list(shape), k, p])

    emit({"phase": "main_path", "ok": True, "hw": list(MAIN_HW), "batch": 1, "iters": ITERS,
          "dtype": "bfloat16", "launches": launches, "fwd_ms": fwd_ms,
          "pairs_per_s": 1000.0 / fwd_ms, "peak_mem_bytes": peak, "kernel_times": times})
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

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"]}
        for name, (src, rep) in SOURCES.items()
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
