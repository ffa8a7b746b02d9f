"""A/B timing of the design steps of K6 / K7, the fused lookup's forward, on
the GPU, level by level.

    python -m flow_supervisor_tpu_torch.probe_k7 [--reps 20] [--shapes fused_b8 fused_b1 sup chairs]

Run from the repository root (it takes the models, images and batches from
``chip_smoke.py``). Builds ``csrc/probe/k7_variants.cu`` (the first K6 / K7,
one warp per query; the tile design at 8x8 query tiles with its product on
the CUDA cores; the library's, on the tensor cores with the tile's f1 in
registers and double-buffered passes; the step before it, one pass buffer,
at 8x8 and 8x16 tiles; and diagnostics, parts of the library's body; see
the file's head) with nvcc into the git-ignored ``_build/``, then, at four
lookup shapes, checks every variant against
``corr_fused.corr_fused_plain`` (one bf16 ulp of the fp32 value) and times
it, each level alone (one K7 launch) and the whole lookup as the library
runs it at that batch (K6: one launch; K7: one per level), beside the
library's wrapper:

- fused_b8: the 448x1024 B=8 bf16 forward's last lookup (56x128 queries),
  the inputs of ``chip_smoke.lookup_timing``: K7;
- fused_b1: the same at B=1: K6;
- sup: the Sintel semi step's supervised crop, 400x720 (50x90, B=1): K6;
- chairs: the Baseline step's chairs batch, B=10 at 368x496 (46x62): K7.

The forward shapes take the pyramid of a bf16 model with random weights from
a seed and coords at the pixel grid plus the flow before the last iteration;
the step shapes take ``probe_k9.lookup_inputs``. Times are device ms per call
(calls queued behind a spin kernel). Prints ptxas's register and
shared-memory report, each shape's tiles by path (``chip_smoke.tile_paths``)
and one JSON line per shape. A CUDA device is required.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from flow_supervisor_tpu_torch.kernels import _build, corr_fused
from flow_supervisor_tpu_torch.probe_k9 import lookup_inputs, time_ms

NAMES = ["first_k6_k7", "tile_8x8_cuda_cores", "tile_8x8_tensor_cores",
         "tile_8x8_tensor_cores_one_buffer", "tile_8x16_tensor_cores_one_buffer",
         "diagnostic_no_combine", "diagnostic_no_product", "diagnostic_prologue",
         "diagnostic_no_mma", "diagnostic_no_support_adds"]
DIAGNOSTIC = {n for n in NAMES if n.startswith("diagnostic")}
LEVELS, RADIUS = 4, 4


def build() -> ctypes.CDLL:
    src = _build.CSRC / "probe" / "k7_variants.cu"
    deps = [src, _build.CSRC / "corr_fused.cu", _build.CSRC / "common.cuh",
            _build.CSRC / "tiles.cuh"]
    out = _build.BUILD_DIR / f"libk7_probe_{_build._digest(deps)}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}")
    handle = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.k7_probe.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p, p, i, i, i, i, p]
    handle.k7_probe.restype = i
    return handle


def forward_inputs(cs, batch, dev):
    """(fused pyramid, coords [B*Q, 2]) of the 448x1024 bf16 forward's last
    lookup at `batch`, as ``chip_smoke.phase_main_path`` makes them."""
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
    from flow_supervisor_tpu_torch.ops.coords import coords_grid

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(3)
    cfg = RAFTConfig(iters=cs.ITERS, dtype=bf16, corr_dtype=bf16, lookup_backend="fused")
    model = RAFT(cfg, generator=gen).to(dev)
    img1, img2 = (t.to(dev) for t in cs.synthetic_pair(batch, *cs.MAIN_HW, gen))
    h8, w8 = cs.MAIN_HW[0] // 8, cs.MAIN_HW[1] // 8
    with torch.no_grad():
        out = model(img1, img2, final_flow_only=True)
        coords = (coords_grid(batch, h8, w8, device=dev) + out["flow_low"][-2]).reshape(-1, 2)
        pyr = model.build_corr(*model.features(img1, img2))
    return pyr, coords.float().contiguous()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", nargs="+", default=["fused_b8", "fused_b1", "sup", "chairs"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k7 needs a CUDA device")
    import chip_smoke as cs

    dev = torch.device("cuda")
    lib = build()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    shapes = {"fused_b8": lambda: forward_inputs(cs, 8, dev),
              "fused_b1": lambda: forward_inputs(cs, 1, dev)}
    if {"sup", "chairs"} & set(args.shapes):
        steps = lookup_inputs(cs, dev)
        shapes.update({k: (lambda v=v: v) for k, v in steps.items()})
    for name in args.shapes:
        pyr, coords = shapes[name]()
        f1, f2s = pyr.f1, pyr.f2s
        b, q, c = f1.shape
        h1, w1 = f2s[0].shape[1:3]
        k2 = (2 * RADIUS + 1) ** 2
        out = torch.empty((b * q, LEVELS * k2), dtype=f1.dtype, device=dev)
        ptrs = (ctypes.c_void_p * LEVELS)(*[f2.data_ptr() for f2 in f2s])
        h2s = (ctypes.c_int * LEVELS)(*[f2.shape[1] for f2 in f2s])
        w2s = (ctypes.c_int * LEVELS)(*[f2.shape[2] for f2 in f2s])
        want = corr_fused.corr_fused_plain(f1, f2s, coords, RADIUS, torch.float32)

        def variant(v, all_levels, lo=0, hi=LEVELS):
            def run():
                rc = lib.k7_probe(v, int(all_levels), f1.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p),
                                  ctypes.cast(h2s, ctypes.c_void_p), ctypes.cast(w2s, ctypes.c_void_p),
                                  LEVELS, lo, hi, h1, w1, coords.data_ptr(), out.data_ptr(), b * q,
                                  q, c, RADIUS, stream)
                if rc != 0:
                    raise RuntimeError(f"variant {NAMES[v]}: CUDA error {rc}")
            return run

        k6 = b == 1  # the library's dispatch
        res = {"gpu": gpu, "shape": name, "kernel": "K6" if k6 else "K7", "batch": b,
               "queries_per_sample": [h1, w1], "dtype": str(f1.dtype),
               "tile_paths": cs.tile_paths(f1, f2s, coords), "variants": {}}
        for v, vname in enumerate(NAMES):
            if vname in DIAGNOSTIC:
                continue
            for mode in (True, False):
                out.fill_(float("nan"))
                variant(v, mode)()
                torch.cuda.synchronize()
                err = (out.float() - want).abs()
                ok = bool(err.le(1e-5 + 1e-2 * want.abs()).all())
                res["variants"][f"{vname}/{'k6' if mode else 'k7'}"] = {
                    "ok": ok, "max_abs_err": float(err.max())}
        if k6:
            fns = {"library": lambda: corr_fused.corr_fused_all(f1, f2s, coords, RADIUS, f1.dtype,
                                                               query_hw=(h1, w1))}
        else:
            fns = {"library": lambda: [corr_fused.corr_fused_level(f1, f2, lvl, coords, RADIUS, out,
                                                                   (h1, w1))
                                       for lvl, f2 in enumerate(f2s)]}
        for v, vname in enumerate(NAMES):
            fns[f"{vname}/all"] = variant(v, k6)
            for lvl in range(LEVELS):
                fns[f"{vname}/level{lvl}"] = variant(v, False, lvl, lvl + 1)
        order = list(fns)
        ms = {k: [] for k in order}
        for key in order + order[::-1]:
            ms[key].append(time_ms(fns[key], args.reps))
        res["ms_per_call"] = {k: sum(v) / len(v) for k, v in ms.items()}
        res["ms_per_call_runs"] = ms
        print(json.dumps(res), flush=True)
        if not all(r["ok"] for r in res["variants"].values()):
            raise SystemExit(f"{name}: a variant disagrees with the plain version")
        del want, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
