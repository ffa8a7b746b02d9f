"""Build and bind the hand-written CUDA kernels.

Every ``*.cu`` under ``flow_supervisor_tpu_torch/csrc/`` is compiled at first
use by ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started together)
and linked into one shared library with a plain C interface, bound with
``ctypes``. The library lands in
``flow_supervisor_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources, so an unchanged tree does not rebuild. Only the repository's sources
and the CUDA toolkit's headers go into the build. A failed build raises with
nvcc's stderr.

Each C entry point takes device pointers and the CUDA stream as ``void*``,
launches on that stream, and returns ``cudaGetLastError()`` as an int.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
# C signatures: name -> argtypes (restype is int for all: cudaError_t for launchers)
SIGNATURES = {
    # planes[L], h2[L], w2[L], levels, coords, out, bq, radius, in_dtype, out_dtype, stream
    "fst_corr_plane_lookup": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    # f1, f2[L], h2[L], w2[L], levels, h1, w1 (the queries' grid), coords, out, bq, q_per_b,
    # C, radius, in_dtype, out_dtype, stream
    "fst_corr_fused_all": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # f1, f2, h2, w2, level, h1, w1, coords, out, out_stride, bq, q_per_b, C, radius,
    # in_dtype, out_dtype, stream
    "fst_corr_fused_level": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    # f2[L], h2[L], w2[L], levels, coords, g, d_f1, bq, q_per_b, C, radius, in_dtype (f1's),
    # g_dtype, stream
    "fst_corr_fused_bwd_df1": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # f1, d_f2 fp32 accumulators[L], h2[L], w2[L], levels, coords, g, bq, q_per_b, C, radius,
    # in_dtype, g_dtype, stream
    "fst_corr_fused_bwd_df2": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # planes[L], h2[L], w2[L], levels, coords, out (fp32), bq, radius, in_dtype, stream
    "fst_corr_window_lookup": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    # plane, h2, w2, coords, out, bq, radius, in_dtype, stream
    "fst_corr_window": [_P, _I, _I, _P, _P, _I, _I, _I, _P],
    # d_planes[L], h2[L], w2[L], levels, coords, g, bq, radius, g_dtype, out_dtype, stream
    "fst_corr_plane_bwd": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    # x, w_hwio, bias, y, partials, stats, B, H, W, C, Cout, dtype, eps, stream
    "fst_conv3x3_stats": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, w_hwio, bias, y, B, H, W, C, Cout, dtype, relu, stream
    "fst_conv3x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # the tensor-core body (bf16): the same arguments without dtype
    "fst_conv3x3_tc_stats": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "fst_conv3x3_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # vols[L] (as [BQ, h2, w2]), h2[L], w2[L], levels, coords, out (fp32), bq, radius,
    # in_dtype, stream
    "fst_corr_lookup": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    # x, partials, counters, stats, B, M, C, dtype, vec (the vector body), eps, stream
    "fst_instance_norm_stats": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # x, stats, y, B, M, C, dtype, vec, relu, stream
    "fst_instance_norm_apply": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # mode, dtype, bias dtype, P, C, a, sa, b, sb, h, sh, bias0, bias1, o0, so0, o1, so1,
    # relu, scale, stream (csrc/update_epilogue.cu)
    "fst_update_epilogue": [_I, _I, _I, _L, _I, _P, _L, _P, _L, _P, _L, _P, _P, _P, _L, _P, _L,
                            _I, _F, _P],
    # partial-sum rows per sample: (H, W) for the conv, (B, M, C, dtype, vec) for the norm
    "fst_conv3x3_partials": [_I, _I],
    "fst_instance_norm_chunks": [_I, _I, _I, _I, _I],
}

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_lib = None
build_seconds = None  # wall time of the build (or 0.0 for a cached library)


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path() -> Path:
    """Path of the shared library for the current sources (built or not)."""
    return BUILD_DIR / f"libfst_kernels_{_digest(_sources())}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, proc in procs:  # wait for every compile before reporting
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        so = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(so, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.fst_error_string.argtypes = [ctypes.c_int]
        handle.fst_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib().fst_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def dtype_code(t) -> int:
    """Kernel dtype code of a tensor; raises for dtypes the kernels do not take."""
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[name]


def stream_of(t) -> int:
    """Raw handle of PyTorch's current CUDA stream on the tensor's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def uses_kernel(what: str, *tensors) -> bool:
    """Dispatch rule shared by every wrapper: all-CPU tensors take the plain
    PyTorch version (False); all tensors on one CUDA device launch the kernel
    (True); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{what}: no kernel for device {dev}")


def check_nhwc(x, what: str) -> None:
    """Layout check for the NHWC kernels: 4-D, contiguous, fp32 or bf16, non-empty."""
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(
            f"{what}: needs a non-empty contiguous [B, H, W, C] tensor, got shape "
            f"{tuple(x.shape)} strides {x.stride()}"
        )
    dtype_code(x)
