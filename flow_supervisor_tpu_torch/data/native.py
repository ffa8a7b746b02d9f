"""The port's host I/O library (``native/fst_io.cc``): the ``.flo``, ``.ppm``
and ``.pfm`` readers, their threaded batch forms and a baseline JPEG
decoder, bound with ``ctypes`` (counterpart of flow_supervisor_tpu/data/native.py
over the repository's native/fst_io.cc, with JAX's names and results).

The library is compiled at first use by ``g++ -O3 -shared -fPIC
-std=c++17 -pthread`` into ``flow_supervisor_tpu_torch/_build/``
(git-ignored), named by a hash of its source and flags, built in a
temporary directory and renamed into place, so that processes building it
at once all load a whole file. It is a host library of its own, apart from
the CUDA kernels' (``kernels/_build.py``): it builds and loads without a
card. A failed build raises with g++'s stderr, and no reader falls back to
numpy: the numpy readers of ``data/io.py`` (``read_flo_plain``,
``read_pfm_plain``, ``read_ppm``) are the plain versions the tests hold
these against. ctypes releases the GIL during each call.

- ``read_flo`` -> [H, W, 2] float32; ``read_pfm`` -> [H, W, 3] or [H, W]
  float32, top row first; ``read_ppm`` -> [H, W, 3] float32, each sample /
  255 (as cv2 then numpy's division give it; JAX's native reader
  multiplies by 1/255 instead, which differs in the last bit of some
  values);
- ``read_flo_batch`` / ``read_ppm_batch``: files of one size, read by
  ``threads`` workers into one array;
- ``decode_jpeg(data)`` / ``read_jpeg(path)`` -> [H, W, 3] uint8 RGB,
  sample for sample what cv2.imread (libjpeg-turbo) gives for baseline
  files; a ``ValueError`` naming the file and the reason for the files it
  refuses (progressive, lossless, arithmetic-coded, not 8-bit, CMYK,
  truncated).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "fst_io.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_paths = ctypes.POINTER(ctypes.c_char_p)
_I, _L, _S = ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p
SIGNATURES = {
    "fst_flo_dims": [_S, _i32p],
    "fst_read_flo": [_S, _f32p, _I, _I],
    "fst_ppm_dims": [_S, _i32p],
    "fst_read_ppm": [_S, _f32p, _I, _I],
    "fst_pfm_dims": [_S, _i32p],
    "fst_read_pfm": [_S, _f32p, _I, _I, _I],
    "fst_read_flo_batch": [_paths, _I, _f32p, _I, _I, _I],
    "fst_read_ppm_batch": [_paths, _I, _f32p, _I, _I, _I],
    "fst_jpeg_info": [ctypes.c_void_p, _L, _i32p, ctypes.c_char_p, _I],
    "fst_jpeg_decode": [ctypes.c_void_p, _L, _u8p, _I, _I, ctypes.c_char_p, _I],
}
_ERR_LEN = 256

_lib = None
build_seconds = None  # wall time of the build (0.0 for a library already built)


def library_path() -> Path:
    """Path of the library for the current source (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfst_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, out.name)
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", so]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"the host I/O library needs g++ to build: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(so, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The bound host library, built at first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _fail(path: str, what: str, rc: int):
    """Raise for a reader's nonzero return: the OS's error for a file it
    cannot open, else a ValueError."""
    if rc == 1:
        open(path, "rb").close()  # raises FileNotFoundError / PermissionError
        raise OSError(f"cannot read {path}")
    raise ValueError(f"{path}: not a valid {what} file (native reader code {rc})")


def _dims(fn: str, path: str, n: int, what: str) -> list[int]:
    dims = (ctypes.c_int32 * n)()
    rc = getattr(lib(), fn)(path.encode(), dims)
    if rc != 0:
        _fail(path, what, rc)
    return list(dims)


def read_flo(path: str) -> np.ndarray:
    """[H, W, 2] float32 of a Middlebury .flo file."""
    h, w = _dims("fst_flo_dims", path, 2, ".flo")
    out = np.empty((h, w, 2), np.float32)
    rc = lib().fst_read_flo(path.encode(), _fptr(out), h, w)
    if rc != 0:
        _fail(path, ".flo", rc)
    return out


def read_ppm(path: str) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1] of a binary (P6) PPM file with 8-bit samples."""
    h, w = _dims("fst_ppm_dims", path, 2, "binary (P6) 8-bit PPM")
    out = np.empty((h, w, 3), np.float32)
    rc = lib().fst_read_ppm(path.encode(), _fptr(out), h, w)
    if rc != 0:
        _fail(path, "binary (P6) 8-bit PPM", rc)
    return out


def read_pfm(path: str) -> np.ndarray:
    """[H, W, 3] (PF) or [H, W] (Pf) float32 of a PFM file, top row first."""
    h, w, c = _dims("fst_pfm_dims", path, 3, "PFM")
    out = np.empty((h, w, c) if c > 1 else (h, w), np.float32)
    rc = lib().fst_read_pfm(path.encode(), _fptr(out), h, w, c)
    if rc != 0:
        _fail(path, "PFM", rc)
    return out


def _batch(fn: str, paths: Sequence[str], shape: tuple, threads: int) -> np.ndarray:
    out = np.empty((len(paths), *shape), np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    fails = getattr(lib(), fn)(arr, len(paths), _fptr(out), shape[0], shape[1], threads)
    if fails:
        raise OSError(f"{fails} of {len(paths)} files failed to load")
    return out


def read_flo_batch(paths: Sequence[str], h: int, w: int, threads: int = 4) -> np.ndarray:
    """[N, h, w, 2] float32 of N .flo files of one size."""
    return _batch("fst_read_flo_batch", paths, (h, w, 2), threads)


def read_ppm_batch(paths: Sequence[str], h: int, w: int, threads: int = 4) -> np.ndarray:
    """[N, h, w, 3] float32 in [0, 1] of N binary PPM files of one size."""
    return _batch("fst_read_ppm_batch", paths, (h, w, 3), threads)


def jpeg_info(data: bytes, name: str = "<bytes>") -> tuple[int, int, int]:
    """(height, width, components) of a JPEG file's bytes."""
    dims = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib().fst_jpeg_info(data, len(data), dims, err, _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return dims[0], dims[1], dims[2]


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """[H, W, 3] uint8 RGB of a baseline JPEG file's bytes (a grey image as
    three equal channels); ``name`` goes into the error message."""
    h, w, _ = jpeg_info(data, name)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib().fst_jpeg_decode(data, len(data), out.ctypes.data_as(_u8p), h, w, err, _ERR_LEN)
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB of a baseline JPEG file."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, path)
