"""Middlebury ``.flo`` files (same format as flow_supervisor_tpu/data/io.py
``write_flo`` / ``read_flo``: float32 tag 202021.25, int32 width, int32
height, then [H, W, 2] float32 row-major). numpy only."""
from __future__ import annotations

import numpy as np

TAG_FLO = 202021.25


def write_flo(path: str, flow: np.ndarray) -> None:
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([TAG_FLO], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        np.ascontiguousarray(flow, np.float32).tofile(f)


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != TAG_FLO:
            raise ValueError(f"invalid .flo magic in {path}")
        w, h = (int(v) for v in np.fromfile(f, np.int32, count=2))
        data = np.fromfile(f, np.float32, count=2 * w * h)
    if data.size != 2 * w * h:
        raise ValueError(f"truncated .flo file {path}")
    return data.reshape(h, w, 2)
