"""The evaluation's warm start, plain: the previous pair's low-resolution
flow splatted forward onto the next pair's grid by nearest-neighbour
``griddata`` (RAFT's ``forward_interpolate``, core/utils/utils.py)."""
from __future__ import annotations

import numpy as np
from scipy import interpolate


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """[h, w, 2] low-resolution flow -> [h, w, 2] float32, splatted forward."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    x0, y0 = np.meshgrid(np.arange(w), np.arange(h))
    pts = np.stack([(x0 + flow[..., 0]).ravel(), (y0 + flow[..., 1]).ravel()], -1)
    xi = np.stack([x0.ravel(), y0.ravel()], -1).astype(np.float32)
    out = [interpolate.griddata(pts, flow[..., i].ravel(), xi, method="nearest", fill_value=0)
           for i in range(2)]
    return np.stack([o.reshape(h, w) for o in out], -1).astype(np.float32)
