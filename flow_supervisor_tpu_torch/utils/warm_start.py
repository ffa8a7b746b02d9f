"""Warm-start forward interpolation on the host (counterpart of
flow_supervisor_tpu/utils/warm_start.py): the previous pair's low-resolution
flow splatted forward onto the next pair's grid by scipy's nearest-neighbour
``griddata``, the reference's own call (pytorch/core/utils/utils.py:26-54),
in the span ``fst.warm_start``."""
from __future__ import annotations

import numpy as np
from scipy import interpolate

from flow_supervisor_tpu_torch.tracing import span


def forward_interpolate(flow: np.ndarray, host: dict | None = None) -> np.ndarray:
    """[H, W, 2] low-res flow -> forward-splatted flow for the next frame;
    ``host`` adds the splat's host seconds under ``warm_start``."""
    with span("fst.warm_start", host):
        flow = np.asarray(flow, np.float32)
        dx, dy = flow[..., 0], flow[..., 1]
        ht, wd = dx.shape
        x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
        pts = np.stack(((x0 + dx).reshape(-1), (y0 + dy).reshape(-1)), axis=-1)
        xi = np.stack((x0.reshape(-1), y0.reshape(-1)), axis=-1).astype(np.float32)
        flow_x = interpolate.griddata(pts, dx.reshape(-1), xi, method="nearest", fill_value=0)
        flow_y = interpolate.griddata(pts, dy.reshape(-1), xi, method="nearest", fill_value=0)
        return np.stack([flow_x.reshape(ht, wd), flow_y.reshape(ht, wd)],
                        axis=-1).astype(np.float32)
