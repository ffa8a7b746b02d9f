"""Flow visualization (counterpart of flow_supervisor_tpu/utils/viz.py, the
same numpy code line for line).

- ``visualize_flow``: HSV wheel — hue = flow angle, saturation = magnitude
  normalized by the max (or a given max), value = 1
  (reference ``util/visualize.py:5-27``).
- ``flow_to_rgb_wheel``: the Baker et al. color wheel used by the torch tree
  (reference ``pytorch/core/utils/flow_viz.py``) for submission-style renders.
"""
from __future__ import annotations

import numpy as np


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.zeros(hsv.shape, hsv.dtype)
    for idx, (r, g, b) in enumerate(
        [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    ):
        m = i == idx
        out[..., 0] = np.where(m, r, out[..., 0])
        out[..., 1] = np.where(m, g, out[..., 1])
        out[..., 2] = np.where(m, b, out[..., 2])
    return out


def visualize_flow(flow: np.ndarray, max_mag: float | None = None) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] RGB float in [0, 1]."""
    x, y = flow[..., 0], flow[..., 1]
    rho = np.sqrt(x**2 + y**2)
    phi = np.arctan2(y, x)
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    if max_mag is None:
        max_mag = rho.max()
        if max_mag == 0:
            max_mag = 1.0
    rho = np.clip(rho / max_mag, 0.0, 1.0)
    hsv = np.stack([phi / (2 * np.pi), rho, np.ones_like(rho)], axis=-1)
    return _hsv_to_rgb(hsv.astype(np.float32))


def _make_colorwheel() -> np.ndarray:
    """Baker et al. (ICCV 2007) color wheel, 55 bins."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def flow_to_rgb_wheel(flow: np.ndarray, clip_flow: float | None = None) -> np.ndarray:
    """[H, W, 2] -> uint8 [H, W, 3] using the Baker color wheel."""
    if clip_flow is not None:
        flow = np.clip(flow, -clip_flow, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u**2 + v**2)

    wheel = _make_colorwheel()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    out = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        out[..., i] = np.floor(255 * col)
    return out
