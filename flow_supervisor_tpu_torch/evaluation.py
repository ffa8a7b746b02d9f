"""Single-pair inference as the evaluator runs it (counterpart of
flow_supervisor_tpu/evaluation.py ``Evaluator._run_pair``): replicate-edge pad
to a multiple of 8, forward with ``final_flow_only``, unpad."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flow_supervisor_tpu_torch.ops.pad import pad_spec_for


def run_pair(
    model,
    img1: np.ndarray,
    img2: np.ndarray,
    mode: str = "sintel",
    flow_init: Optional[np.ndarray] = None,
    iters: int = 12,
) -> tuple[np.ndarray, np.ndarray]:
    """img1/img2: [H, W, 3] in [0, 1]; flow_init: [h8, w8, 2] at the padded
    1/8 resolution. Returns (flow [H, W, 2], flow_low [h8, w8, 2]) as float32."""
    device = next(model.parameters()).device
    spec = pad_spec_for(img1.shape[0], img1.shape[1], mode=mode)
    (t, b), (l, r) = spec

    def prep(img):
        x = np.pad(np.asarray(img, np.float32), ((t, b), (l, r), (0, 0)), mode="edge")
        return torch.from_numpy(x[None]).to(device)

    init = None
    if flow_init is not None:
        init = torch.from_numpy(np.asarray(flow_init, np.float32)[None]).to(device)
    out = model(prep(img1), prep(img2), flow_init=init, iters=iters, final_flow_only=True)
    flow = out["flow_up"][-1, 0].float().cpu().numpy()
    flow = flow[t : flow.shape[0] - b, l : flow.shape[1] - r]
    return flow, out["flow_low"][-1, 0].float().cpu().numpy()
