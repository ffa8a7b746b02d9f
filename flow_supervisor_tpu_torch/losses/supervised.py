"""Supervised sequence losses (counterpart of flow_supervisor_tpu/losses/supervised.py).

Penalties are elementwise per flow channel, then averaged over everything
(a mask-multiplied mean, not a mask-weighted one):

- l1:     |d_c|
- l2:     d_c^2
- robust: sqrt(d_c^2 + 0.001^2)   (per-channel Charbonnier)

each multiplied by the mask ``valid`` (if given) and by ||gt||_2 < 400 px.
``sequence_loss`` = sum_i gamma^(N-1-i) * loss_i over predictions stacked
[iters, B, H, W, 2].

Data parallelism needs nothing here: each loss is a mean over all its
elements, and with equal shards the average of the ranks' means (the
gradients' all-reduce) is the global batch's mean.
"""
from __future__ import annotations

from typing import Callable

import torch

MAX_FLOW = 400.0


def _mask(flow_gt: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    mag = torch.sqrt(torch.sum(flow_gt * flow_gt, dim=-1, keepdim=True))
    m = (mag < MAX_FLOW).float()
    if valid is not None:
        m = m * valid.float()
    return m


def flow_loss_l1(pred, flow_gt, valid=None):
    return torch.mean(torch.abs(pred - flow_gt) * _mask(flow_gt, valid))


def flow_loss_l2(pred, flow_gt, valid=None):
    d = pred - flow_gt
    return torch.mean(d * d * _mask(flow_gt, valid))


def flow_loss_robust(pred, flow_gt, valid=None):
    d = pred - flow_gt
    return torch.mean(torch.sqrt(d * d + 0.001**2) * _mask(flow_gt, valid))


LOSSES: dict[str, Callable] = {
    "l1": flow_loss_l1,
    "l2": flow_loss_l2,
    "robust": flow_loss_robust,
}


def sequence_loss(
    preds: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor | None = None,
    gamma: float = 0.8,
    loss: str | Callable = "robust",
) -> torch.Tensor:
    """gamma-decayed sum of per-iteration losses; preds: [iters, B, H, W, 2]."""
    fn = LOSSES[loss] if isinstance(loss, str) else loss
    n = preds.shape[0]
    weights = torch.tensor([gamma ** (n - 1 - i) for i in range(n)], dtype=torch.float32,
                           device=preds.device)
    per_iter = torch.stack([fn(p, flow_gt, valid) for p in preds])
    return torch.sum(weights * per_iter)
