"""Flow metrics (counterpart of flow_supervisor_tpu/metrics.py ``epe_per_image``)."""
from __future__ import annotations

import torch


def epe_per_image(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor | None = None):
    """[B] masked mean endpoint error per image (-1 where the mask is empty)."""
    d = pred - gt
    epes = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    if valid is None:
        return torch.mean(epes, dim=(1, 2, 3))
    m = valid.float()
    total = torch.sum(epes * m, dim=(1, 2, 3))
    count = torch.sum(m, dim=(1, 2, 3))
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), -1.0)
