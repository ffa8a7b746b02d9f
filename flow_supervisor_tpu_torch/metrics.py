"""Flow metrics (counterpart of flow_supervisor_tpu/metrics.py).

- ``epe_per_image``: masked per-image mean endpoint error (-1 where the mask
  is empty).
- ``dense_metrics``: unmasked per-image EPE and 1 / 3 / 5-px accuracies.
- ``sparse_metrics``: the same over the pixels whose valid > 0.5, and KITTI's
  Fl-all, the share of them with epe > 3 and epe / |gt| > 0.05.
- ``angular_error``: per-pixel angle between (u, v, 1) vectors, radians.
"""
from __future__ import annotations

import torch


def _epe_map(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    d = pred - gt
    return torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))


def epe_per_image(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor | None = None):
    """[B] masked mean endpoint error per image (-1 where the mask is empty)."""
    epes = _epe_map(pred, gt)
    if valid is None:
        return torch.mean(epes, dim=(1, 2, 3))
    m = valid.float()
    total = torch.sum(epes * m, dim=(1, 2, 3))
    count = torch.sum(m, dim=(1, 2, 3))
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), -1.0)


def dense_metrics(pred: torch.Tensor, gt: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-image dense metrics, each [B]."""
    epes = _epe_map(pred, gt)
    out = {"epe": torch.mean(epes, dim=(1, 2, 3))}
    for n in (1, 3, 5):
        out[f"epe_{n}px"] = torch.mean((epes < float(n)).float(), dim=(1, 2, 3))
    return out


def sparse_metrics(
    pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Metrics over the valid pixels (valid > 0.5) of each image, each [B]:
    per image, as batch-1 evaluation pools them."""
    epes = _epe_map(pred, gt)
    mag = torch.sqrt(torch.sum(gt * gt, dim=-1, keepdim=True))
    m = (valid > 0.5).float()
    count = torch.clamp(torch.sum(m, dim=(1, 2, 3)), min=1.0)

    def masked_mean(x):
        return torch.sum(x * m, dim=(1, 2, 3)) / count

    fl = ((epes > 3.0) & (epes / torch.clamp(mag, min=1e-12) > 0.05)).float()
    out = {"epe": masked_mean(epes)}
    for n in (1, 3, 5):
        out[f"epe_{n}px"] = masked_mean((epes < float(n)).float())
    out["fl"] = masked_mean(fl)
    return out


def angular_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Angular error in radians per pixel, [B, H, W]."""
    p = torch.cat([pred, torch.ones_like(pred[..., :1])], dim=-1)
    g = torch.cat([gt, torch.ones_like(gt[..., :1])], dim=-1)
    cos = torch.sum(p * g, dim=-1) / (torch.linalg.norm(p, dim=-1) * torch.linalg.norm(g, dim=-1))
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))
