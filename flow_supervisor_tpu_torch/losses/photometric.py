"""Census (soft-hamming) photometric loss (counterpart of
flow_supervisor_tpu/losses/photometric.py).

- census transform: grayscale (0.299 R + 0.587 G + 0.114 B) * 255, the 7x7
  zero-padded neighbourhood differences d (one ``unfold``, neighbours in
  row-major order, where JAX stacks 49 slices), normalized d / sqrt(0.81 + d^2);
- soft hamming: sum_k d^2 / (0.1 + d^2);
- distance: (|x| + 0.01)^0.4;
- the mask is zeroed on a 3-pixel (PATCH // 2) border, and the normalizer is
  sum(mask + 1e-6) over all elements, i.e. sum(mask) + 1e-6 * numel.

The normalizer counts the mask over the whole batch. In a data-parallel
world each rank divides its shard's sum by the mean of the ranks'
normalizers (``mesh.global_mean``; the mask is detached), so the average of
the ranks' losses, and of their gradients, is the global batch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from flow_supervisor_tpu_torch.parallel import mesh

PATCH = 7  # census neighbourhood


def robust_l1(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x * x + 0.001**2)


def abs_robust_loss(diff: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.abs(diff) + 0.01, 0.4)


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype, device=image.device)
    return torch.sum(image * w, dim=-1, keepdim=True)


def census_transform(image: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H, W, PATCH^2] normalized neighbour differences."""
    b, h, w, _ = image.shape
    intensities = rgb_to_grayscale(image) * 255.0  # [B, H, W, 1]
    neighbors = F.unfold(intensities.permute(0, 3, 1, 2), PATCH, padding=PATCH // 2)
    neighbors = neighbors.reshape(b, PATCH * PATCH, h, w).permute(0, 2, 3, 1)
    diff = neighbors - intensities
    return diff / torch.sqrt(0.81 + diff * diff)


def soft_hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sq = (a - b) ** 2
    return torch.sum(sq / (0.1 + sq), dim=3, keepdim=True)


def zero_mask_border(mask: torch.Tensor) -> torch.Tensor:
    p = PATCH // 2
    return F.pad(mask[:, p:-p, p:-p, :], (0, 0, p, p, p, p))


def census_loss(image_a: torch.Tensor, image_b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    hamming = soft_hamming(census_transform(image_a), census_transform(image_b))
    padded_mask = zero_mask_border(mask)
    diff = abs_robust_loss(hamming) * padded_mask
    return torch.sum(diff) / mesh.global_mean(torch.sum(padded_mask.detach() + 1e-6))
