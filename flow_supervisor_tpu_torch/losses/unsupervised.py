"""Unsupervised (SMURF-style) loss (counterpart of
flow_supervisor_tpu/losses/unsupervised.py). Flow channels are (x, y).

- per flow direction (0->1 and 1->0 of the student): census loss on the
  image warped by the flow under the detached occlusion x valid-warp mask,
  edge-aware smoothness at full resolution (each update has one flow level),
  and optional self-supervision against the teacher's final flows; each
  direction counts half;
- the full-size warping branch (both train steps have the full frames): the
  crop's flow is zero-padded into the full frame at each sample's crop
  offset, the full-size second image (detached) is warped there, and the
  result and the valid-warp mask are cropped back, so flow vectors that
  leave the crop still supervise;
- ``unsupervised_sequence_loss`` ('unsup_per_update'): the same loss at each
  update, total_k = loss_k(i) + total_k * gamma over the iterations i.

Under data parallelism the census term takes a global normalizer
(losses/photometric.py); the smoothness and self-supervision terms are
means, exact under equal shards; the occlusion masks are per pixel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from flow_supervisor_tpu_torch.losses.occlusion import compute_occlusions, mask_invalid
from flow_supervisor_tpu_torch.losses.photometric import census_loss
from flow_supervisor_tpu_torch.losses.selfsup import self_supervision_loss
from flow_supervisor_tpu_torch.losses.smoothness import (
    first_order_smoothness_loss,
    second_order_smoothness_loss,
)
from flow_supervisor_tpu_torch.ops.pad import crop_bboxes, pad_bboxes
from flow_supervisor_tpu_torch.ops.resampler import resampler
from flow_supervisor_tpu_torch.ops.warp import flow_to_warp


@dataclasses.dataclass(frozen=True)
class UnsupLossConfig:
    census: float = 1.0
    smooth1: float = 0.0
    smooth2: float = 2.0
    selfsup: float = 0.0
    occlusion: str = "wang"  # wang | brox | none
    gamma: float = 0.8  # per-update sequence decay

    def active_weights(self) -> dict[str, float]:
        return {k: getattr(self, k) for k in ("census", "smooth1", "smooth2", "selfsup")
                if getattr(self, k) > 0.0}

    @classmethod
    def from_model_cfg(cls, mc, selfsup: Optional[float] = None) -> "UnsupLossConfig":
        """The loss a ModelCfg asks for; ``selfsup`` overrides its weight."""
        return cls(census=mc.census_weight, smooth1=mc.smooth1_weight,
                   smooth2=mc.smooth2_weight,
                   selfsup=mc.selfsup_weight if selfsup is None else selfsup,
                   occlusion=mc.occlusion, gamma=mc.unsup_loss_decay_rate)


def _warped_image_and_mask(flow, full_size_image_j, crop_yx):
    """Census warp target and valid mask by the full-size branch."""
    h, w = flow.shape[1], flow.shape[2]
    fh, fw = full_size_image_j.shape[1], full_size_image_j.shape[2]
    warp = flow_to_warp(pad_bboxes(flow, crop_yx, (fh, fw)))
    warped = resampler(full_size_image_j.detach(), warp)
    return crop_bboxes(warped, crop_yx, (h, w)), crop_bboxes(mask_invalid(warp), crop_yx, (h, w))


def unsupervised_loss(
    images: torch.Tensor,  # [B, 2, H, W, 3] unaugmented crop-frame images
    flow_fw: torch.Tensor,  # [B, H, W, 2] student flows 0->1 and 1->0
    flow_bw: torch.Tensor,
    cfg: UnsupLossConfig,
    full_size_images: torch.Tensor,  # [B, 2, FH, FW, 3]
    crop_yx: torch.Tensor,  # [B, 2] int (y, x)
    teacher_fw: Optional[torch.Tensor] = None,  # full-frame teacher flows (selfsup only)
    teacher_bw: Optional[torch.Tensor] = None,
) -> dict[str, torch.Tensor]:
    weights = cfg.active_weights()
    losses = {k: torch.zeros((), dtype=torch.float32, device=images.device) for k in weights}
    directions = ((0, 1, flow_fw, flow_bw, teacher_fw, teacher_bw),
                  (1, 0, flow_bw, flow_fw, teacher_bw, teacher_fw))
    for ti, tj, flow, back, t_flow, t_back in directions:
        warped_image, valid_warp_mask = _warped_image_and_mask(
            flow, full_size_images[:, tj], crop_yx)
        occlusion_mask = compute_occlusions(flow, back, cfg.occlusion)
        mask_level0 = (occlusion_mask * valid_warp_mask).detach()
        terms = {}
        if "census" in weights:
            terms["census"] = census_loss(images[:, ti], warped_image, mask_level0)
        if "smooth1" in weights:
            terms["smooth1"] = first_order_smoothness_loss(images[:, ti], flow)
        if "smooth2" in weights:
            terms["smooth2"] = second_order_smoothness_loss(images[:, ti], flow)
        if "selfsup" in weights:
            terms["selfsup"] = self_supervision_loss(t_flow, flow, t_back, back, crop_yx)
        for k, v in terms.items():
            losses[k] = losses[k] + weights[k] * v / 2.0
    return losses


def unsupervised_sequence_loss(
    images: torch.Tensor,
    flows_fw: torch.Tensor,  # [iters, B, H, W, 2] forward predictions
    flows_bw: torch.Tensor,  # [iters, B, H, W, 2] backward predictions
    cfg: UnsupLossConfig,
    full_size_images: torch.Tensor,
    crop_yx: torch.Tensor,
    teacher_flow_fw: Optional[torch.Tensor] = None,  # final teacher fw (full frame)
    teacher_flow_bw: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """-> (total, per-term dict): the loss at every update, decayed by gamma;
    the final teacher flows are the self-supervision targets."""
    totals: dict[str, torch.Tensor] = {}
    for i in range(flows_fw.shape[0]):
        d = unsupervised_loss(images, flows_fw[i], flows_bw[i], cfg, full_size_images, crop_yx,
                              teacher_flow_fw, teacher_flow_bw)
        for k, v in d.items():
            totals[k] = v if k not in totals else v + totals[k] * cfg.gamma
    total = torch.zeros((), dtype=torch.float32, device=images.device)
    for v in totals.values():
        total = total + v
    return total, totals
