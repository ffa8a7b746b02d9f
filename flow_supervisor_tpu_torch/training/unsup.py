"""Unsupervised (SMURF-style) train step (counterpart of
flow_supervisor_tpu/training/unsup.py ``make_unsup_train_step``).

The teacher is the same network on the full original frames, in training
mode and without gradient: with unfrozen batch norm it updates the running
statistics before the student's pass, as the JAX step threads them. Only its
final flows are read (the self-supervision targets), so only its last
iteration is upsampled. The student runs on the augmented crop with
gradient; ``unsupervised_sequence_loss`` (census, smoothness, self-
supervision; per-update decay) takes the unaugmented crops cut from the
originals, the full frames and the crop offsets for the full-size warping
branch.

Batch contract (tensors on the model's device): {'image1', 'image2': [B, h,
w, 3] crops, 'orig_image1', 'orig_image2': [B, H, W, 3] frames, 'crop_yx':
int [B, 2] (y, x)}, and optionally {'flow', 'valid'} for the epe metric only.
In a data-parallel world (parallel/mesh.py) the gradients and the log are
averaged over the ranks before the optimizer step; a no-op in a world of 1.
"""
from __future__ import annotations

from typing import Any

import torch

from flow_supervisor_tpu_torch.losses.unsupervised import (
    UnsupLossConfig,
    unsupervised_sequence_loss,
)
from flow_supervisor_tpu_torch.metrics import epe_per_image
from flow_supervisor_tpu_torch.ops.pad import crop_bboxes
from flow_supervisor_tpu_torch.parallel import mesh
from flow_supervisor_tpu_torch.training.state import TrainState, grads_of


def smurf_images(batch: dict[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
    """(unaugmented crops [B, 2, h, w, 3] cut from the originals at crop_yx,
    full frames [B, 2, H, W, 3]): the census targets of the SMURF loss."""
    h, w = batch["image1"].shape[1:3]
    crops = [crop_bboxes(batch[k], batch["crop_yx"], (h, w)) for k in ("orig_image1", "orig_image2")]
    return torch.stack(crops, 1), torch.stack([batch["orig_image1"], batch["orig_image2"]], 1)


def make_unsup_train_step(model, model_cfg, debug_grads: bool = False):
    cfg = UnsupLossConfig.from_model_cfg(model_cfg)
    named = list(model.named_parameters())

    def train_step(state: TrainState, batch: dict[str, Any]):
        model.train()
        with torch.no_grad():
            teacher = model.unsup_forward(batch["orig_image1"], batch["orig_image2"],
                                          final_flow_only=True)
        images, full = smurf_images(batch)
        out = model.unsup_forward(batch["image1"], batch["image2"])
        loss, terms = unsupervised_sequence_loss(
            images, out["flow_up"], out["flow_up_bw"], cfg,
            teacher_flow_fw=teacher["flow_up"][-1], teacher_flow_bw=teacher["flow_up_bw"][-1],
            full_size_images=full, crop_yx=batch["crop_yx"],
        )
        grads = mesh.all_reduce_grads(grads_of(loss, named))
        log = {"loss": loss.detach(), **{k: v.detach() for k, v in terms.items()}}
        if "flow" in batch:
            log["epe"] = torch.mean(epe_per_image(
                out["flow_up"][-1].detach(), batch["flow"], batch.get("valid")))
        log = mesh.mean_log(log)
        if debug_grads:
            log["_grads"] = grads
        return state.apply_gradients(grads), log

    return train_step
