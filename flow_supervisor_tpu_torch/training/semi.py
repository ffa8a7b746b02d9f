"""Flow-supervisor (semi-supervised) train step (counterpart of
flow_supervisor_tpu/training/semi.py ``make_semi_train_step``).

- SUP branch (forward direction only): the student's sequence loss against
  the labels (gamma = loss_decay_rate, x sup_label_loss_weight) plus L_fl,
  the teacher's sequence loss against the labels (gamma =
  lfl_loss_decay_rate, x lfl_weight).
- UNSUP branch: L_fr, the student's (fw + bw) sequence loss against the
  teacher's final prediction without gradient (lfr_loss_type, gamma =
  loss_decay_rate, x lfr_weight); with ``lfr_sum_reduction`` the branch's
  loss is multiplied by B*H*W of the student crop (the reference's pixel-sum
  gradient; B the global batch under data parallelism). Without the teacher SMURF loss the teacher runs without
  gradient there: only its final prediction is used, as a target.
- teacher SMURF (``teacher_smurf_weight > 0``): the unsupervised loss
  (census, smoothness, occlusion; self-supervision forced to 0, as the
  reference does) over every teacher iteration of both directions, with
  gradient into the teacher head, against the unaugmented crops cut from the
  originals and with the full-size warping branch; added to the unsup
  branch's loss x teacher_smurf_weight (and x B*H*W with
  ``lfr_sum_reduction``, like every term of that branch).
- Each branch has its own backward pass; the gradients merge per variable,
  g = sup_weight * g_sup + unsup_weight * g_unsup, a variable that a branch
  does not reach counting zero from it.
- In a data-parallel world (parallel/mesh.py) the merged gradients and the
  log are averaged over the ranks before the optimizer step (a no-op in a
  world of 1); every other reduction is a mean, exact under equal shards,
  or the census loss's global normalizer.

Batch contract (tensors on the model's device):
  sup:   {'image1','image2','orig_image1','orig_image2','crop_yx','flow','valid'}
  unsup: {'image1','image2','orig_image1','orig_image2','crop_yx'}
images [B, H, W, 3] in [0, 1] (crops [B, h, w, 3] and full frames), crop_yx
int [B, 2] (y, x) multiples of 8, flow [B, h, w, 2], valid [B, h, w, 1].
"""
from __future__ import annotations

from typing import Any

import torch

from flow_supervisor_tpu_torch.losses.supervised import sequence_loss
from flow_supervisor_tpu_torch.losses.unsupervised import (
    UnsupLossConfig,
    unsupervised_sequence_loss,
)
from flow_supervisor_tpu_torch.metrics import epe_per_image
from flow_supervisor_tpu_torch.parallel import mesh
from flow_supervisor_tpu_torch.tracing import span
from flow_supervisor_tpu_torch.training.state import TrainState, grads_of
from flow_supervisor_tpu_torch.training.unsup import smurf_images


def make_semi_train_step(
    model,
    model_cfg,  # ModelCfg: weights, decay rates, loss types
    gamma: float = 0.8,  # loss_decay_rate (TrainCfg)
    sup_loss_type: str = "robust",
    debug_grads: bool = False,  # put the merged gradients in the log as "_grads"
):
    mc = model_cfg
    if not model.cfg.freeze_bn:
        raise ValueError("semi training requires RAFTConfig(freeze_bn=True) (reference parity)")
    if (mc.lfr_weight > 0.0 or mc.teacher_smurf_weight > 0.0) and not mc.use_bw:
        raise ValueError("L_fr and the teacher SMURF loss read both directions: use_bw=True")
    smurf = mc.teacher_smurf_weight > 0.0
    # the teacher SMURF loss never takes the self-supervision term
    unsup_cfg = UnsupLossConfig.from_model_cfg(mc, selfsup=0.0)
    named = list(model.named_parameters())

    @span("fst.train.forward")
    def semi(batch, **kw):
        return model.semi_forward(
            batch["image1"], batch["image2"], batch["orig_image1"], batch["orig_image2"],
            batch["crop_yx"], **kw,
        )

    def sup_loss_fn(batch):
        out = semi(batch, use_bw=False)
        log = {}
        with span("fst.train.loss"):
            total = sequence_loss(
                out["student_fw"], batch["flow"], batch["valid"], gamma=gamma, loss=sup_loss_type
            ) * mc.sup_label_loss_weight
            log["sup_label_loss"] = total
            if mc.lfl_weight > 0.0:
                lfl = sequence_loss(
                    out["teacher_fw"], batch["flow"], batch["valid"],
                    gamma=mc.lfl_loss_decay_rate, loss=sup_loss_type,
                ) * mc.lfl_weight
                log["lfl_loss"] = lfl
                total = total + lfl
        log["sup_loss"] = total
        return total, log, out["student_fw"][-1]

    def unsup_loss_fn(batch):
        out = semi(batch, use_bw=mc.use_bw, teacher_final_only=not smurf, teacher_grad=smurf)
        log = {}
        with span("fst.train.loss"):
            total = torch.zeros((), dtype=torch.float32, device=batch["image1"].device)
            if smurf:
                images, full = smurf_images(batch)
                smurf_total, _ = unsupervised_sequence_loss(
                    images, out["teacher_fw"], out["teacher_bw"], unsup_cfg,
                    full_size_images=full, crop_yx=batch["crop_yx"],
                )
                log["teacher_smurf_loss"] = smurf_total
                total = total + smurf_total * mc.teacher_smurf_weight
            if mc.lfr_weight > 0.0:
                lfr = sequence_loss(
                    out["student_fw"], out["teacher_fw"][-1].detach(), None, gamma=gamma,
                    loss=mc.lfr_loss_type,
                ) + sequence_loss(
                    out["student_bw"], out["teacher_bw"][-1].detach(), None, gamma=gamma,
                    loss=mc.lfr_loss_type,
                )
                lfr = lfr * mc.lfr_weight
                log["lfr_loss"] = lfr
                total = total + lfr
                if mc.lfr_sum_reduction:
                    b, h, w = batch["image1"].shape[0:3]
                    total = total * float(b * mesh.world_size() * h * w)
        log["unsup_loss"] = total
        return total, log

    def train_step(state: TrainState, sup_batch: dict[str, Any], unsup_batch: dict[str, Any]):
        model.train()
        log, grads = {}, None
        if mc.sup_weight > 0.0:
            loss, sup_log, final_pred = sup_loss_fn(sup_batch)
            g_sup = grads_of(loss, named)
            log.update({k: v.detach() for k, v in sup_log.items()})
            log["epe"] = torch.mean(
                epe_per_image(final_pred.detach(), sup_batch["flow"], sup_batch["valid"])
            )
            grads = {k: mc.sup_weight * g for k, g in g_sup.items()}
        if mc.unsup_weight > 0.0:
            loss, unsup_log = unsup_loss_fn(unsup_batch)
            g_unsup = grads_of(loss, named) if loss.requires_grad else {
                n: torch.zeros_like(p) for n, p in named}
            log.update({k: v.detach() for k, v in unsup_log.items()})
            if grads is None:
                grads = {k: mc.unsup_weight * g for k, g in g_unsup.items()}
            else:
                grads = {k: grads[k] + mc.unsup_weight * g for k, g in g_unsup.items()}
        grads = mesh.all_reduce_grads(grads)
        log = mesh.mean_log(log)
        if debug_grads:
            log["_grads"] = grads
        return state.apply_gradients(grads), log

    return train_step
