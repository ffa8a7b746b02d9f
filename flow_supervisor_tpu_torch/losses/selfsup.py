"""Self-supervision loss, teacher vs student (counterpart of
flow_supervisor_tpu/losses/selfsup.py): gaussian forward-backward
consistency masks (sigma 0.003 for the teacher, 0.03 for the student), the
student's mask INVERTED (supervise where the student is inconsistent and the
teacher consistent), the teacher's flow and mask cropped from full-frame
coordinates to the student's window, robust_l1 error with the teacher flow
and the combined mask detached.

Data parallelism needs nothing here: each loss is a mean over all its
elements, and with equal shards the average of the ranks' means (the
gradients' all-reduce) is the global batch's mean.
"""
from __future__ import annotations

import torch

from flow_supervisor_tpu_torch.losses.occlusion import mask_invalid
from flow_supervisor_tpu_torch.losses.photometric import robust_l1
from flow_supervisor_tpu_torch.ops.pad import crop_bboxes
from flow_supervisor_tpu_torch.ops.resampler import resampler
from flow_supervisor_tpu_torch.ops.warp import flow_to_warp

FB_SIGMA_TEACHER = 0.003
FB_SIGMA_STUDENT = 0.03


def _fb_consistent(flow, backward_flow, sigma, h, w):
    """Gaussian forward-backward consistency times the valid-warp mask."""
    warp = flow_to_warp(flow)
    bwd = resampler(backward_flow, warp)
    fb_sq_diff = torch.sum((flow + bwd) ** 2, dim=-1, keepdim=True)
    return torch.exp(-fb_sq_diff / (sigma**2 * (h**2 + w**2))) * mask_invalid(warp)


def self_supervision_loss(
    teacher_flow: torch.Tensor,
    student_flow: torch.Tensor,
    teacher_backward_flow: torch.Tensor,
    student_backward_flow: torch.Tensor,
    crop_yx: torch.Tensor,  # [B, 2] int (y, x) of the student window
) -> torch.Tensor:
    h = float(teacher_flow.shape[-3])
    w = float(teacher_flow.shape[-2])
    sh, sw = student_flow.shape[-3], student_flow.shape[-2]
    student_mask = 1.0 - _fb_consistent(
        student_flow, student_backward_flow, FB_SIGMA_STUDENT, h, w)
    teacher_mask = _fb_consistent(teacher_flow, teacher_backward_flow, FB_SIGMA_TEACHER, h, w)
    teacher_mask = crop_bboxes(teacher_mask, crop_yx, (sh, sw))
    teacher_flow = crop_bboxes(teacher_flow, crop_yx, (sh, sw))
    error = robust_l1(teacher_flow.detach() - student_flow)
    mask = (teacher_mask * student_mask).detach()
    return torch.mean(mask * error)
