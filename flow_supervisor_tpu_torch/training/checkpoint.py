"""Weight transplants between models, on state dicts in memory (counterpart of
``initialize_teacher_net`` / ``initialize_from_baseline`` in
flow_supervisor_tpu/training/checkpoint.py). Checkpoint files are not ported
yet (ROADMAP Queue 1, item 4)."""
from __future__ import annotations

import torch


def initialize_teacher_net(state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Copy the student update block's weights into the teacher head."""
    new = {k: v for k, v in state_dict.items() if not k.startswith("teacher_update_block.")}
    student = {k: v for k, v in state_dict.items() if k.startswith("update_block.")}
    if not student:
        raise ValueError("initialize_teacher_net: the state dict has no update_block")
    for k, v in student.items():
        new["teacher_" + k] = v.clone()
    return new


def initialize_from_baseline(
    state_dict: dict[str, torch.Tensor], baseline: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Transplant fnet / cnet / update_block (with cnet's batch-norm
    statistics) from a baseline model's state dict."""
    new = dict(state_dict)
    for k, v in baseline.items():
        if k.split(".")[0] in ("fnet", "cnet", "update_block"):
            new[k] = v.clone()
    return new
