"""Checkpoint files and weight transplants between models (counterpart of
flow_supervisor_tpu/training/checkpoint.py), in the port's own format.

A checkpoint is one ``torch.save`` file per step under the run's directory,
``<ckpt_dir>/ckpt_<step>.pt``, holding ``{"step", "model", "opt_state"}``:
the model's state dict (parameters and batch-norm buffers) and the
``AdamWState`` (``count``, ``mu``, ``nu``) as a dict. It is written to a
temporary name in the same directory, then renamed over the final one, so a
run cut while saving leaves the previous checkpoints whole. The JAX
package's orbax checkpoints are not read here.

- ``initialize_teacher_net``: copy the student update block into the teacher
  head.
- ``initialize_from_baseline``: fnet / cnet / update_block transplant.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

from flow_supervisor_tpu_torch.training.optim import AdamWState

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step}.pt")


def save_checkpoint(ckpt_dir: str, step: int, model_state: dict[str, torch.Tensor],
                    opt_state: Optional[AdamWState] = None) -> str:
    """Write step's checkpoint file -> its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": int(step),
        "model": {k: v.detach().cpu() for k, v in model_state.items()},
        "opt_state": None if opt_state is None else {
            "count": int(opt_state.count),
            "mu": {k: v.detach().cpu() for k, v in opt_state.mu.items()},
            "nu": {k: v.detach().cpu() for k, v in opt_state.nu.items()},
        },
    }
    path = checkpoint_path(ckpt_dir, step)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """The steps of the checkpoint files in ckpt_dir, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       map_location=None) -> Optional[dict]:
    """{'step', 'model', 'opt_state'} of step's checkpoint (default: the
    latest), tensors on ``map_location``; None if ckpt_dir has none.
    ``opt_state`` is an ``AdamWState`` or None."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    out = torch.load(checkpoint_path(ckpt_dir, step), map_location=map_location,
                     weights_only=True)
    if out["opt_state"] is not None:
        out["opt_state"] = AdamWState(**out["opt_state"])
    return out


def optimizer_state_to(state: AdamWState, device) -> AdamWState:
    return dataclasses.replace(state, mu={k: v.to(device) for k, v in state.mu.items()},
                               nu={k: v.to(device) for k, v in state.nu.items()})


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
