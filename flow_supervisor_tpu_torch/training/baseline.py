"""Supervised (Baseline) train step (counterpart of
flow_supervisor_tpu/training/baseline.py ``make_train_step``): one forward
with gradient over the pair, every iteration upsampled; the gamma-decayed
sequence loss against the labels (mask from ``valid``); one backward pass;
the optimizer step. Unfrozen batch norm (the chairs stages) normalizes by
batch statistics and updates its running statistics in the forward.

Batch contract (tensors on the model's device): {'image1', 'image2': [B, H,
W, 3] in [0, 1], 'flow': [B, H, W, 2], 'valid': [B, H, W, 1] (optional)}.
The log holds loss and epe. In a data-parallel world (parallel/mesh.py)
the gradients and the log are averaged over the ranks before the optimizer
step; a no-op in a world of 1.
"""
from __future__ import annotations

from typing import Any

import torch

from flow_supervisor_tpu_torch.losses.supervised import sequence_loss
from flow_supervisor_tpu_torch.metrics import epe_per_image
from flow_supervisor_tpu_torch.parallel import mesh
from flow_supervisor_tpu_torch.tracing import span
from flow_supervisor_tpu_torch.training.state import TrainState, grads_of


def make_train_step(model, loss_type: str = "robust", gamma: float = 0.8,
                    debug_grads: bool = False):
    named = list(model.named_parameters())

    def train_step(state: TrainState, batch: dict[str, Any]):
        model.train()
        with span("fst.train.forward"):
            out = model.train_forward(batch["image1"], batch["image2"])
        with span("fst.train.loss"):
            loss = sequence_loss(out["flow_up"], batch["flow"], batch.get("valid"), gamma,
                                 loss_type)
        grads = mesh.all_reduce_grads(grads_of(loss, named))
        log = mesh.mean_log({"loss": loss.detach(), "epe": torch.mean(epe_per_image(
            out["flow_up"][-1].detach(), batch["flow"], batch.get("valid")))})
        if debug_grads:
            log["_grads"] = grads
        return state.apply_gradients(grads), log

    return train_step
