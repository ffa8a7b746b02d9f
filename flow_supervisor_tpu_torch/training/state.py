"""Train state (counterpart of flow_supervisor_tpu/training/state.py): the
step, the parameters and the optimizer's state.

Where JAX builds a new state each step, ``apply_gradients`` updates the
parameters in place: ``params`` are the model's own fp32 parameters, so the
model trains without a copy.
"""
from __future__ import annotations

import dataclasses

import torch

from flow_supervisor_tpu_torch.tracing import span
from flow_supervisor_tpu_torch.training.optim import AdamW, AdamWState


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    opt_state: AdamWState
    tx: AdamW

    @classmethod
    def create(cls, params: dict[str, torch.Tensor], tx: AdamW) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params), tx=tx)

    @span("fst.train.optimizer")
    @torch.no_grad()
    def apply_gradients(self, grads: dict[str, torch.Tensor]) -> "TrainState":
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
        for k, u in updates.items():
            self.params[k].add_(u)
        self.step += 1
        return self


@span("fst.train.backward")
def grads_of(loss: torch.Tensor, named) -> dict[str, torch.Tensor]:
    """d loss / d each of the (name, parameter) pairs ``named``; zeros for a
    parameter the loss does not reach (JAX's zero for an unused input)."""
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, gs)}
