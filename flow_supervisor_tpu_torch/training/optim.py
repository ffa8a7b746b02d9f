"""The optimizer of the JAX package (flow_supervisor_tpu/training/optim.py
``adamw``), as its own step over a dict of named fp32 tensors, applied in
this order:

1. per-variable clipnorm (Keras ``clipnorm``): each gradient tensor scaled to
   l2 norm <= clip_norm by its own norm, not the global one;
2. Adam with the tfa/Keras epsilon placement:
   u = m_t * sqrt(1 - b2^t) / (1 - b1^t) / (sqrt(v_t) + eps), eps on the
   uncorrected sqrt(v) (``torch.optim.AdamW`` puts it on the corrected one,
   which differs by up to ~30x at early steps for |g| near eps scale);
3. u = -lr(step) * u;
4. scheduled decoupled decay u -= wd(step) * param, not multiplied by lr;
5. frozen batch norm: the named tensors in ``frozen`` (every BatchNorm scale
   and bias under ``freeze_bn``) are left out of the update entirely and get
   no moments.

``step`` is the number of updates applied before this one (0 at the first),
as optax's schedule counters are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied so far
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamW:
    lr_fn: Callable
    wd_fn: Callable
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    frozen: frozenset = frozenset()

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        trained = [k for k in params if k not in self.frozen]
        return AdamWState(
            count=0,
            mu={k: torch.zeros_like(params[k]) for k in trained},
            nu={k: torch.zeros_like(params[k]) for k in trained},
        )

    @torch.no_grad()
    def update(
        self, grads: dict[str, torch.Tensor], state: AdamWState, params: dict[str, torch.Tensor]
    ) -> tuple[dict[str, torch.Tensor], AdamWState]:
        """-> (updates to add to the trained params, new state)."""
        count = state.count + 1
        t = torch.tensor(float(count), dtype=torch.float32)
        alpha = torch.sqrt(1.0 - torch.pow(torch.tensor(self.b2), t)) / (
            1.0 - torch.pow(torch.tensor(self.b1), t)
        )
        dev = next(iter(params.values())).device
        alpha = alpha.to(dev)
        neg_lr = -self.lr_fn(state.count).to(dev)
        wd = self.wd_fn(state.count).to(dev)
        mu, nu, updates = {}, {}, {}
        for k, m in state.mu.items():
            g = grads[k].float()
            norm = torch.sqrt(torch.sum(g * g))
            g = g * torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
            mu[k] = self.b1 * m + (1.0 - self.b1) * g
            nu[k] = self.b2 * state.nu[k] + (1.0 - self.b2) * (g * g)
            u = alpha * mu[k] / (torch.sqrt(nu[k]) + self.eps)
            updates[k] = u * neg_lr - wd * params[k]
        return updates, AdamWState(count=count, mu=mu, nu=nu)


def batchnorm_params(model: torch.nn.Module) -> frozenset:
    """Names of every BatchNorm scale and bias of ``model``: what frozen
    batch norm leaves out of training."""
    return frozenset(
        f"{mn}.{pn}" if mn else pn
        for mn, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)
        for pn, _ in m.named_parameters(recurse=False)
    )


def make_optimizer(train_cfg, frozen=frozenset()) -> AdamW:
    from flow_supervisor_tpu_torch.training.schedules import build_schedules

    lr_fn, wd_fn = build_schedules(train_cfg)
    return AdamW(lr_fn, wd_fn, clip_norm=train_cfg.clip_norm, frozen=frozenset(frozen))
