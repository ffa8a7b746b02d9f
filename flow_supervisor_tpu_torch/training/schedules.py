"""Learning-rate / weight-decay schedules (counterpart of
flow_supervisor_tpu/training/schedules.py).

- ``one_cycle``: linear warm-up from max/div_factor to max over pct_start of
  the steps, then linear decay to (max/div_factor)/final_div_factor;
- ``exponential_staircase``: lr * rate^floor(step / decay_steps);
- ``smurf``: constant for const_portion of the steps, then continuous
  exponential decay to min_lr at the end;
- ``constant``.

Each returns step -> fp32 scalar tensor, computed in fp32 as the JAX
package's jnp versions are.
"""
from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def one_cycle(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.05,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
):
    initial = max_lr / div_factor
    final = initial / final_div_factor
    warmup_end = float(pct_start * total_steps)

    def schedule(step):
        s = _f32(step)
        up = initial + (max_lr - initial) * (s / warmup_end)
        down = max_lr + (final - max_lr) * ((s - warmup_end) / (total_steps - warmup_end))
        lr = torch.where(s < warmup_end, up, down)
        return torch.where(s >= total_steps, _f32(final), lr)

    return schedule


def exponential_staircase(initial_lr: float, decay_steps: int, decay_rate: float = 0.5):
    def schedule(step):
        s = _f32(step)
        return initial_lr * torch.pow(_f32(decay_rate), torch.floor(s / decay_steps))

    return schedule


def smurf(max_lr: float, min_lr: float, total_steps: int, const_portion: float = 0.8):
    decay_steps = int(total_steps * (1.0 - const_portion))
    start_at = total_steps - decay_steps
    rate = min_lr / max_lr

    def schedule(step):
        s = _f32(step)
        decayed = max_lr * torch.pow(_f32(rate), (s - start_at) / decay_steps)
        return torch.where(s >= start_at, decayed, _f32(max_lr))

    return schedule


def constant(lr: float):
    def schedule(step):
        return _f32(lr)

    return schedule


def build_schedules(train_cfg):
    """(lr_fn, wd_fn) from a TrainCfg: the weight-decay schedule is the lr
    schedule's shape scaled to weight_decay * lr."""
    kind = train_cfg.lr_schedule
    lr, wd = train_cfg.lr, train_cfg.weight_decay * train_cfg.lr
    steps = train_cfg.num_steps
    if kind == "onecycle":
        return one_cycle(lr, steps + 100, pct_start=0.05), one_cycle(wd, steps + 100, pct_start=0.05)
    if kind == "exponential":
        return (
            exponential_staircase(lr, train_cfg.lr_decay_steps, train_cfg.lr_decay_rate),
            exponential_staircase(wd, train_cfg.lr_decay_steps, train_cfg.lr_decay_rate),
        )
    if kind == "smurf":
        return smurf(lr, lr / 1000.0, steps, 0.8), smurf(wd, wd / 1000.0, steps, 0.8)
    return constant(lr), constant(wd)
