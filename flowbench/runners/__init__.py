"""Window runners, one per kind of traffic (a traffic file's ``runner``):
``infer`` (batched forwards), ``evaluate`` (the Evaluator over a scene)
and ``train`` (the train step). Each is a class ``Run(cell, seed, device)``
whose construction is the set-up, with ``window(seconds)``,
``profile()``, ``release()`` and ``check()``.

Helpers shared by the runners: the device clock mapped onto the host's,
the seeded sample of finished work, and the comparison's numbers.
"""
from __future__ import annotations

import math
import random
import time

import torch


class DeviceClock:
    """Host times of the completion of work queued on the card: an event
    recorded on the idle card and synchronised gives the host time of its
    device timestamp, so a later event's completion is that time plus their
    elapsed device time. On the CPU (the harness's own tests) work is done
    when it returns, and ``mark`` reads the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            torch.cuda.synchronize(device)
            self.ref = torch.cuda.Event(enable_timing=True)
            self.ref.record()
            self.ref.synchronize()
        self.t_ref = time.perf_counter()

    def mark(self):
        """A marker of the work queued so far."""
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def host_time(self, marker) -> float:
        """Host time at which the work before ``marker`` completed (waits for it)."""
        if not self.cuda:
            return marker
        marker.synchronize()
        return self.t_ref + self.ref.elapsed_time(marker) * 1e-3


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_buffer(shape, device) -> torch.Tensor:
    """A host tensor that the card copies into asynchronously (pinned)."""
    return torch.empty(shape, pin_memory=torch.device(device).type == "cuda")


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = random.Random(seed)

    def offer(self, make_item) -> None:
        """Offer the next item; ``make_item()`` is called only if it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make_item())
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make_item()


def p95_ms(seconds: list) -> float:
    """The 95th percentile (linear between order statistics) in ms."""
    s = sorted(seconds)
    pos = 0.95 * (len(s) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return 1e3 * (s[lo] + (s[hi] - s[lo]) * (pos - lo))


def epe_gaps(got: torch.Tensor, want: torch.Tensor) -> list:
    """Per pair of flows [N, H, W, 2]: the mean endpoint gap in px; inf
    where ``got`` is not finite."""
    got, want = got.float(), want.float().to(got.device)
    gap = torch.linalg.vector_norm(got - want, dim=-1).mean(dim=(1, 2))
    bad = ~torch.isfinite(got).reshape(got.shape[0], -1).all(dim=1)
    return torch.where(bad, torch.full_like(gap, math.inf), gap).tolist()
