"""Training: the step that ``training.loop.make_step`` builds (the traffic's
``step``; the flow supervisor's ``semi``), steps back to back, a closed
loop with at most ``in_flight`` steps queued, each step's batches copied
from pinned host memory to the card (the loader is not part of it).

Set-up: the model's float32 masters seeded, the optimizer's state, a pool
of ``pool_steps`` (sup, unsup) batches made on the card from the seed and
kept in pinned host memory, then the first ``check_steps`` steps through
the window's own call and feed on distinct batches: the program's readings
for the check (each step's losses, the first gradient as the optimizer's
state holds it after one step, the parameters' change after the last) and
the warm-up. The same objects then run the window; ``steps_per_s`` is the
window's steps over its seconds. The window's first ``window_check_steps``
steps, on batches no earlier step took, keep their losses and the
parameters after the last of them, for the check too.
"""
from __future__ import annotations

import collections
import time

import torch

from flowbench import frames, program, trace, weights
from flowbench.counts import flops, lookup
from flowbench.runners import DeviceClock, synchronize
from flowbench.reference import precision
from flowbench.reference.semi import SemiStep

LOSSES = ("sup_loss", "unsup_loss")
BWD_CATEGORIES = ("K8 bwd_df1", "K9 bwd_df2")
GRAD_FLOOR = 1e-3  # a leaf whose reference gradient is below this share of the median leaf's


def step_batches(gen, t: dict, device) -> tuple[dict, dict]:
    """One step's (sup, unsup) batches: textured full frames, crops at
    seeded offsets (multiples of 8), the sup crop's true flow as its label
    with about 10 % of its pixels invalid."""
    b, (fh, fw) = t["batch"], t["full_hw"]
    out = []
    for key in ("sup_hw", "unsup_hw"):
        h, w = t[key]
        img1, img2, flow = frames.pairs(gen, b, fh, fw, t["motion_px"], device)
        ys = torch.randint(0, (fh - h) // 8 + 1, (b,), generator=gen, device=device) * 8
        xs = torch.randint(0, (fw - w) // 8 + 1, (b,), generator=gen, device=device) * 8
        yx = torch.stack([ys, xs], 1)
        cut = lambda x: torch.stack([x[i, y : y + h, c : c + w]  # noqa: E731
                                     for i, (y, c) in enumerate(yx.tolist())])
        batch = {"image1": cut(img1), "image2": cut(img2), "orig_image1": img1,
                 "orig_image2": img2, "crop_yx": yx}
        if key == "sup_hw":
            batch["flow"] = cut(flow)
            batch["valid"] = frames.valid_mask(gen, b, h, w, 0.1, device)
        out.append(batch)
    return out[0], out[1]


def pinned(batch: dict, device) -> dict:
    cuda = torch.device(device).type == "cuda"
    return {k: v.cpu().pin_memory() if cuda else v.cpu() for k, v in batch.items()}


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


class Run:
    def __init__(self, cell, seed: int, device):
        t, m = cell.traffic, cell.config["model"]
        self.t, self.m, self.device = t, m, device
        if t["check_steps"] + t["window_check_steps"] > t["pool_steps"]:
            raise ValueError("the checked steps need a batch each from the pool")
        clock = [time.perf_counter()]
        self.setup_phases = {}

        def phase(name):
            synchronize(device)
            clock.append(time.perf_counter())
            self.setup_phases[name] = clock[-1] - clock[-2]

        program.load_kernels(device)
        phase("kernels")
        self.model, self.state, self.step = program.train_step(cell.config, t, device)
        self.masters = weights.make(self.model.state_dict(), 4 * seed, device, m.get("gamma"))
        weights.load(self.model, self.masters)
        phase("model")
        gen = frames.generator(4 * seed + 1, device)
        self.batches = [tuple(pinned(b, device) for b in step_batches(gen, t, device))
                        for _ in range(t["pool_steps"])]
        phase("batches")
        self.n = 0
        self.losses, first = [], None
        for i in range(t["check_steps"]):
            log = self._step()
            self.losses.append({k: float(log[k]) for k in LOSSES})
            if i == 0:
                b1 = self.state.tx.b1
                first = {k: (mu / (1.0 - b1)).cpu() for k, mu in self.state.opt_state.mu.items()}
                self.trained = set(first)
        self.readings = {"grad1": norms(first), "first": first, "change": [self._change()]}
        phase("steps")

    def _change(self) -> dict:
        """Norm of each trained parameter's change from the masters."""
        params = dict(self.model.named_parameters())
        return norms({k: params[k].detach() - self.masters[k] for k in self.trained})

    def _step(self):
        sup, unsup = self.batches[self.n % len(self.batches)]
        self.n += 1
        to = lambda b: {k: v.to(self.device, non_blocking=True) for k, v in b.items()}  # noqa: E731
        self.state, log = self.step(self.state, (to(sup), to(unsup)))
        return log

    def window(self, seconds: float) -> dict:
        clock, pending, n = DeviceClock(self.device), collections.deque(), 0
        kept, after, n_check = [], None, self.t["window_check_steps"]
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds or n < n_check:
            if len(pending) == self.t["in_flight"]:
                clock.host_time(pending.popleft())
            log = self._step()
            if n < n_check:
                kept.append({k: log[k] for k in LOSSES})
                if n == n_check - 1:
                    after = {k: p.detach().clone() for k, p in self.model.named_parameters()
                             if k in self.trained}
            pending.append(clock.mark())
            n += 1
        while pending:
            clock.host_time(pending.popleft())
        elapsed = time.perf_counter() - t0
        self.losses += [{k: float(v) for k, v in log.items()} for log in kept]
        if after is not None:
            self.readings["change"].append(
                norms({k: after[k] - self.masters[k] for k in after}))
        return {"attempted": n, "failed": 0, "seconds": elapsed,
                "metrics": {"steps_per_s": n / elapsed}}

    def profile(self) -> dict:
        """The traced pass over ``profile_steps`` steps, with each lookup's
        coords and whether it has a backward (the student's)."""
        t = self.t
        calls, forward_lookup = [], self.model.lookup

        def recording_lookup(pyramid, coords1):
            f1 = pyramid.f1 if hasattr(pyramid, "f1") else pyramid[0]
            calls.append((coords1, torch.is_grad_enabled() and f1.requires_grad))
            return forward_lookup(pyramid, coords1)

        self.model.lookup = recording_lookup
        try:
            rec = trace.profile(self._step, t["profile_steps"], self.device)
        finally:
            del self.model.lookup
        steps = t["profile_steps"]
        rec.update(unit="step", work=steps, dtype=t["dtype"])
        rec["flops"] = steps * flops.semi_step(t["batch"], t["sup_hw"], t["unsup_hw"], t["full_hw"],
                                               t["iters"], t["teacher_iters"], self.m["gma"])
        r, c = self.m["corr_radius"], self.m["fnet_dim"]
        least_bwd, dots = 0.0, 0.0
        for xy, grad in calls:
            shapes = lookup.level_shapes(xy.shape[1], xy.shape[2], self.m["corr_levels"])
            taps = lookup.support_taps(xy, shapes, r)
            dots += (6.0 if grad else 2.0) * c * taps
            if grad:
                nbytes, ops = lookup.work(xy.numel() // 2, taps, c, shapes, r, t["dtype"], True)
                least_bwd += lookup.least_seconds(nbytes, ops, t["dtype"])
        rec["flops"] += dots
        rec["lookup_bwd"] = {"least_s": least_bwd, "categories": BWD_CATEGORIES}
        return rec

    def release(self) -> None:
        del self.step, self.state, self.model
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The numbers compared (those the cell's limits name), from the
        reference's steps from the same masters on the same batches: the
        set-up's ``check_steps``, then the window's first
        ``window_check_steps``, the reference following its own state:

        - each loss's largest relative gap over the steps: the supervised
          loss against the label, and L_fr, a pixel sum of the gap between
          the student's and the teacher's flows, whose relative gap swings
          from seed to seed;
        - by the worst leaf, the gap between the program's and the
          reference's norms of the first gradient (as clipped) and of the
          parameters' change (after the set-up's steps and after the
          window's checked ones, the larger), over the larger of the leaf's
          reference norm and the median leaf's;
        - one minus the cosine between the two first gradients (the
          optimizer's first moment after one step gives the program's), at
          the worst and at the median leaf.

        Leaves whose reference gradient, before clipping, is below
        GRAD_FLOOR of the median leaf's are left out: a bias before an
        instance norm, zero in exact arithmetic and round-off in practice,
        which the unsupervised loss's pixel sum makes large enough to reach
        the clip. ``control``: the reference in float8 takes the program's
        place."""
        t = self.t
        cfg = {"iters": t["iters"], "teacher_iters": t["teacher_iters"],
               "gamma": t["train"].get("loss_decay_rate", 0.8),
               "lfl_decay": t["model"]["lfl_loss_decay_rate"], "lr": t["train"]["lr"],
               "lr_decay_rate": t["train"].get("lr_decay_rate", 0.5),
               "lr_decay_steps": t["train"]["lr_decay_steps"],
               "weight_decay": t["train"]["weight_decay"], "clip_norm": t["train"]["clip_norm"]}
        masters = {k: v.float() for k, v in self.masters.items()}
        runs = {"ref": SemiStep(masters, cfg, self.m["gma"], self.m["num_heads"])}
        if control:
            runs["low"] = SemiStep(masters, cfg, self.m["gma"], self.m["num_heads"],
                                   quant=precision.fp8)
        got = {}
        with precision.tf32(False):
            for name, ref in runs.items():
                losses, first, change = [], None, []
                ends = (t["check_steps"], t["check_steps"] + t["window_check_steps"])
                for i in range(ends[1]):
                    sup, unsup = (
                        {k: v.to(self.device) for k, v in b.items()} for b in self.batches[i])
                    out = ref.step(sup, unsup)
                    losses.append({k: out[k] for k in LOSSES})
                    if i == 0:
                        first = {"grad1": norms(out["clipped"]), "raw": norms(out["raw"]),
                                 "first": out["raw"]}
                    if i + 1 in ends:
                        change.append(norms({k: ref.p[k].detach() - masters[k]
                                             for k in ref.trained}))
                got[name] = {"losses": losses, "change": change, **first}
        ref = got["ref"]
        prog = got["low"] if control else {"losses": self.losses, **self.readings}
        gaps = {f"{k.split('_')[0]}_loss_gap_rel": max(
            abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
            for k in LOSSES}
        raw = ref["raw"]
        median = sorted(raw.values())[len(raw) // 2]
        moving = [k for k, v in raw.items() if v >= GRAD_FLOOR * median]
        cos = [cos_gap(prog["first"][k], ref["first"][k]) for k in moving]
        return {**gaps,
                "grad_norm_gap": leaf_gap(prog["grad1"], ref["grad1"], moving),
                "change_norm_gap": max(leaf_gap(p, r, moving)
                                       for p, r in zip(prog["change"], ref["change"])),
                "grad_cos_gap": max(cos), "grad_cos_median": sorted(cos)[len(cos) // 2]}


def cos_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """1 - the cosine between two gradients of a leaf (clipping leaves the
    direction as it is)."""
    got, want = got.to(want.device).flatten().double(), want.flatten().double()
    return 1.0 - float(torch.dot(got, want) / (got.norm() * want.norm()).clamp(min=1e-300))


def leaf_gap(got: dict, want: dict, keys: list) -> float:
    """max over ``keys`` of |got - want| / max(want, the median of want)."""
    median = sorted(want[k] for k in keys)[len(keys) // 2]
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keys)
