"""Batched inference: ``RAFT.forward(img1, img2, iters, final_flow_only=True)``
on batches of textured pairs, a closed loop of one client with at most
``in_flight`` batches queued, each batch's flow copied to host memory.

Set-up: the model in the traffic's dtype, seeded weights, a pool of
``pool_batches`` batches made on the card from the seed, two warm-up
forwards. Window: batches back to back from the pool; a batch's latency runs
from its dispatch until its flow is in host memory. ``pairs_per_s`` is every
pair of the window over the window's seconds. A seeded sample of
``check_batches`` finished batches is kept (the flows as they reached the
host) and checked against the plain reference once the program is freed.
"""
from __future__ import annotations

import collections
import time

import torch

from flowbench import frames, program, trace, weights
from flowbench.counts import flops, lookup
from flowbench.runners import DeviceClock, Reservoir, epe_gaps, host_buffer, p95_ms, synchronize
from flowbench.reference import precision
from flowbench.reference.raft import Raft

LOOKUP_CATEGORIES = ("K6 corr_fused_all", "K7 corr_fused_level", "K1 / K10 / K11 window lookup")


class Run:
    def __init__(self, cell, seed: int, device):
        t, m = cell.traffic, cell.config["model"]
        self.t, self.m, self.device = t, m, device
        program.load_kernels(device)
        self.model = program.inference_model(cell.config, t, device)
        self.masters = weights.make(self.model.state_dict(), 4 * seed, device, m.get("gamma"))
        weights.load(self.model, self.masters)
        b, (h, w) = t["batch"], t["hw"]
        img1, img2, _ = frames.pairs(frames.generator(4 * seed + 1, device), t["pool_batches"] * b,
                                     h, w, t["motion_px"], device)
        self.img1 = img1.reshape(-1, b, h, w, 3)
        self.img2 = img2.reshape(-1, b, h, w, 3)
        self.bufs = [host_buffer((b, h, w, 2), device) for _ in range(t["in_flight"])]
        self.sample = Reservoir(t["check_batches"], 4 * seed + 2)
        for k in range(2):
            self._forward(k)
        synchronize(device)

    def _forward(self, k: int) -> torch.Tensor:
        k %= self.img1.shape[0]
        out = self.model(self.img1[k], self.img2[k], iters=self.t["iters"], final_flow_only=True)
        return out["flow_up"][-1]

    def window(self, seconds: float) -> dict:
        clock, b, n_flight = DeviceClock(self.device), self.t["batch"], self.t["in_flight"]
        pending, latencies, n = collections.deque(), [], 0

        def finish():
            i, t_disp, marker, buf = pending.popleft()
            latencies.append(clock.host_time(marker) - t_disp)
            self.sample.offer(lambda: (i % self.img1.shape[0], buf.clone()))

        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            if len(pending) == n_flight:
                finish()
            t_disp = time.perf_counter()
            buf = self.bufs[n % n_flight]
            buf.copy_(self._forward(n), non_blocking=True)
            pending.append((n, t_disp, clock.mark(), buf))
            n += 1
        while pending:
            finish()
        elapsed = time.perf_counter() - t0
        return {"attempted": n * b, "failed": 0, "seconds": elapsed,
                "metrics": {"pairs_per_s": n * b / elapsed, "latency_ms_p95": p95_ms(latencies)}}

    def profile(self) -> dict:
        """The traced pass over ``profile_batches`` batches, with the
        lookups' coords recorded for their least work."""
        t = self.t
        coords, forward_lookup, i = [], self.model.lookup, [0]

        def recording_lookup(pyramid, coords1):
            coords.append(coords1)
            return forward_lookup(pyramid, coords1)

        def unit():
            self.bufs[0].copy_(self._forward(i[0]), non_blocking=True)
            i[0] += 1

        self.model.lookup = recording_lookup
        before = program.launch_counters()
        try:
            rec = trace.profile(unit, t["profile_batches"], self.device)
        finally:
            del self.model.lookup
        after = program.launch_counters()
        pairs = t["profile_batches"] * t["batch"]
        h, w = t["hw"]
        rec.update(unit="pair", work=pairs, dtype=t["dtype"], counters={
            k: after[k] - before[k] for k in after})
        rec["flops"] = pairs * flops.forward(h, w, t["iters"], self.m["gma"])
        rec["lookup"] = lookups(coords, h // 8, w // 8, self.m, t["dtype"], rec)
        rec["flops"] += rec["lookup"]["flops"]
        return rec

    def release(self) -> None:
        del self.model
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The number compared: each sampled pair's final flow against the
        reference's (float32, TF32 off), as the worst pair's mean endpoint
        gap in px. ``control``: the reference in float8 takes the
        program's place."""
        masters = {k: v.float() for k, v in self.masters.items()}
        ref = Raft(masters, gma=self.m["gma"], heads=self.m["num_heads"])
        low = Raft(masters, gma=self.m["gma"], heads=self.m["num_heads"], quant=precision.fp8)
        gaps = []
        with precision.tf32(False):
            for k, flow in self.sample.items:
                want = ref.forward(self.img1[k], self.img2[k], self.t["iters"])
                got = low.forward(self.img1[k], self.img2[k], self.t["iters"]) if control \
                    else flow.to(self.device)
                gaps += epe_gaps(got, want)
        return {"flow_gap_px": max(gaps)}


def lookups(coords: list, h8: int, w8: int, model: dict, dtype: str, rec: dict) -> dict:
    """The recorded lookups' least seconds and dot-product FLOPs, and whether
    the kernels' own launch counters agree with the profiler's count."""
    shapes = lookup.level_shapes(h8, w8, model["corr_levels"])
    r, c = model["corr_radius"], model["fnet_dim"]
    least, dots = 0.0, 0.0
    for xy in coords:
        taps = lookup.support_taps(xy, shapes, r)
        nbytes, ops = lookup.work(xy.numel() // 2, taps, c, shapes, r, dtype)
        least += lookup.least_seconds(nbytes, ops, dtype)
        dots += 2.0 * c * taps
    kernels = sum(1 for _, _, cat in rec["ops"] if cat in LOOKUP_CATEGORIES[:2])
    counted = rec["counters"]["corr_fused_all"] + rec["counters"]["corr_fused_level"]
    return {"least_s": least, "flops": dots, "calls": len(coords),
            "categories": LOOKUP_CATEGORIES, "counters_agree": kernels == counted}
