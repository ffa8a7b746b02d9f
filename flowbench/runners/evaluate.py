"""Evaluation: ``Evaluator.predict`` over a scene of frames in host memory,
one pair at a time, each pair after the first warm-started from the
previous pair's low-resolution flow (``forward_interpolate``), the model's
teacher split when it has a teacher head, as ``evaluate.py`` runs Sintel.

Set-up: the model in the traffic's dtype (TF32 off in matmuls and cuDNN
when the traffic says so), seeded weights, a scene of ``scene_frames``
frames made on the card and kept in host memory, two warm-up pairs. Window:
the scene's pairs in order, again from its start when it ends; a pair's
latency runs from its dispatch (the warm start included) until its flows
are in host memory. A seeded sample of ``check_pairs`` pairs, and the
window's first pair (a scene's start, no warm start), keep their inputs:
the previous pair's low flow and the warm start made from it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from flowbench import frames, program, trace, weights
from flowbench.counts import flops
from flowbench.runners import Reservoir, epe_gaps, p95_ms, synchronize
from flowbench.runners.infer import lookups
from flowbench.reference import precision
from flowbench.reference.raft import Raft, pad_sintel, unpad
from flowbench.reference.warm_start import forward_interpolate


class Run:
    def __init__(self, cell, seed: int, device):
        t, m = cell.traffic, cell.config["model"]
        self.t, self.m, self.device = t, m, device
        if "tf32" in t:
            torch.backends.cuda.matmul.allow_tf32 = t["tf32"]
            torch.backends.cudnn.allow_tf32 = t["tf32"]
        program.load_kernels(device)
        self.model = program.inference_model(cell.config, t, device)
        self.masters = weights.make(self.model.state_dict(), 4 * seed, device, m.get("gamma"))
        weights.load(self.model, self.masters)
        self.evaluator = program.evaluator(self.model, t)
        self.splat = program.warm_start()
        h, w = t["hw"]
        scene = frames.scene(frames.generator(4 * seed + 1, device), t["scene_frames"], h, w,
                             t["motion_px"], device)
        self.frames = list(scene.cpu().numpy())
        self.sample = Reservoir(t["check_pairs"], 4 * seed + 2)
        self.first = None
        low = None
        for j in range(2):
            low = self._pair(j, low)[1]
        synchronize(device)

    def _pair(self, j: int, prev_low):
        """Pair j of the scene -> (results, low flow, warm start used)."""
        init = self.splat(prev_low) if prev_low is not None else None
        results, low = self.evaluator.predict(self.frames[j], self.frames[j + 1], "sintel", init)
        return results, low, init

    def window(self, seconds: float) -> dict:
        latencies, n, low = [], 0, None
        pairs = len(self.frames) - 1
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds or n < 2:  # a scene start and a warm start
            j = n % pairs
            prev = low if j else None
            t_disp = time.perf_counter()
            results, low, init = self._pair(j, prev)
            latencies.append(time.perf_counter() - t_disp)
            item = lambda: (j, prev, init, results, low)  # noqa: E731
            if n == 0:
                self.first = item()
            else:
                self.sample.offer(item)
            n += 1
        elapsed = time.perf_counter() - t0
        return {"attempted": n, "failed": 0, "seconds": elapsed,
                "metrics": {"eval_pairs_per_s": n / elapsed,
                            "eval_latency_ms_p95": p95_ms(latencies)}}

    def profile(self) -> dict:
        """The traced pass over ``profile_pairs`` pairs from the scene's
        start, with the lookups' coords recorded."""
        t = self.t
        coords, forward_lookup, state = [], self.model.lookup, {"j": 0, "low": None}

        def recording_lookup(pyramid, coords1):
            coords.append(coords1)
            return forward_lookup(pyramid, coords1)

        def unit():
            _, state["low"], _ = self._pair(state["j"], state["low"])
            state["j"] += 1

        self.model.lookup = recording_lookup
        before = program.launch_counters()
        try:
            rec = trace.profile(unit, t["profile_pairs"], self.device)
        finally:
            del self.model.lookup
        after = program.launch_counters()
        h, w = (-(-n // t["pad_bucket"]) * t["pad_bucket"] for n in t["hw"])
        rec.update(unit="pair", work=t["profile_pairs"], dtype=t["dtype"],
                   counters={k: after[k] - before[k] for k in after})
        teacher = t["teacher_iters"] if t.get("teacher") else 0
        rec["flops"] = t["profile_pairs"] * flops.forward(h, w, t["iters"], self.m["gma"], teacher)
        rec["lookup"] = lookups(coords, h // 8, w // 8, self.m, t["dtype"], rec)
        rec["flops"] += rec["lookup"]["flops"]
        return rec

    def release(self) -> None:
        del self.evaluator, self.model
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The numbers compared, over the sampled pairs and the window's
        first (a scene's start, no warm start):

        - the warm start made again from the program's previous low flow (an
          exact copy of the algorithm: the largest difference in px);
        - from that warm start, the reference's forward (float32, TF32 off)
          against the program's unpadded student and teacher flows and its
          final low flow, the one the next pair starts from, as the worst
          pair's mean endpoint gap in px.

        The reference starts each pair from the program's previous low
        flow: following the scene's chain of warm starts on its own low
        flows, it parts from a sound program by up to a pixel on some seeds
        (the nearest-neighbour splat, iterated), as far as the control. The
        chain's parts are checked by themselves instead: its start, the
        splat and the low flow handed on. ``control``: the reference in TF32
        takes the program's place."""
        masters = {k: v.float() for k, v in self.masters.items()}
        ref = Raft(masters, gma=self.m["gma"], heads=self.m["num_heads"])
        out = {"warm_start_gap_px": 0.0}
        for j, prev, init, results, low in [self.first] + self.sample.items:
            ref_init = None
            if prev is not None:
                ref_init = forward_interpolate(prev)
                out["warm_start_gap_px"] = max(out["warm_start_gap_px"],
                                               float(np.abs(ref_init - init).max()))
            flows = {tf32: self._reference(ref, j, ref_init, tf32)
                     for tf32 in ((False, True) if control else (False,))}
            got = flows[True] if control else {
                k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in {**results, "low": low[None]}.items()}
            for name, want in flows[False].items():
                gap = epe_gaps(got[name].to(self.device), want)[0]
                out[f"{name}_gap_px"] = max(out.get(f"{name}_gap_px", 0.0), gap)
        return out

    def _reference(self, ref, j: int, init, tf32: bool) -> dict:
        """The reference over pair j from the warm start ``init`` -> its
        unpadded flows and its final low flow by name."""
        t, dev = self.t, self.device
        x1, spec = pad_sintel(torch.from_numpy(self.frames[j])[None].to(dev), t["pad_bucket"])
        x2, _ = pad_sintel(torch.from_numpy(self.frames[j + 1])[None].to(dev), t["pad_bucket"])
        flow_init = None if init is None else torch.from_numpy(init)[None].to(dev)
        with precision.tf32(tf32):
            if t.get("teacher", False):
                stu, tea, low = ref.teacher_split(x1, x2, t["iters"], t["teacher_iters"],
                                                  flow_init)
                return {"student": unpad(stu, spec), "teacher": unpad(tea, spec), "low": low}
            stu, low = ref.forward(x1, x2, t["iters"], flow_init, with_low=True)
            return {"student": unpad(stu, spec), "low": low}
