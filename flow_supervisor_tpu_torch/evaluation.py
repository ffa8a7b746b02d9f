"""Evaluation (counterpart of flow_supervisor_tpu/evaluation.py): dense
(Sintel, chairs) and sparse (KITTI) scoring of a model over records, with
optional warm start, and the standing validation of training.

- ``run_pair``: one pair through the ``Evaluator``'s student, padded to a
  multiple of 8.
- ``Evaluator``: pads each pair by ``pad_spec_for(..., multiple=pad_bucket)``
  ('sintel' mode, centred, for dense sets; 'kitti' mode, at the bottom, for
  sparse ones), runs the model at ``iters`` and scores the final prediction,
  unpadded: per-image EPE and 1 / 3 / 5-px accuracies, and over the valid
  pixels with Fl-all for sparse sets. A model with a teacher head scores
  both: the student runs ``iters``, then the teacher continues from the
  student's final hidden state and flow for ``teacher_iters``
  (``student_*`` and ``teacher_*``). Warm start: within a scene
  (``rec.extra[0]``), the previous pair's final low-resolution flow, at the
  padded 1/8 size, is splatted forward on the host and starts the next
  pair. It also reports ``pairs_per_sec`` and the host time per pair spent
  decoding, warm-starting and in the forward (padding, the model's dispatch
  and the flows' copies back, which wait for the device), read from the
  spans ``fst.eval.decode``, ``fst.warm_start``, ``fst.eval.pad``,
  ``fst.eval.forward`` and ``fst.eval.fetch`` (tracing.py).
- ``eval_iters_policy``, ``standing_validation_sets``,
  ``make_train_validator``: the training loop's standing validation.

The Evaluator runs on the model's device, in the model's eval mode (it puts
back the mode it found), and sets no global flag. With ``space_parallel`` =
n it runs as one of n ranks, each on its rows of every pair
(parallel/spatial.py), all with the same results.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterable, Optional

import numpy as np
import torch

from flow_supervisor_tpu_torch.data.datasets import FlowRecord
from flow_supervisor_tpu_torch.data.pipeline import load_record
from flow_supervisor_tpu_torch.metrics import dense_metrics, sparse_metrics
from flow_supervisor_tpu_torch.ops.coords import coords_grid, downsample_shape
from flow_supervisor_tpu_torch.ops.pad import pad_spec_for
from flow_supervisor_tpu_torch.parallel import mesh, spatial
from flow_supervisor_tpu_torch.tracing import span
from flow_supervisor_tpu_torch.utils.warm_start import forward_interpolate


def _padded(img: np.ndarray, spec, device) -> torch.Tensor:
    """[H, W, 3] -> [1, H', W', 3] float32 on device, replicate-edge padded by spec."""
    (t, b), (l, r) = spec
    x = np.pad(np.asarray(img, np.float32), ((t, b), (l, r), (0, 0)), mode="edge")
    return torch.from_numpy(x[None]).to(device)


def _unpad(x: np.ndarray, spec) -> np.ndarray:
    (t, b), (l, r) = spec
    return x[:, t : x.shape[1] - b, l : x.shape[2] - r]


def run_pair(
    model,
    img1: np.ndarray,
    img2: np.ndarray,
    mode: str = "sintel",
    flow_init: Optional[np.ndarray] = None,
    iters: int = 12,
) -> tuple[np.ndarray, np.ndarray]:
    """img1/img2: [H, W, 3] in [0, 1]; flow_init: [h8, w8, 2] at the padded
    1/8 resolution. Returns (flow [H, W, 2], flow_low [h8, w8, 2]) as float32:
    the student's ``Evaluator.predict`` at ``pad_bucket`` 8."""
    results, low = Evaluator(model, iters=iters, use_teacher=False).predict(
        img1, img2, mode, flow_init)
    return results["student"][0], low


class Evaluator:
    """Scores a model over record lists (module docstring). ``use_teacher``
    (default: whether the model has a teacher head) picks the teacher split.

    ``space_parallel`` = n > 1 (JAX's space-sharded evaluation) runs in a
    world of n ranks (parallel/mesh.py ``init_world``; the evaluate CLI's
    ``--space_parallel`` spawns it): every rank decodes the pair, runs its
    rows of it (parallel/spatial.py) through the student or the teacher
    split and warm start, gets the whole flow back and computes the same
    metrics. The padding then aligns H to 8n (``pad_bucket`` at least 8n,
    JAX's rule). The model keeps its lookup backend, where JAX's sharded
    evaluation switches to einsum."""

    def __init__(
        self,
        model,
        iters: int = 24,
        use_teacher: Optional[bool] = None,
        pad_bucket: int = 8,
        space_parallel: int = 1,
    ):
        if space_parallel > 1:
            if mesh.world_size() != space_parallel:
                raise ValueError(
                    f"Evaluator(space_parallel={space_parallel}) needs a world of "
                    f"{space_parallel} ranks; this process is in a world of "
                    f"{mesh.world_size()} (parallel/mesh.py init_world, or the evaluate "
                    "CLI's --space_parallel)")
            pad_bucket = max(pad_bucket, 8 * space_parallel)
        self.model = model
        self.iters = iters
        self.use_teacher = bool(model.cfg.teacher) if use_teacher is None else use_teacher
        self.pad_bucket = pad_bucket
        self.space_parallel = space_parallel

    def _teacher_forward(self, x1, x2, flow_init):
        """The student for ``iters`` (final flow only), then the teacher head
        from the student's final hidden state at coords0 + its final low
        flow for ``teacher_iters`` -> (student up, teacher up, student low).
        flow_init is the whole frame's (under a space shard too)."""
        m = self.model
        b, h, w, _ = x1.shape
        pyramid = m.build_corr(*m.features(x1, x2))
        net, inp = m.context(x1)
        attention = m.attention_map(inp)  # GMA: one map for the student and the teacher
        h8 = downsample_shape(h)
        coords0 = coords_grid(b, h8, downsample_shape(w), device=x1.device,
                              row0=spatial.first_row(h8))
        coords1 = coords0 if flow_init is None else coords0 + spatial.local_rows(flow_init)
        net, _, stu_up, stu_low = m.iterate(
            net, inp, pyramid, coords0, coords1, (h, w), self.iters, final_flow_only=True,
            attention=attention)
        _, _, tea_up, _ = m.teacher_iterate(
            net, inp, pyramid, coords0, coords0 + stu_low[-1], (h, w), m.cfg.teacher_iters,
            final_flow_only=True, attention=attention)
        return stu_up[-1], tea_up[-1], stu_low[-1]

    @torch.no_grad()
    def predict(self, img1: np.ndarray, img2: np.ndarray, mode: str,
                flow_init: Optional[np.ndarray] = None, host: Optional[dict] = None):
        """One pair: ({"student": flow [1, H, W, 2], and "teacher" with the
        teacher split}, the student's final low flow [h8, w8, 2] at the padded
        1/8 size), numpy float32. flow_init: [h8, w8, 2] at that size.
        ``host``: adds the host seconds of the pair's ``pad``, ``forward``
        and ``fetch`` spans."""
        device = next(self.model.parameters()).device
        with span("fst.eval.pad", host):
            spec = pad_spec_for(img1.shape[0], img1.shape[1], mode=mode,
                                multiple=self.pad_bucket)
            x1, x2 = _padded(img1, spec, device), _padded(img2, spec, device)
            init = None
            if flow_init is not None:
                init = torch.from_numpy(np.asarray(flow_init, np.float32)[None]).to(device)
        tea = None
        with spatial.shard(x1.shape[1], x1.shape[2]) if self.space_parallel > 1 \
                else contextlib.nullcontext():
            x1, x2 = spatial.local_rows(x1), spatial.local_rows(x2)
            with span("fst.eval.forward", host):
                if self.use_teacher:
                    stu, tea, low = self._teacher_forward(x1, x2, init)
                else:
                    out = self.model(x1, x2, flow_init=init, iters=self.iters,
                                     final_flow_only=True)
                    stu, low = out["flow_up"][-1], out["flow_low"][-1]
                low = spatial.gather_rows(low)
        with span("fst.eval.fetch", host):
            results = {}
            if tea is not None:
                results["teacher"] = _unpad(tea.float().cpu().numpy(), spec)
            results["student"] = _unpad(stu.float().cpu().numpy(), spec)
            return results, low[0].float().cpu().numpy()

    def evaluate(
        self, records: Iterable[FlowRecord], sparse: bool = False, warm_start: bool = False
    ) -> dict[str, float]:
        """Mean of each per-pair metric (``student_*``, ``teacher_*``),
        ``pairs_per_sec``, and host ms per pair: ``decode_ms_per_pair``,
        ``warm_start_ms_per_pair``, ``forward_ms_per_pair``."""
        was_training = self.model.training
        self.model.eval()
        try:
            return self._evaluate(records, sparse, warm_start)
        finally:
            self.model.train(was_training)

    def _evaluate(self, records, sparse, warm_start):
        lists: dict[str, list[float]] = {}
        host = dict.fromkeys(("decode", "warm_start", "pad", "forward", "fetch"), 0.0)
        prev_scene, prev_low = None, None
        n_pairs = 0
        mode = "kitti" if sparse else "sintel"
        t0 = time.perf_counter()
        for rec in records:
            with span("fst.eval.decode", host):
                img1, img2, flow_gt, valid = load_record(rec)
            scene = rec.extra[0] if rec.extra else None
            flow_init = None
            if warm_start and prev_low is not None and scene == prev_scene:
                flow_init = forward_interpolate(prev_low, host)
            prev_scene = scene
            results, prev_low = self.predict(img1, img2, mode, flow_init, host)
            n_pairs += 1
            gt = torch.from_numpy(flow_gt[None])
            for name, pred in results.items():
                pred = torch.from_numpy(np.ascontiguousarray(pred))
                if sparse:
                    m = sparse_metrics(pred, gt, torch.from_numpy(valid[None]))
                else:
                    m = dense_metrics(pred, gt)
                for k, v in m.items():
                    lists.setdefault(f"{name}_{k}", []).append(float(v[0]))
        out = {k: float(np.mean(v)) for k, v in lists.items()}
        if n_pairs:
            out["pairs_per_sec"] = n_pairs / max(time.perf_counter() - t0, 1e-9)
            # "forward": the whole of predict, padding and the copies back included
            host["forward"] += host.pop("pad") + host.pop("fetch")
            out.update({f"{k}_ms_per_pair": 1e3 * v / n_pairs for k, v in host.items()})
        return out


def standing_validation_sets(stage: str, max_records: int = 0):
    """(name, records, sparse) validation sets for training-time callbacks:
    chairs for the chairs stages, then Sintel clean and final and KITTI, as
    the reference attaches them (train.py:211-217). Sets whose dataset root
    is missing or empty are skipped, so training runs on partial installs."""
    from flow_supervisor_tpu_torch.data import datasets as D

    candidates = []
    if stage.startswith("chairs"):
        candidates.append(("chairs", lambda: D.flying_chairs(training=False), False))
    candidates.append(("sintel_clean", lambda: D.sintel(True, "clean"), False))
    candidates.append(("sintel_final", lambda: D.sintel(True, "final"), False))
    candidates.append(("kitti", lambda: D.kitti(training=True), True))

    sets = []
    for name, build, sparse in candidates:
        try:
            recs = build()
        except OSError:
            continue
        if not recs:
            continue
        if max_records:
            recs = recs[:max_records]
        sets.append((name, recs, sparse))
    return sets


def eval_iters_policy(dataset_name: str, override: int = 0) -> int:
    """Refinement iterations of evaluation (reference evaluate.py:166-174):
    32 for Sintel, 24 otherwise; an override wins."""
    if override:
        return override
    return 32 if dataset_name.startswith("sintel") else 24


def make_train_validator(cfg, model):
    """validate_fn(step, state) -> metrics dict for the training loop, or None
    when no validation set is found.

    It scores the live ``model``, whose parameters are the train state's
    (``TrainState.params`` are the model's own tensors), at the eval iters
    policy unless ``cfg.train.val_iters`` overrides it; sparse (KITTI) sets
    pad to ``cfg.train.val_pad_bucket``, and ``cfg.train.val_warm_start``
    chains flow within scenes. Keys are ``<set>_<metric>``."""
    sets = standing_validation_sets(cfg.train.stage, cfg.train.val_max_records)
    if not sets:
        return None
    evaluators = {
        name: Evaluator(model, iters=eval_iters_policy(name, cfg.train.val_iters),
                        pad_bucket=cfg.train.val_pad_bucket if sparse else 8)
        for name, _, sparse in sets
    }

    def validate_fn(step: int, state) -> dict[str, float]:
        out = {}
        for name, recs, sparse in sets:
            r = evaluators[name].evaluate(recs, sparse=sparse, warm_start=cfg.train.val_warm_start)
            out.update({f"{name}_{k}": v for k, v in r.items()})
        return out

    validate_fn.evaluators = evaluators
    return validate_fn
