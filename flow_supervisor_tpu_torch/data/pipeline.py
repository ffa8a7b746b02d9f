"""Host-side training pipelines: load -> augment -> batch -> prefetch
(counterpart of flow_supervisor_tpu/data/pipeline.py).

Records are shuffled per epoch, decoded by ``data/io.py`` (numpy, no cv2),
run through the numpy augmentors of ``data/augment.py``, batched, and
prefetched on a background thread so host work overlaps device steps.

    from flow_supervisor_tpu_torch.data.pipeline import fetch_dataloader
    loader = fetch_dataloader(cfg.train)   # an iterator of batches
    batch = next(loader)                   # semi-*: (sup_batch, unsup_batch)

``stage_records`` is the JAX package's stage registry, stage by stage: each
stage composes catalogs with its own augmentation parameters;
``semi-<unsup>-<sup>`` zips an unlabeled stream with a labeled one. The
batches of a seed equal the JAX package's: the same records in the same
order, and each example's augmentation drawn from its own generator, seeded
from the pipeline's generator, for any worker count. Worker threads share
the interpreter with the caller: ``_unfilter`` (the PNG decode) and the
augmentors' smaller numpy steps hold its lock.

Under data parallelism each rank builds only its rows of every global batch
(``shard=(rank, world)``: rows [rank * B / world, (rank + 1) * B / world)).
Every rank draws the whole stream's epoch orders and example seeds, so the
union of the ranks' batches is the one-process batch; a semi stream shards
its sup and unsup batches alike.
"""
from __future__ import annotations

import atexit
import collections
import os
import queue
import threading
import weakref
from multiprocessing.pool import ThreadPool
from typing import Iterator, Optional

import numpy as np

from flow_supervisor_tpu_torch.data import datasets as D
from flow_supervisor_tpu_torch.data import paths
from flow_supervisor_tpu_torch.data.augment import (
    FlowAugmentor,
    MultiFrameAugmentor,
    SparseFlowAugmentor,
    UnsupAugmentor,
)
from flow_supervisor_tpu_torch.data.datasets import FlowRecord
from flow_supervisor_tpu_torch.data.io import read_flow_any, read_image


def load_record(record: FlowRecord):
    """-> (img1, img2, flow, valid) float32; dummy zero flow for unlabeled."""
    img1 = read_image(record.images[0])
    img2 = read_image(record.images[1])
    if record.flow is not None:
        flow, valid = read_flow_any(record.flow)
        flow = flow.astype(np.float32)
        if valid is None:
            valid = np.ones(flow.shape[:2] + (1,), np.float32)
        else:
            valid = valid.reshape(valid.shape[:2] + (1,)).astype(np.float32)
    else:
        flow = np.zeros(img1.shape[:2] + (2,), np.float32)
        valid = np.zeros(img1.shape[:2] + (1,), np.float32)
    if record.canonical_size is not None:
        img1 = _crop_or_pad(img1, record.canonical_size)
        img2 = _crop_or_pad(img2, record.canonical_size)
        flow = _crop_or_pad(flow, record.canonical_size)
        valid = _crop_or_pad(valid, record.canonical_size)
    return img1, img2, flow, valid


def _crop_or_pad(x: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """tf.image.resize_with_crop_or_pad semantics: center crop then center pad."""
    h, w = x.shape[:2]
    th, tw = size
    y0 = max(0, (h - th) // 2)
    x0 = max(0, (w - tw) // 2)
    x = x[y0 : y0 + th, x0 : x0 + tw]
    h, w = x.shape[:2]
    py, px = th - h, tw - w
    if py or px:
        x = np.pad(
            x,
            ((py // 2, py - py // 2), (px // 2, px - px // 2), (0, 0)),
        )
    return x


def _stack(dicts: list[dict]) -> dict:
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def _iter_batches(pipe, workers: int) -> Iterator[dict]:
    """Infinite batch stream over ``pipe.records`` via ``pipe._example_rng``.

    workers <= 1: in-process serial. workers > 1: a thread pool with a
    bounded in-flight window (``Pool.imap``'s feeder would consume an
    infinite job generator without bound). Epoch order and per-example seeds
    always come from ``pipe.rng``, so the stream is the same for any worker
    count; ``pipe.shard`` picks this rank's rows of each global batch."""
    rank, world = pipe.shard
    if pipe.batch_size % world != 0:
        raise ValueError(f"batch_size {pipe.batch_size} does not divide over {world} ranks")
    rows = pipe.batch_size // world
    lo = rank * rows

    def jobs():
        i = 0
        while True:
            for idx in pipe.rng.permutation(len(pipe.records)):
                seed = int(pipe.rng.integers(0, 2**63))
                if lo <= i % pipe.batch_size < lo + rows:
                    yield int(idx), seed
                i += 1

    def make_example(job):
        idx, seed = job
        return pipe._example_rng(pipe.records[idx], np.random.default_rng(seed))

    if workers <= 1:
        batch = []
        for job in jobs():
            batch.append(make_example(job))
            if len(batch) == rows:
                yield _stack(batch)
                batch = []
        return

    pool = ThreadPool(workers)
    try:
        job_iter = jobs()
        inflight: collections.deque = collections.deque()
        batch = []
        while True:
            while len(inflight) < workers * 2:
                inflight.append(pool.apply_async(make_example, (next(job_iter),)))
            batch.append(inflight.popleft().get())
            if len(batch) == rows:
                yield _stack(batch)
                batch = []
    finally:
        pool.terminate()
        pool.join()


class SupervisedPipeline:
    """Labeled stream -> {'image1','image2','flow','valid'} batches."""

    def __init__(self, records, crop_size, min_scale, max_scale, do_flip,
                 batch_size, seed=1234, augment=True, do_rotation=False,
                 max_rotation=10.0, workers=0, shard=(0, 1)):
        if not records:
            raise ValueError("SupervisedPipeline: empty dataset")
        self.records = list(records)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.workers = workers
        self.shard = shard
        self.augment = augment
        self.dense_aug = FlowAugmentor(
            crop_size, min_scale, max_scale, do_flip,
            do_rotation=do_rotation, max_rotation=max_rotation,
        )
        self.sparse_aug = SparseFlowAugmentor(
            crop_size, min_scale, max_scale, do_flip,
            do_rotation=do_rotation, max_rotation=max_rotation,
        )

    def _example_rng(self, record, rng) -> dict:
        img1, img2, flow, valid = load_record(record)
        if not self.augment:
            return {"image1": img1, "image2": img2, "flow": flow, "valid": valid}
        # dense when the valid mask is everywhere positive, sparse otherwise
        if record.sparse or not (valid > 0.5).all():
            img1, img2, flow, valid = self.sparse_aug(img1, img2, flow, valid, rng)
        else:
            img1, img2, flow = self.dense_aug(img1, img2, flow, rng)
            valid = np.ones(flow.shape[:2] + (1,), np.float32)
        return {
            "image1": img1.astype(np.float32),
            "image2": img2.astype(np.float32),
            "flow": flow.astype(np.float32),
            "valid": valid.astype(np.float32),
        }

    def __iter__(self) -> Iterator[dict]:
        return _iter_batches(self, self.workers)


class UnsupPipeline:
    """Unlabeled stream -> UnsupAugmentor dict batches (full frame + crop)."""

    def __init__(self, records, crop_size, min_scale, max_scale, do_flip,
                 batch_size, full_size, seed=1234, do_rotation=False,
                 max_rotation=10.0, workers=0, shard=(0, 1)):
        if not records:
            raise ValueError("UnsupPipeline: empty dataset")
        self.records = list(records)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.workers = workers
        self.shard = shard
        self.aug = UnsupAugmentor(
            crop_size, min_scale, max_scale, do_flip, full_size=full_size,
            do_rotation=do_rotation, max_rotation=max_rotation,
        )

    def _example_rng(self, record, rng) -> dict:
        img1, img2, flow, valid = load_record(record)
        return self.aug(img1, img2, flow, valid, rng)

    def __iter__(self) -> Iterator[dict]:
        return _iter_batches(self, self.workers)


def _flow_or_zeros(path, h, w):
    """(flow [H, W, 2], valid [H, W, 1]) float32 of a flow file, or zeros
    for a record without one."""
    if not path:
        return np.zeros((h, w, 2), np.float32), np.zeros((h, w, 1), np.float32)
    flow, valid = read_flow_any(path)
    flow = flow.astype(np.float32)
    if valid is None:
        return flow, np.ones(flow.shape[:2] + (1,), np.float32)
    return flow, valid.reshape(valid.shape[:2] + (1,)).astype(np.float32)


class MultiFramePipeline:
    """Frame-triplet stream: {'image1..3', 'flow1/2', 'valid1/2',
    'orig_image1..3', 'crop_yx'} batches from records with 3 frame paths,
    the flow i -> i+1 as ``flow`` and i+1 -> i+2 as ``extra[2]`` (zeros for
    unlabeled triplets). No train step reads these batches."""

    def __init__(self, records, crop_size, min_scale, max_scale, do_flip,
                 batch_size, seed=1234, workers=0, shard=(0, 1)):
        if not records:
            raise ValueError("MultiFramePipeline: empty dataset")
        self.records = list(records)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.workers = workers
        self.shard = shard
        self.aug = MultiFrameAugmentor(crop_size, min_scale, max_scale, do_flip)

    def _example_rng(self, record, rng) -> dict:
        imgs = [read_image(p) for p in record.images]
        if len(imgs) != 3:
            raise ValueError(f"multiframe records need 3 frames, got {len(imgs)}")
        h, w = imgs[0].shape[:2]
        flow1, valid1 = _flow_or_zeros(record.flow, h, w)
        flow2, valid2 = _flow_or_zeros(record.extra[2] if len(record.extra) > 2 else None, h, w)
        return self.aug(*imgs, flow1, valid1, flow2, valid2, rng)

    def __iter__(self) -> Iterator[dict]:
        return _iter_batches(self, self.workers)


def semi_zip(unsup_iter, sup_iter) -> Iterator[tuple[dict, dict]]:
    """Zip the two infinite streams -> (sup_batch, unsup_batch)."""
    for unsup_batch, sup_batch in zip(unsup_iter, sup_iter):
        yield sup_batch, unsup_batch


# One module-level atexit hook over a WeakSet: prefetchers (and their queued
# batches) become collectible as soon as callers drop them, instead of being
# pinned for the life of the process by per-instance atexit registrations.
_live_prefetchers: "weakref.WeakSet[Prefetcher]" = weakref.WeakSet()


def _close_live_prefetchers() -> None:
    for p in list(_live_prefetchers):
        p.close()


atexit.register(_close_live_prefetchers)


class Prefetcher:
    """Background-thread prefetch of an iterator. An error of the iterator
    is raised by the ``next()`` that would have returned its item.

    The producer checks a stop flag between bounded puts so interpreter
    teardown never aborts inside a blocking queue operation."""

    def __init__(self, it: Iterator, depth: int = 4):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def run():
            try:
                for item in it:
                    while not self._stop.is_set():
                        try:
                            self.q.put(item, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # raised again by __next__
                self._err = e
            # the end of the stream, or its error: wake the consumer
            while not self._stop.is_set():
                try:
                    self.q.put(None, timeout=0.25)
                    return
                except queue.Full:
                    continue

        self.t = threading.Thread(target=run, daemon=True)
        self.t.start()
        _live_prefetchers.add(self)

    def close(self):
        """Terminal shutdown (drops one queued batch to unblock the
        producer); do not use the iterator after calling this."""
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout=2.0)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            self.q.put(None)  # later calls end the same way
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


# ---- stage registry -------------------------------------------------------

# Per-stage full_size defaults: the floor multiple of 8 of each stage's
# native source size (mixed stages: the elementwise min over members), so
# the augmentor's upscale of smaller sources never engages unless
# --full_size asks for a larger frame.
FULL_SIZE_DEFAULTS = {
    "chairs": (384, 512),
    "chairs_unsup": (384, 512),
    "things": (536, 960),
    "things_unsup": (536, 960),
    "sintel_unsup_test": (432, 1024),
    "sintel_unsup_train": (432, 1024),  # + Spring (1072, 1920): min -> sintel
    "sintel_unsup_labeled_train": (432, 1024),
    "sintel_unsup_part1": (432, 1024),
    "sintel_unsup_part2": (432, 1024),
    "sintel_multiframe": (432, 1024),
    "kitti_unsup": (368, 1240),  # canonical multiview frame 375x1242
    "kitti_unsup_test": (368, 1240),
    "kitti2015_unsup": (368, 1240),
    "hd1k": (1072, 2560),
    "ctskh": (368, 512),  # min over C(384,512)/T(536,960)/S(432,1024)/K(368,1240)/H
    "davis_unsup": (480, 848),  # DAVIS 480p frames are 480x854
}
GENERIC_FULL_SIZE = (440, 1024)


def resolve_full_size(stage: str, full_size):
    """Explicit config wins; None = the stage's native floor-8 bucket."""
    if full_size is not None:
        return tuple(full_size)
    return FULL_SIZE_DEFAULTS.get(stage, GENERIC_FULL_SIZE)


def _with_backward(bases) -> list[FlowRecord]:
    recs = []
    for base in bases:
        recs.extend(base)
        recs.extend(D.backward(base))
    return recs


def stage_records(stage: str):
    """-> (records, aug_param dict) for a stage name."""
    if stage in ("chairs", "chairs_unsup"):
        return D.flying_chairs(True), dict(min_scale=-0.1, max_scale=1.0, do_flip=True)
    if stage in ("things", "things_unsup"):
        recs = D.flying_things("frames_finalpass") + D.flying_things("frames_cleanpass")
        lo = 0.0 if stage == "things" else -0.4
        return recs, dict(min_scale=lo, max_scale=0.8, do_flip=True)
    if stage in ("sintel_unsup_test", "sintel_unsup_train"):
        training = stage == "sintel_unsup_train"
        bases = [D.sintel(training, dstype) if interval == 1
                 else D.sintel_unsup_interval(training, dstype)
                 for dstype in ("final", "clean") for interval in (1, 2)]
        if training:
            bases += [D.spring(interval) for interval in (1, 2)]
        return _with_backward(bases), dict(min_scale=-0.5, max_scale=0.6, do_flip=True)
    if stage in ("kitti_unsup_test", "kitti_unsup"):
        training = stage == "kitti_unsup"
        bases = [D.kitti_multiview(training, interval) for interval in (1, 2)]
        return _with_backward(bases), dict(min_scale=-0.2, max_scale=0.6, do_flip=True)
    if stage == "kitti2015_unsup":
        return D.kitti(True), dict(min_scale=-0.2, max_scale=0.6, do_flip=True)
    if stage == "sintel_unsup_labeled_train":
        bases = [D.sintel(True, dstype) for dstype in ("final", "clean")]
        return _with_backward(bases), dict(min_scale=-0.5, max_scale=0.6, do_flip=True)
    if stage in ("sintel_unsup_part1", "sintel_unsup_part2"):
        part = 1 if stage.endswith("1") else 2
        bases = [D.sintel_unsup_part(part, dstype) for dstype in ("final", "clean")]
        return _with_backward(bases), dict(min_scale=-0.1, max_scale=1.0, do_flip=True)
    if stage == "sintel_multiframe":
        recs = D.sintel_multiframe(True, "final") + D.sintel_multiframe(True, "clean")
        return recs, dict(min_scale=-0.1, max_scale=1.0, do_flip=True)
    if stage == "hd1k":
        return D.hd1k(), dict(min_scale=-0.1, max_scale=1.0, do_flip=True)
    if stage == "ctskh":
        # mixed C+T+S+K+H supervised stage with RAFT's oversampling: 100x
        # sintel, 200x kitti, 5x hd1k against 1x things
        recs = list(D.flying_things("frames_cleanpass"))
        for dstype in ("clean", "final"):
            recs += D.sintel(True, dstype) * 100
        recs += D.kitti(True) * 200
        recs += D.hd1k() * 5
        return recs, dict(min_scale=-0.2, max_scale=0.6, do_flip=True)
    if stage == "davis_unsup":
        frame_root = os.path.join(paths.DAVIS, "JPEGImages", "480p")
        scenes = sorted(os.listdir(frame_root)) if os.path.isdir(frame_root) else []
        bases = [D.frames_directory(os.path.join(frame_root, scene)) for scene in scenes]
        return _with_backward(bases), dict(min_scale=-0.5, max_scale=0.6, do_flip=True)
    raise NotImplementedError(f"unknown stage: {stage}")


def fetch_dataloader(train_cfg, seed: Optional[int] = None, shard=(0, 1)):
    """A ``Prefetcher`` of batches for TrainCfg.stage.

    ``semi-<unsup_stage>-<sup_stage>`` yields (sup_batch, unsup_batch), both
    through the UnsupAugmentor (the sup stream at image_size, the unsup one
    at unsup_image_size with seed + 1); ``*unsup*`` stages the UnsupAugmentor
    dict; ``sintel_multiframe`` frame triplets; the rest supervised batches.
    ``shard``: (rank, world), this rank's rows of every global batch of
    ``batch_size``."""
    seed = train_cfg.seed if seed is None else seed
    stage = train_cfg.stage
    workers = train_cfg.loader_workers
    rot = dict(do_rotation=train_cfg.do_rotation, max_rotation=train_cfg.max_rotation,
               shard=tuple(shard))
    if stage == "sintel_multiframe":
        records, aug = stage_records(stage)
        pipe = MultiFramePipeline(records, train_cfg.image_size, batch_size=train_cfg.batch_size,
                                  seed=seed, workers=workers, shard=tuple(shard), **aug)
        return Prefetcher(iter(pipe))
    if stage.startswith("semi-"):
        _, unsup_stage, sup_stage = stage.split("-", 2)
        unsup_recs, unsup_aug = stage_records(unsup_stage)
        sup_recs, sup_aug = stage_records(sup_stage)
        sup = UnsupPipeline(
            sup_recs, train_cfg.image_size, batch_size=train_cfg.batch_size,
            full_size=resolve_full_size(sup_stage, train_cfg.full_size),
            seed=seed, workers=workers, **sup_aug, **rot,
        )
        unsup = UnsupPipeline(
            unsup_recs, train_cfg.unsup_image_size, batch_size=train_cfg.batch_size,
            full_size=resolve_full_size(unsup_stage, train_cfg.full_size),
            seed=seed + 1, workers=workers, **unsup_aug, **rot,
        )
        return Prefetcher(semi_zip(iter(unsup), iter(sup)))
    records, aug = stage_records(stage)
    if "unsup" in stage:
        # *_unsup stages carry the UnsupAugmentor contract (full frames, an
        # 8-aligned crop and its offsets) whether or not they have labels
        pipe = UnsupPipeline(
            records, train_cfg.image_size, batch_size=train_cfg.batch_size,
            full_size=resolve_full_size(stage, train_cfg.full_size),
            seed=seed, workers=workers, **aug, **rot,
        )
        return Prefetcher(iter(pipe))
    pipe = SupervisedPipeline(records, train_cfg.image_size, batch_size=train_cfg.batch_size,
                              seed=seed, workers=workers, **aug, **rot)
    return Prefetcher(iter(pipe))
