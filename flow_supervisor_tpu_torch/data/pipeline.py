"""Record loading (counterpart of ``load_record`` and ``_crop_or_pad`` in
flow_supervisor_tpu/data/pipeline.py). The augmentors, the training
loaders and the prefetcher are not ported yet (ROADMAP Queue 1, item 3)."""
from __future__ import annotations

import numpy as np

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
