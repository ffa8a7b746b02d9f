"""The least work of a correlation lookup and of its backward, whatever
kernel does it (copied from chip_smoke.py ``support_taps`` / ``bound``):

- operations: the dot products of each query's in-map support taps, (2r+2)^2
  a level at coords / 2^l, C multiply-adds each, and 7 for each output's
  4-tap combine; the backward makes each product twice (d_f1 and d_f2) and
  adds the combine's transpose;
- bytes: every input read once and every output written once (f1, the
  pooled f2 levels, the coords and the windows; the backward reads the
  windows' cotangent and writes d_f1 and float32 d_f2 accumulators).

The least time is the larger of bytes at the HBM rate and operations at the
peak for the input type (``peaks.json``).
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
COMBINE_FLOPS = 7
BYTES = {"bfloat16": 2, "float32": 4}


def support_taps(coords: torch.Tensor, shapes, radius: int) -> int:
    """In-map support taps of all queries at coords [..., 2] (x, y, level 0)
    over the levels ``shapes`` [(h2, w2)]."""
    sup = 2 * radius + 2
    c = coords.reshape(-1, 2).float()
    total = 0
    for lvl, (h2, w2) in enumerate(shapes):
        fl = torch.floor(c * (1.0 / 2.0 ** lvl))
        bx = torch.clamp(fl[:, 0] - radius, -sup, w2)
        by = torch.clamp(fl[:, 1] - radius, -sup, h2)
        nx = torch.clamp(torch.clamp(bx + sup, max=w2) - torch.clamp(bx, min=0), min=0)
        ny = torch.clamp(torch.clamp(by + sup, max=h2) - torch.clamp(by, min=0), min=0)
        total += int((nx * ny).sum())
    return total


def level_shapes(h8: int, w8: int, levels: int) -> list:
    """(h2, w2) of each pooled level ('SAME' pooling by 2^l)."""
    return [(-(-h8 // 2 ** lvl), -(-w8 // 2 ** lvl)) for lvl in range(levels)]


def work(queries: int, taps: int, channels: int, shapes, radius: int, dtype: str,
         backward: bool = False) -> tuple[float, float]:
    """(bytes, operations) of one lookup (or its backward) of ``queries``
    queries over maps of ``shapes`` with ``taps`` in-map support taps."""
    s = BYTES[dtype]
    outs = queries * len(shapes) * (2 * radius + 1) ** 2
    f1 = queries * channels * s
    f2 = sum(h * w for h, w in shapes) * channels
    coords = queries * 2 * 4
    if not backward:
        return f1 + f2 * s + coords + outs * s, 2.0 * channels * taps + COMBINE_FLOPS * outs
    return (f1 + f2 * s + coords + outs * s + f1 + f2 * 4,
            4.0 * channels * taps + COMBINE_FLOPS * outs)


def least_seconds(nbytes: float, ops: float, dtype: str) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["ops_per_s"][dtype])
