"""Evaluation-time replicate-edge padding to a multiple of 8
(counterpart of pad_spec_for / pad_to_multiple / unpad in
flow_supervisor_tpu/ops/pad.py).

'sintel' mode centres the pad both ways; 'kitti' mode puts the height pad at
the bottom and centres the width pad.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_spec_for(ht: int, wd: int, mode: str = "sintel", multiple: int = 8):
    """((top, bottom), (left, right)) pad amounts to reach a multiple."""
    m = multiple
    pad_ht = (((ht // m) + 1) * m - ht) % m
    pad_wd = (((wd // m) + 1) * m - wd) % m
    if mode == "sintel":
        return (pad_ht // 2, pad_ht - pad_ht // 2), (pad_wd // 2, pad_wd - pad_wd // 2)
    return (0, pad_ht), (pad_wd // 2, pad_wd - pad_wd // 2)


def pad_to_multiple(x: torch.Tensor, mode: str = "sintel", multiple: int = 8):
    """Replicate-edge pad NHWC to a multiple; returns (padded, spec)."""
    spec = pad_spec_for(x.shape[1], x.shape[2], mode, multiple)
    (t, b), (l, r) = spec
    out = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b), mode="replicate")
    return out.permute(0, 2, 3, 1), spec


def unpad(x: torch.Tensor, spec) -> torch.Tensor:
    (t, b), (l, r) = spec
    return x[:, t : x.shape[1] - b, l : x.shape[2] - r]
