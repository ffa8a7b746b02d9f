"""Weight bridge from the JAX package's flax parameters to the port's
``state_dict`` (the inverse of ``flow_supervisor_tpu.convert.convert_torch_raft``).

- flax conv kernel [kh, kw, in, out] (HWIO) -> torch [out, in, kh, kw] (OIHW);
- flax BatchNorm scale / bias + batch_stats mean / var -> BatchNorm2d
  weight / bias / running_mean / running_var;
- flax module paths (``ResidualBlock_3/ExtractorConv_1``) -> the reference
  torch names the port uses (``layer2.1.conv2``); the flow supervisor's
  teacher head, where present, maps like the update block.

numpy in, torch tensors out; nothing here imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _conv(sd: dict, name: str, p: Mapping) -> None:
    sd[name + ".weight"] = np.asarray(p["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
    sd[name + ".bias"] = np.asarray(p["Conv_0"]["bias"])


def _bn(sd: dict, name: str, p: Mapping, s: Mapping) -> None:
    sd[name + ".weight"] = np.asarray(p["BatchNorm_0"]["scale"])
    sd[name + ".bias"] = np.asarray(p["BatchNorm_0"]["bias"])
    sd[name + ".running_mean"] = np.asarray(s["BatchNorm_0"]["mean"])
    sd[name + ".running_var"] = np.asarray(s["BatchNorm_0"]["var"])
    sd[name + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _encoder(sd: dict, prefix: str, p: Mapping, s: Mapping | None) -> None:
    _conv(sd, f"{prefix}.conv1", p["ExtractorConv_0"])
    if s is not None:
        _bn(sd, f"{prefix}.norm1", p["Norm_0"], s["Norm_0"])
    block_i = 0
    for layer in (1, 2, 3):
        for sub in (0, 1):
            t = f"{prefix}.layer{layer}.{sub}"
            bp = p[f"ResidualBlock_{block_i}"]
            bs = s[f"ResidualBlock_{block_i}"] if s is not None else None
            _conv(sd, f"{t}.conv1", bp["ExtractorConv_0"])
            _conv(sd, f"{t}.conv2", bp["ExtractorConv_1"])
            if bs is not None:
                _bn(sd, f"{t}.norm1", bp["Norm_0"], bs["Norm_0"])
                _bn(sd, f"{t}.norm2", bp["Norm_1"], bs["Norm_1"])
            if "ExtractorConv_2" in bp:
                _conv(sd, f"{t}.downsample.0", bp["ExtractorConv_2"])
                if bs is not None:
                    _bn(sd, f"{t}.downsample.1", bp["Norm_2"], bs["Norm_2"])
            block_i += 1
    _conv(sd, f"{prefix}.conv2", p["ExtractorConv_1"])


def _update_block(sd: dict, prefix: str, p: Mapping) -> None:
    enc = p["BasicMotionEncoder_0"]
    for i, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv")):
        _conv(sd, f"{prefix}.encoder.{name}", enc[f"UpdateConv_{i}"])
    gru = p["SepConvGRU_0"]
    for i, name in enumerate(("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")):
        _conv(sd, f"{prefix}.gru.{name}", gru[f"UpdateConv_{i}"])
    _conv(sd, f"{prefix}.flow_head.conv1", p["FlowHead_0"]["UpdateConv_0"])
    _conv(sd, f"{prefix}.flow_head.conv2", p["FlowHead_0"]["UpdateConv_1"])
    if "UpdateConv_0" in p:
        _conv(sd, f"{prefix}.mask.0", p["UpdateConv_0"])
        _conv(sd, f"{prefix}.mask.2", p["UpdateConv_1"])


def from_flax(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """JAX RAFT (params, batch_stats) pytrees of arrays -> the port's state_dict."""
    sd: dict = {}
    _encoder(sd, "fnet", params["fnet"], None)
    _encoder(sd, "cnet", params["cnet"], batch_stats["cnet"])
    _update_block(sd, "update_block", params["update_block"])
    if "teacher_update_block" in params:
        _update_block(sd, "teacher_update_block", params["teacher_update_block"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_flax_npz(path: str) -> tuple[dict, dict]:
    """(params, batch_stats) from an .npz whose keys are '/'-joined flax paths
    under 'params/' and 'batch_stats/' (e.g. 'params/fnet/ExtractorConv_0/Conv_0/kernel'),
    as ``np.savez(path, **flax.traverse_util.flatten_dict(variables, sep='/'))``
    writes them."""
    trees: dict = {"params": {}, "batch_stats": {}}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            if parts[0] not in trees:
                raise ValueError(f"{path}: unexpected top-level key {key!r}")
            node = trees[parts[0]]
            for part in parts[1:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return trees["params"], trees["batch_stats"]
