"""Weight bridge from the JAX package's flax parameters to the port's
``state_dict`` (the inverse of ``flow_supervisor_tpu.convert.convert_torch_raft``).

- flax conv kernel [kh, kw, in, out] (HWIO) -> torch [out, in, kh, kw] (OIHW);
- flax BatchNorm scale / bias + batch_stats mean / var -> BatchNorm2d
  weight / bias / running_mean / running_var;
- flax GroupNorm scale / bias -> GroupNorm weight / bias;
- flax module paths (``ResidualBlock_3/ExtractorConv_1``) -> the reference
  torch names the port uses (``layer2.1.conv2``); the flow supervisor's
  teacher head, where present, maps like the update block;
- the small model (``BottleneckBlock_i``, ``SmallMotionEncoder_0``,
  ``ConvGRU_0``) and GMA (``att/Conv_0`` -> ``att.to_qk``,
  ``att/RelPosEmb_0/rel_height|rel_width`` ->
  ``att.pos_emb.rel_height|rel_width.weight``, ``*/Aggregate_0/Conv_0|Conv_1|gamma``
  -> ``*.aggregator.to_v|project|gamma``), found by the tree's own keys. The
  JAX package's ``convert_torch_raft`` maps GMA's ``to_qk`` and aggregator
  but neither the position tables nor the small model.

numpy in, torch tensors out; nothing here imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _conv(sd: dict, name: str, p: Mapping) -> None:
    sd[name + ".weight"] = np.asarray(p["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
    sd[name + ".bias"] = np.asarray(p["Conv_0"]["bias"])


def _kernel(sd: dict, name: str, p: Mapping) -> None:
    """A bias-free flax nn.Conv (``{"kernel"}``) -> name.weight."""
    sd[name + ".weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)


def _norm(sd: dict, name: str, p: Mapping, s: Mapping | None, key: str) -> None:
    """A Norm's parameters, where it has any: batch (with its statistics) or group."""
    if key not in p:
        return
    if "BatchNorm_0" in p[key]:
        _bn(sd, name, p[key], s[key])
    elif "GroupNorm_0" in p[key]:
        sd[name + ".weight"] = np.asarray(p[key]["GroupNorm_0"]["scale"])
        sd[name + ".bias"] = np.asarray(p[key]["GroupNorm_0"]["bias"])


def _bn(sd: dict, name: str, p: Mapping, s: Mapping) -> None:
    sd[name + ".weight"] = np.asarray(p["BatchNorm_0"]["scale"])
    sd[name + ".bias"] = np.asarray(p["BatchNorm_0"]["bias"])
    sd[name + ".running_mean"] = np.asarray(s["BatchNorm_0"]["mean"])
    sd[name + ".running_var"] = np.asarray(s["BatchNorm_0"]["var"])
    sd[name + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _encoder(sd: dict, prefix: str, p: Mapping, s: Mapping | None) -> None:
    """BasicEncoder (ResidualBlock_i) or SmallEncoder (BottleneckBlock_i)."""
    s = s or {}
    _conv(sd, f"{prefix}.conv1", p["ExtractorConv_0"])
    _norm(sd, f"{prefix}.norm1", p, s, "Norm_0")
    kind = "BottleneckBlock" if "BottleneckBlock_0" in p else "ResidualBlock"
    convs = 3 if kind == "BottleneckBlock" else 2
    block_i = 0
    for layer in (1, 2, 3):
        for sub in (0, 1):
            _block(sd, f"{prefix}.layer{layer}.{sub}", p[f"{kind}_{block_i}"],
                   s.get(f"{kind}_{block_i}", {}), convs)
            block_i += 1
    _conv(sd, f"{prefix}.conv2", p["ExtractorConv_1"])


def _block(sd: dict, t: str, bp: Mapping, bs: Mapping, convs: int) -> None:
    """A ResidualBlock (2 convs) or BottleneckBlock (3): conv{i} / norm{i},
    and the strided skip's downsample.0 / .1."""
    for i in range(convs):
        _conv(sd, f"{t}.conv{i + 1}", bp[f"ExtractorConv_{i}"])
        _norm(sd, f"{t}.norm{i + 1}", bp, bs, f"Norm_{i}")
    if f"ExtractorConv_{convs}" in bp:
        _conv(sd, f"{t}.downsample.0", bp[f"ExtractorConv_{convs}"])
        _norm(sd, f"{t}.downsample.1", bp, bs, f"Norm_{convs}")


def _update_block(sd: dict, prefix: str, p: Mapping) -> None:
    """BasicUpdateBlock, GMAUpdateBlock or SmallUpdateBlock."""
    if "SmallMotionEncoder_0" in p:
        enc, names = p["SmallMotionEncoder_0"], ("convc1", "convf1", "convf2", "conv")
        gru, gru_names = p["ConvGRU_0"], ("convz", "convr", "convq")
    else:
        enc, names = p["BasicMotionEncoder_0"], ("convc1", "convc2", "convf1", "convf2", "conv")
        gru = p["SepConvGRU_0"]
        gru_names = ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")
    for i, name in enumerate(names):
        _conv(sd, f"{prefix}.encoder.{name}", enc[f"UpdateConv_{i}"])
    for i, name in enumerate(gru_names):
        _conv(sd, f"{prefix}.gru.{name}", gru[f"UpdateConv_{i}"])
    _conv(sd, f"{prefix}.flow_head.conv1", p["FlowHead_0"]["UpdateConv_0"])
    _conv(sd, f"{prefix}.flow_head.conv2", p["FlowHead_0"]["UpdateConv_1"])
    if "UpdateConv_0" in p:
        _conv(sd, f"{prefix}.mask.0", p["UpdateConv_0"])
        _conv(sd, f"{prefix}.mask.2", p["UpdateConv_1"])
    if "Aggregate_0" in p:
        agg = p["Aggregate_0"]
        _kernel(sd, f"{prefix}.aggregator.to_v", agg["Conv_0"])
        if "Conv_1" in agg:
            _kernel(sd, f"{prefix}.aggregator.project", agg["Conv_1"])
        sd[f"{prefix}.aggregator.gamma"] = np.asarray(agg["gamma"])


def from_flax(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """JAX RAFT (params, batch_stats) pytrees of arrays -> the port's state_dict
    (RAFT, GMA or the small model, with or without the teacher head)."""
    sd: dict = {}
    _encoder(sd, "fnet", params["fnet"], None)
    _encoder(sd, "cnet", params["cnet"], batch_stats.get("cnet"))
    _update_block(sd, "update_block", params["update_block"])
    if "att" in params:
        _kernel(sd, "att.to_qk", params["att"]["Conv_0"])
        if "RelPosEmb_0" in params["att"]:
            for table in ("rel_height", "rel_width"):
                sd[f"att.pos_emb.{table}.weight"] = np.asarray(params["att"]["RelPosEmb_0"][table])
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
