"""Weight bridges into the port's ``state_dict``: from the JAX package's
flax parameters (the inverse of ``flow_supervisor_tpu.convert.convert_torch_raft``),
from the reference's TensorFlow checkpoints and from the reference's
PyTorch state dicts.

``from_flax(params, batch_stats)``:

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

``load_tf_checkpoint(prefix)``: a reference TF object-graph checkpoint
(``tf.train.Checkpoint(model=...)``, e.g. ``ckpt-100000-weights``) read by
``tf_bundle.BundleReader`` (no TensorFlow), its Keras attribute paths mapped
to flax's tree by the port's own copy of the JAX package's mapping
(``convert_tf_checkpoint``: RAFT with or without the teacher head, which it
detects), then ``from_flax``.

``load_torch_checkpoint(path)``: a reference PyTorch ``state_dict``
(``torch.load(weights_only=True)``, its ``"model"`` entry if it has one),
``module.`` prefixes stripped and the flow supervisor's
``grad_update_block`` renamed ``teacher_update_block``; the port's modules
carry the reference's names, so every other key (GMA's ``att.*`` with its
position tables, the aggregators, the small model) loads as it is.

numpy in, torch tensors out; nothing here imports JAX or TensorFlow.
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


# ---- the reference's PyTorch checkpoints ------------------------------------


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """The port's state dict from a reference PyTorch RAFT / L2L / GMA
    ``.pth`` file (its ``"model"`` entry when it holds one): ``module.``
    (DataParallel) stripped, ``grad_update_block`` (the flow supervisor's
    teacher, pytorch/core/l2l.py) renamed ``teacher_update_block``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), Mapping):
        sd = sd["model"]
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.startswith("grad_update_block."):
            k = "teacher_update_block." + k[len("grad_update_block."):]
        out[k] = v
    return out


# ---- the reference's TensorFlow checkpoints ---------------------------------
#
# The reference's released checkpoints are TF object-graph checkpoints
# written as tf.train.Checkpoint(model=<RAFT subclass>). Variable keys follow
# the Keras attribute graph, e.g.
#   model/fnet/conv1/kernel/.ATTRIBUTES/VARIABLE_VALUE
#   model/cnet/layer2/layer_with_weights-0/norm1/gamma/...
#   model/update_block/gru/convz1/bias/...
#   model/teacher_update_block/...                       (semi checkpoints)
# Sequential members appear as layer_with_weights-N; TF conv kernels are
# [kh, kw, in, out], flax's layout. The mapping below is the JAX package's
# (flow_supervisor_tpu/convert.py, _TFVars ... convert_tf_checkpoint).

_TF_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


class _TFVars:
    """Normalized view over a checkpoint reader: 'model/' + attribute path
    (no .ATTRIBUTES suffix) -> tensor."""

    def __init__(self, reader):
        self.reader = reader
        self.index = {}
        for full in reader.get_variable_to_shape_map():
            if not full.endswith(_TF_SUFFIX):
                continue
            norm = full[: -len(_TF_SUFFIX)]
            if norm.startswith("model/"):
                norm = norm[len("model/"):]
            elif norm.split("/")[0] in ("optimizer", "save_counter", "step"):
                continue
            self.index[norm] = full

    def __contains__(self, key):
        return key in self.index

    def get(self, *alternatives) -> np.ndarray:
        for a in alternatives:
            if a in self.index:
                return np.asarray(self.reader.get_tensor(self.index[a]))
        raise KeyError(f"none of {alternatives} in TF checkpoint")


def _tf_conv(v: _TFVars, *names) -> dict:
    return {"Conv_0": {"kernel": v.get(*[n + "/kernel" for n in names]),
                       "bias": v.get(*[n + "/bias" for n in names])}}


def _tf_bn(v: _TFVars, *names):
    params = {"BatchNorm_0": {"scale": v.get(*[n + "/gamma" for n in names]),
                              "bias": v.get(*[n + "/beta" for n in names])}}
    stats = {"BatchNorm_0": {"mean": v.get(*[n + "/moving_mean" for n in names]),
                             "var": v.get(*[n + "/moving_variance" for n in names])}}
    return params, stats


def _tf_encoder(v: _TFVars, prefix: str, batch_norm: bool):
    p: dict = {"ExtractorConv_0": _tf_conv(v, f"{prefix}/conv1")}
    stats: dict = {}
    if batch_norm:
        p["Norm_0"], stats["Norm_0"] = _tf_bn(v, f"{prefix}/norm1")
    block_i = 0
    for layer in (1, 2, 3):
        for sub in (0, 1):
            # Sequential-tracked ResidualBlocks
            t = f"{prefix}/layer{layer}/layer_with_weights-{sub}"
            t_alt = f"{prefix}/layer{layer}/layer-{sub}"
            bp: dict = {"ExtractorConv_0": _tf_conv(v, f"{t}/conv1", f"{t_alt}/conv1"),
                        "ExtractorConv_1": _tf_conv(v, f"{t}/conv2", f"{t_alt}/conv2")}
            bs: dict = {}
            if batch_norm:
                bp["Norm_0"], bs["Norm_0"] = _tf_bn(v, f"{t}/norm1", f"{t_alt}/norm1")
                bp["Norm_1"], bs["Norm_1"] = _tf_bn(v, f"{t}/norm2", f"{t_alt}/norm2")
            # strided blocks have a downsample Sequential([conv, norm3])
            ds = f"{t}/downsample/layer_with_weights-0"
            ds_alts = (ds, f"{t}/downsample/layer-0", f"{t_alt}/downsample/layer_with_weights-0")
            if any(a + "/kernel" in v for a in ds_alts):
                bp["ExtractorConv_2"] = _tf_conv(v, *ds_alts)
                if batch_norm:
                    # norm3 is tracked both as an attribute and inside the
                    # Sequential; accept whichever path the writer kept
                    bp["Norm_2"], bs["Norm_2"] = _tf_bn(
                        v, f"{t}/norm3", f"{t}/downsample/layer_with_weights-1",
                        f"{t_alt}/norm3", f"{t}/downsample/layer-1")
            p[f"ResidualBlock_{block_i}"] = bp
            if bs:
                stats[f"ResidualBlock_{block_i}"] = bs
            block_i += 1
    p["ExtractorConv_1"] = _tf_conv(v, f"{prefix}/conv2")
    return p, stats


def _tf_update_block(v: _TFVars, prefix: str) -> dict:
    enc = ("convc1", "convc2", "convf1", "convf2", "conv")
    gru = ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")
    return {
        "BasicMotionEncoder_0": {f"UpdateConv_{i}": _tf_conv(v, f"{prefix}/encoder/{n}")
                                 for i, n in enumerate(enc)},
        "SepConvGRU_0": {f"UpdateConv_{i}": _tf_conv(v, f"{prefix}/gru/{n}")
                         for i, n in enumerate(gru)},
        "FlowHead_0": {"UpdateConv_0": _tf_conv(v, f"{prefix}/flow_head/conv1"),
                       "UpdateConv_1": _tf_conv(v, f"{prefix}/flow_head/conv2")},
        # the mask head Sequential([conv 3x3, relu, conv 1x1])
        "UpdateConv_0": _tf_conv(v, f"{prefix}/mask/layer_with_weights-0", f"{prefix}/mask/layer-0"),
        "UpdateConv_1": _tf_conv(v, f"{prefix}/mask/layer_with_weights-1", f"{prefix}/mask/layer-2"),
    }


def convert_tf_checkpoint(reader, teacher: bool | None = None):
    """A checkpoint reader (``tf_bundle.BundleReader`` or TensorFlow's) ->
    (params, batch_stats) pytrees of the JAX package's RAFT. teacher=None
    detects the flow supervisor's head (model/teacher_update_block/...)."""
    v = _TFVars(reader)
    if teacher is None:
        teacher = "teacher_update_block/encoder/convc1/kernel" in v
    params: dict = {}
    stats: dict = {}
    params["fnet"], _ = _tf_encoder(v, "fnet", batch_norm=False)
    params["cnet"], stats["cnet"] = _tf_encoder(v, "cnet", batch_norm=True)
    params["update_block"] = _tf_update_block(v, "update_block")
    if teacher:
        params["teacher_update_block"] = _tf_update_block(v, "teacher_update_block")
    return params, stats


def load_tf_checkpoint(prefix: str, teacher: bool | None = None) -> dict[str, torch.Tensor]:
    """The port's state dict of a reference TF checkpoint prefix (RAFT, with
    the teacher head when the checkpoint has one)."""
    from flow_supervisor_tpu_torch.tf_bundle import BundleReader

    return from_flax(*convert_tf_checkpoint(BundleReader(prefix), teacher=teacher))
