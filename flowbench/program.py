"""The program under test, flow_supervisor_tpu_torch, as the cells build it:
the one module of the harness (with the runners) that imports the port.

A configuration file gives the architecture, a traffic file the precision,
iterations, lookup backend and whether the model has the flow supervisor's
teacher head; the widths the port builds are checked against the file's.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def raft_config(config: dict, traffic: dict):
    from flow_supervisor_tpu_torch.models.raft import RAFTConfig

    m = config["model"]
    return RAFTConfig(
        iters=traffic["iters"], dtype=DTYPES[traffic["dtype"]],
        corr_dtype=DTYPES[traffic.get("corr_dtype", "float32")],
        lookup_backend=traffic["lookup_backend"], gma=m["gma"], num_heads=m["num_heads"],
        position_only=m["position_only"], position_and_content=m["position_and_content"],
        teacher=traffic.get("teacher", False), teacher_iters=traffic.get("teacher_iters", 12),
    ).resolved()


def check_widths(model, config: dict) -> None:
    """Refuse a port whose built model differs from the configuration file."""
    m = config["model"]
    got = {"hidden_dim": model.cfg.hidden_dim, "context_dim": model.cfg.context_dim,
           "fnet_dim": model.fnet.conv2.out_channels, "cnet_dim": model.cnet.conv2.out_channels,
           "corr_levels": model.cfg.corr_levels, "corr_radius": model.cfg.corr_radius}
    want = {k: m[k] for k in got}
    if got != want:
        raise ValueError(f"the port builds {got}, the configuration states {want}")


def inference_model(config: dict, traffic: dict, device):
    """RAFT / GMA in the traffic's dtype, its parameters held in that dtype
    (``RAFT.forward``'s own use), on ``device``, in eval mode."""
    from flow_supervisor_tpu_torch.models.raft import RAFT

    with torch.device(device):
        model = RAFT(raft_config(config, traffic))
    check_widths(model, config)
    return model


def evaluator(model, traffic: dict):
    from flow_supervisor_tpu_torch.evaluation import Evaluator

    return Evaluator(model, iters=traffic["iters"], use_teacher=traffic.get("teacher", False),
                     pad_bucket=traffic["pad_bucket"])


def warm_start():
    from flow_supervisor_tpu_torch.utils.warm_start import forward_interpolate

    return forward_interpolate


def train_step(config: dict, traffic: dict, device):
    """(model, TrainState, step): the step ``training.loop.make_step`` builds
    for the traffic's ModelCfg and TrainCfg fields, the model's fp32 masters
    on ``device``, as ``loop.train`` sets them up (no files, no validation)."""
    from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg
    from flow_supervisor_tpu_torch.training.loop import build_model, make_step
    from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
    from flow_supervisor_tpu_torch.training.state import TrainState

    m = config["model"]
    model_type = ("gma" if m["gma"] else "raft") + "-" + traffic["step"]
    mc = ModelCfg(model_type=model_type, num_heads=m["num_heads"],
                  position_only=m["position_only"],
                  position_and_content=m["position_and_content"], iters=traffic["iters"],
                  teacher_iters=traffic["teacher_iters"], compute_dtype=traffic["dtype"],
                  lookup_backend=traffic["lookup_backend"], **traffic["model"])
    cfg = ExperimentConfig(mc, TrainCfg(batch_size=traffic["batch"], **traffic["train"]))
    with torch.device(device):
        model = build_model(cfg)
    check_widths(model, config)
    tx = make_optimizer(cfg.train, batchnorm_params(model) if model.cfg.freeze_bn else ())
    state = TrainState.create(dict(model.named_parameters()), tx)
    return model, state, make_step(model, cfg)


def launch_counters() -> dict:
    """K6's and K7's own launch counters (kernels/corr_fused.py)."""
    from flow_supervisor_tpu_torch.kernels import corr_fused

    return {"corr_fused_all": corr_fused.all_launches,
            "corr_fused_level": corr_fused.level_launches}


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the port's kernel library."""
    if torch.device(device).type == "cuda":
        from flow_supervisor_tpu_torch.kernels import _build

        _build.lib()
