"""Seeded weights for a model's state dict, made on the device in one draw.

One uniform draw in [-1, 1) of every parameter's elements at once, each
tensor then scaled by its layer's initializer width (the JAX package's and
the reference RAFT's rules): the encoders' conv kernels He fan-out
(variance 2 / fan_out), every other conv kernel and every bias
U(+-1/sqrt(fan_in)). Batch norm keeps scale 1, bias 0 and its running
statistics 0 and 1; GMA's aggregation ``gamma`` takes the configuration's
value (it starts at zero, which would leave the attention out); the
relative-position tables are N(0, 1)-wide. The harness keeps these float32
tensors as the masters that both the program and the reference receive.
"""
from __future__ import annotations

import math

import torch

from flowbench.frames import generator

EXTRACTORS = ("fnet.", "cnet.")


def _width(name: str, shape, state: dict) -> float | None:
    """Half-width of the uniform draw of ``name``, None to keep its value."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 4 and leaf == "weight":
        c_out, c_in, kh, kw = shape
        if name.startswith(EXTRACTORS):
            return math.sqrt(3.0) * math.sqrt(2.0 / (c_out * kh * kw))
        return 1.0 / math.sqrt(c_in * kh * kw)
    if leaf == "bias" and (name[:-4] + "weight") in state and state[name[:-4] + "weight"].dim() == 4:
        _, c_in, kh, kw = state[name[:-4] + "weight"].shape
        return 1.0 / math.sqrt(c_in * kh * kw)
    if ".rel_height." in name or ".rel_width." in name:
        return math.sqrt(3.0)
    return None


def make(state: dict, seed: int, device, gamma: float | None = None) -> dict:
    """float32 masters for the entries of ``state`` (a state dict) -> a new
    dict on ``device``: drawn tensors for conv kernels, biases and tables,
    ``gamma`` for every ``.gamma``, the rest copied as it is."""
    drawn = {k: _width(k, v.shape, state) for k, v in state.items()}
    total = sum(state[k].numel() for k, wd in drawn.items() if wd is not None)
    flat = torch.rand(total, generator=generator(seed, device), device=device) * 2.0 - 1.0
    out, at = {}, 0
    for k, v in state.items():
        wd = drawn[k]
        if wd is not None:
            n = v.numel()
            out[k] = (flat[at : at + n] * wd).reshape(v.shape)
            at += n
        elif k.endswith(".gamma") and gamma is not None:
            out[k] = torch.full(v.shape, float(gamma), device=device)
        elif v.is_floating_point():
            out[k] = v.detach().to(device=device, dtype=torch.float32).clone()
    return out


@torch.no_grad()
def load(model: torch.nn.Module, masters: dict) -> None:
    """Copy the masters into the model's own tensors, in their dtypes."""
    for k, t in model.state_dict().items():
        if k in masters:
            t.copy_(masters[k].to(t.dtype))
