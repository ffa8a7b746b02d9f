"""Conv / norm building blocks (counterpart of flow_supervisor_tpu/models/layers.py).

Convs are ``nn.Conv2d`` (``Conv2d`` below) with torch-style symmetric k//2 padding, so
strided convs downsample exactly like the reference. Initialization matches
the JAX package:

- extractor convs: kernel ~ truncated normal, He fan-out
  (VarianceScaling(2.0, fan_out, truncated_normal)); bias ~ U(+-1/sqrt(fan_in));
- update convs: kernel and bias ~ U(+-1/sqrt(fan_in)), fan_in = c_in * kh * kw.

Norms: ``instance`` is the affine-free instance norm (eps 1e-5, fp32
statistics) of kernels/norm.py, differentiable; ``batch`` is flax's
BatchNorm (``BatchNorm2d`` below: eps 1e-5, momentum 0.99; running
statistics in eval mode, and in training too when the model freezes its
batch norm): with fp32 parameters (training's masters) and a bf16 input it
computes in fp32 and returns bf16, as flax's BatchNorm (param_dtype fp32)
does; ``group`` is flax's GroupNorm (eps 1e-5, fp32 statistics and
parameters, the result in the input's dtype; no model path reaches it, the
small model's encoders take instance norm and none); ``none`` is the
identity.

Every conv casts its weight and bias to its input's dtype (the compute
dtype) at each call: a no-op where the model holds its parameters in that
dtype (inference), the cast of the fp32 masters in training.

Activations inside the models are NCHW tensors in ``torch.channels_last``
memory format, so ``nhwc`` hands the NHWC kernels a view without a copy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from flow_supervisor_tpu_torch.kernels.norm import instance_norm
from flow_supervisor_tpu_torch.parallel import mesh


def _pair(k):
    return tuple(k) if isinstance(k, (tuple, list)) else (k, k)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose parameters are cast to the input's dtype at every
    call, as flax casts its fp32 params to the compute dtype at every apply:
    the gradient of each use comes back to an fp32 master in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv2d(c_in: int, c_out: int, k, stride: int = 1) -> Conv2d:
    """Conv with torch-style symmetric k//2 padding (ExtractorConv / UpdateConv)."""
    kh, kw = _pair(k)
    return Conv2d(c_in, c_out, (kh, kw), stride, (kh // 2, kw // 2))


@torch.no_grad()
def init_conv_(conv: nn.Conv2d, kind: str, generator: torch.Generator | None = None) -> None:
    """Re-draw a conv's parameters with the JAX package's ``kind``
    ('extractor' or 'update') initializers."""
    c_out, c_in, kh, kw = conv.weight.shape
    fan_in = c_in * kh * kw
    limit = 1.0 / math.sqrt(fan_in)
    if kind == "extractor":
        # truncated at +-2 std; flax rescales the std by the truncated normal's
        # own std (0.87962566103423978) so the variance is 2 / fan_out
        std = math.sqrt(2.0 / (c_out * kh * kw)) / 0.87962566103423978
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
    else:
        nn.init.uniform_(conv.weight, -limit, limit, generator=generator)
    if conv.bias is not None:
        nn.init.uniform_(conv.bias, -limit, limit, generator=generator)


def init_weights_(
    module: nn.Module, kind: str, generator: torch.Generator | None = None
) -> None:
    """Initialize every conv under ``module`` with the ``kind`` initializers
    (BatchNorm keeps torch's defaults, which equal flax's: scale 1, bias 0,
    mean 0, var 1)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            init_conv_(m, kind, generator)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> NHWC view; copies only if x is in another format."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


class InstanceNorm(nn.Module):
    """Affine-free instance norm (+ optional relu) through kernels K3 + K4."""

    def __init__(self, relu: bool = False):
        super().__init__()
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(instance_norm(nhwc(x), relu=self.relu))


class BatchNorm2d(nn.BatchNorm2d):
    """flax's BatchNorm (momentum 0.99). In training mode it normalizes by the
    batch's mean and biased variance and moves the running statistics toward
    them: running = 0.99 running + 0.01 batch, with the BIASED variance,
    where ``nn.BatchNorm2d`` moves running_var toward the unbiased one (a
    factor n / (n - 1) apart). In eval mode it is ``nn.BatchNorm2d``'s.

    The batch is the global one, as in JAX's step over the sharded batch: the
    mean and then the biased variance are fp32 sums over every rank's rows
    (``mesh.all_reduce_sum``, differentiable, the identity in a world of 1),
    so each rank normalizes by, and moves its running statistics toward, the
    same global values. One formula serves every world size."""

    MOMENTUM = 0.99

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=1.0 - self.MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        n = xf.numel() // xf.shape[1] * mesh.world_size()
        mean = mesh.all_reduce_sum(xf.sum(dim=(0, 2, 3))) / n
        centred = xf - mean[None, :, None, None]
        var = mesh.all_reduce_sum((centred * centred).sum(dim=(0, 2, 3))) / n
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        scale = self.weight.float() * torch.rsqrt(var + self.eps)
        y = torch.addcmul(self.bias.float()[None, :, None, None], centred,
                          scale[None, :, None, None])
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """flax's GroupNorm: statistics per (sample, group) over its channels and
    the spatial axes, eps 1e-5, computed in fp32 with fp32 parameters, the
    result cast back to the input's dtype."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__(num_groups, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(x.dtype)


def make_norm(kind: str, channels: int, num_groups: int | None = None) -> nn.Module:
    """The reference's norm_fn choices: instance / batch / group / none.
    ``num_groups`` (group only) defaults to channels // 8, the residual and
    bottleneck blocks' rule (the encoders' stems take 8)."""
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return BatchNorm2d(channels)
    if kind == "group":
        return GroupNorm(channels // 8 if num_groups is None else num_groups, channels)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"norm_fn {kind} not implemented in the port")
