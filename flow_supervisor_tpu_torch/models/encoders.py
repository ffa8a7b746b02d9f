"""RAFT feature / context encoder (counterpart of flow_supervisor_tpu/models/encoders.py).

``BasicEncoder``: 7x7 s2 conv -> norm -> relu -> three residual stages
(64 s1, 96 s2, 128 s2; two ``ResidualBlock``s each) -> 1x1 conv to output_dim.
fnet uses instance norm (output 256), cnet batch norm (output 256 = hidden
128 + context 128). Module names follow the reference torch RAFT
(``conv1``, ``norm1``, ``layer1.0.conv1``, ``layer2.0.downsample.0``, ...).

With instance norm the kernels carry the encoder: every 3x3 stride-1
conv -> norm -> relu pair runs as K2 + K4 (kernels/conv3x3.py), and every other
instance norm (stem, after each stride-2 conv1, downsample) as K3 + K4
(kernels/norm.py). Batch-norm encoders run no kernel of this package.

Activations are NCHW in ``torch.channels_last`` memory format.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flow_supervisor_tpu_torch.kernels.conv3x3 import conv3x3_instnorm_relu
from flow_supervisor_tpu_torch.models.layers import (
    InstanceNorm,
    conv2d,
    make_norm,
    nchw,
    nhwc,
)


def _conv_instnorm_relu(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 conv -> instance norm -> relu through K2 + K4, the
    parameters cast to x's dtype."""
    w = conv.weight.to(x.dtype).permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
    return nchw(conv3x3_instnorm_relu(nhwc(x), w, conv.bias.to(x.dtype), relu=True))


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str = "batch", stride: int = 1):
        super().__init__()
        self.instance = norm == "instance"
        self.stride = stride
        self.conv1 = conv2d(in_planes, planes, 3, stride)
        self.conv2 = conv2d(planes, planes, 3, 1)
        if self.instance:
            # the stride-1 conv -> norm -> relu pairs run as K2 + K4 instead
            self.norm1 = InstanceNorm(relu=True) if stride != 1 else None
        else:
            self.norm1 = make_norm(norm, planes)
            self.norm2 = make_norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                conv2d(in_planes, planes, 1, stride), make_norm(norm, planes)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.instance:
            if self.stride == 1:
                y = _conv_instnorm_relu(self.conv1, x)
            else:
                y = self.norm1(self.conv1(x))  # K3 + K4 with relu
            y = _conv_instnorm_relu(self.conv2, y)
        else:
            y = F.relu(self.norm1(self.conv1(x)))
            y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, norm: str = "batch"):
        super().__init__()
        self.conv1 = conv2d(3, 64, 7, 2)
        self.norm1 = InstanceNorm(relu=True) if norm == "instance" else make_norm(norm, 64)
        self.instance = norm == "instance"
        in_planes = 64
        for i, (dim, stride) in enumerate(((64, 1), (96, 2), (128, 2)), start=1):
            layer = nn.Sequential(
                ResidualBlock(in_planes, dim, norm, stride),
                ResidualBlock(dim, dim, norm, 1),
            )
            setattr(self, f"layer{i}", layer)
            in_planes = dim
        self.conv2 = conv2d(128, output_dim, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW image batch -> NCHW features at 1/8 resolution."""
        x = self.norm1(self.conv1(x))
        if not self.instance:
            x = F.relu(x)
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
