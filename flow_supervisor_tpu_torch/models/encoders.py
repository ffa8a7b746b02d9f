"""RAFT feature / context encoders (counterpart of flow_supervisor_tpu/models/encoders.py).

``BasicEncoder``: 7x7 s2 conv -> norm -> relu -> three residual stages
(64 s1, 96 s2, 128 s2; two ``ResidualBlock``s each) -> 1x1 conv to output_dim.
fnet uses instance norm (output 256), cnet batch norm (output 256 = hidden
128 + context 128).

``SmallEncoder`` (the small model): 7x7 s2 conv to 32 channels -> norm ->
relu -> three bottleneck stages (32 s1, 64 s2, 96 s2; two
``BottleneckBlock``s each: 1x1, 3x3 (strided), 1x1 at a quarter of the
width, each followed by norm and relu) -> 1x1 conv to output_dim. fnet uses
instance norm (output 128), cnet none (output 160 = hidden 96 + context 64).

Module names follow the reference torch RAFT (``conv1``, ``norm1``,
``layer1.0.conv1``, ``layer2.0.downsample.0``, ``layer1.0.conv3``, ...).

With instance norm the kernels carry the encoder: every 3x3 stride-1
conv -> norm -> relu pair runs as K2 + K4 (kernels/conv3x3.py), and every other
instance norm (stem, after each stride-2 conv1, downsample) as K3 + K4
(kernels/norm.py). Every instance norm of ``SmallEncoder`` runs as K3 + K4:
its 3x3 convs are a quarter of the block's width and come after a 1x1, so
no pair fuses into K2. Batch-, group- and no-norm encoders run no kernel of
this package. Under a space shard (parallel/spatial.py) each K2 + K4 pair
runs as K5 + K3's sums + K4 (``_conv_instnorm_relu``), and every other
instance norm as K3's sums + K4, both with moments over the whole frame.

Activations are NCHW in ``torch.channels_last`` memory format.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flow_supervisor_tpu_torch.kernels.conv3x3 import conv3x3_bare, conv3x3_instnorm_relu
from flow_supervisor_tpu_torch.kernels.norm import instance_norm_apply
from flow_supervisor_tpu_torch.models.layers import (
    InstanceNorm,
    conv2d,
    global_instance_stats,
    make_norm,
    nchw,
    nhwc,
)
from flow_supervisor_tpu_torch.parallel import spatial


def _conv_instnorm_relu(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 conv -> instance norm -> relu through K2 + K4, the
    parameters cast to x's dtype.

    Under a space shard K2's statistics would cover only the shard's rows,
    so the pair runs in three steps: K5 on the rows with a 1-row halo from
    the neighbouring ranks (cropped back to the shard), the moments of the
    whole frame (K3's sums, summed over the world), then K4 with relu. The
    statistics are then those of the conv output in x's dtype, where K2
    takes them from the fp32 accumulator: the same in fp32, rounded to bf16
    first in a bf16 run (as JAX's space-sharded forward, ``fused_norm=False``)."""
    w = conv.weight.to(x.dtype).permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
    b = conv.bias.to(x.dtype)
    if spatial.current() is None:
        return nchw(conv3x3_instnorm_relu(nhwc(x), w, b, relu=True))
    rows = x.shape[2]
    y = conv3x3_bare(spatial.halo_rows(nhwc(x), 1, 1), w, b)[:, 1 : rows + 1].contiguous()
    return nchw(instance_norm_apply(y, global_instance_stats(y), relu=True))


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


class BottleneckBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str = "group", stride: int = 1):
        super().__init__()
        hidden = planes // 4
        self.conv1 = conv2d(in_planes, hidden, 1)
        self.conv2 = conv2d(hidden, hidden, 3, stride)
        self.conv3 = conv2d(hidden, planes, 1)
        self.instance = norm == "instance"
        if self.instance:  # each conv -> norm -> relu as K3 + K4 with relu
            self.norm1, self.norm2, self.norm3 = (InstanceNorm(relu=True) for _ in range(3))
        else:  # group norm: planes // 8 groups in every norm of the block
            groups = planes // 8
            self.norm1 = make_norm(norm, hidden, groups)
            self.norm2 = make_norm(norm, hidden, groups)
            self.norm3 = make_norm(norm, planes, groups)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                conv2d(in_planes, planes, 1, stride), make_norm(norm, planes, planes // 8)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        relu = (lambda t: t) if self.instance else F.relu
        y = relu(self.norm1(self.conv1(x)))
        y = relu(self.norm2(self.conv2(y)))
        y = relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class SmallEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, norm: str = "batch"):
        super().__init__()
        self.conv1 = conv2d(3, 32, 7, 2)
        self.instance = norm == "instance"
        self.norm1 = InstanceNorm(relu=True) if self.instance else make_norm(norm, 32, 8)
        in_planes = 32
        for i, (dim, stride) in enumerate(((32, 1), (64, 2), (96, 2)), start=1):
            layer = nn.Sequential(
                BottleneckBlock(in_planes, dim, norm, stride),
                BottleneckBlock(dim, dim, norm, 1),
            )
            setattr(self, f"layer{i}", layer)
            in_planes = dim
        self.conv2 = conv2d(96, output_dim, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW image batch -> NCHW features at 1/8 resolution."""
        x = self.norm1(self.conv1(x))
        if not self.instance:
            x = F.relu(x)
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
