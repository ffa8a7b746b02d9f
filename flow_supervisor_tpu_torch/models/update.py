"""RAFT recurrent update blocks (counterpart of flow_supervisor_tpu/models/update.py).

- ``BasicMotionEncoder``: corr -> 1x1 conv 256 -> 3x3 conv 192; flow -> 7x7
  conv 128 -> 3x3 conv 64; concat -> 3x3 conv 126; concat raw flow => 128.
  The correlation channels arrive in the reference dx-major order, so no
  weight permutation is needed.
- ``SepConvGRU``: gated GRU, a horizontal (1x5) then a vertical (5x1) pass.
- ``FlowHead``: 3x3 conv -> 256 -> relu -> 3x3 conv -> 2.
- ``BasicUpdateBlock``: motion encoder + GRU + flow head + convex-upsampling
  mask head (3x3 conv 256 -> relu -> 1x1 conv 576) scaled by 0.25.
- the small model's: ``SmallMotionEncoder`` (corr -> 1x1 conv 96; flow ->
  7x7 conv 64 -> 3x3 conv 32; concat -> 3x3 conv 80; concat raw flow =>
  82), ``ConvGRU`` (one 3x3 gated pass) and ``SmallUpdateBlock`` (GRU input
  context 64 + motion 82, flow head 128 wide, no mask head: the small model
  upsamples bilinearly).

All tensors are NCHW. Module names follow the reference torch RAFT.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flow_supervisor_tpu_torch.models.layers import conv2d


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = conv2d(cin, hidden_dim, 3)
        self.convr = conv2d(cin, hidden_dim, 3)
        self.convq = conv2d(cin, hidden_dim, 3)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return SepConvGRU._step(h, x, self.convz, self.convr, self.convq)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz1 = conv2d(cin, hidden_dim, (1, 5))
        self.convr1 = conv2d(cin, hidden_dim, (1, 5))
        self.convq1 = conv2d(cin, hidden_dim, (1, 5))
        self.convz2 = conv2d(cin, hidden_dim, (5, 1))
        self.convr2 = conv2d(cin, hidden_dim, (5, 1))
        self.convq2 = conv2d(cin, hidden_dim, (5, 1))

    @staticmethod
    def _step(h, x, convz, convr, convq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = self._step(h, x, self.convz1, self.convr1, self.convq1)
        return self._step(h, x, self.convz2, self.convr2, self.convq2)


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = conv2d(input_dim, hidden_dim, 3)
        self.conv2 = conv2d(hidden_dim, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = conv2d(cor_planes, 256, 1)
        self.convc2 = conv2d(256, 192, 3)
        self.convf1 = conv2d(2, 128, 7)
        self.convf2 = conv2d(128, 64, 3)
        self.conv = conv2d(64 + 192, 128 - 2, 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 3):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = conv2d(cor_planes, 96, 1)
        self.convf1 = conv2d(2, 64, 7)
        self.convf2 = conv2d(64, 32, 3)
        self.conv = conv2d(96 + 32, 80, 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


def mask_head() -> nn.Sequential:
    """The convex-upsampling mask head: 3x3 conv 256 -> relu -> 1x1 conv 576."""
    return nn.Sequential(
        conv2d(128, 256, 3),
        nn.ReLU(inplace=True),
        conv2d(256, 8 * 8 * 9, 1),  # 9 neighbours x 8x8 sub-pixels
    )


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4, corr_radius: int = 4,
                 convex_upsampling: bool = True):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = mask_head() if convex_upsampling else None

    def forward(self, net, inp, corr, flow):
        """-> (net, convex-upsampling mask logits or None without the mask
        head, delta_flow), all NCHW."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta_flow = self.flow_head(net)
        return net, None if self.mask is None else 0.25 * self.mask(net), delta_flow


class SmallUpdateBlock(nn.Module):
    def __init__(self, hidden_dim: int = 96, corr_levels: int = 4, corr_radius: int = 3):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_levels, corr_radius)
        self.gru = ConvGRU(hidden_dim, 82 + 64)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow):
        """-> (net, None: no mask head, delta_flow), all NCHW."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)
