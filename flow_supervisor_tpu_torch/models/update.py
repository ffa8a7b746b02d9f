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

Without gradient (``torch.is_grad_enabled()`` False: inference, the
Evaluator, the semi step's teacher passes run without gradient, the space
shards) the blocks take the fused path: every conv runs without its bias,
and one hand kernel (kernels/update_epilogue.py) applies its bias,
activation or GRU gating and writes the result at a channel offset of the
buffer that the next conv reads, so the block concatenates nothing. The
buffers (``FusedBuffers``) live for one forward: the GRU's input
``hx`` = [h | inp | motion (| GMA's motion_global)] NHWC, the channels in
the order of the concatenations they replace (the weights are used as they
are), holds inp from the first call on; the hidden state is a tensor of its
own, which the blocks update in place from the second call on. Under
gradient the blocks run the plain op chain below, op for op (the kernel has
no backward).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flow_supervisor_tpu_torch.kernels import update_epilogue as epilogue
from flow_supervisor_tpu_torch.models.layers import Conv2d, conv2d, nchw, nhwc


def _act(conv: Conv2d, x: torch.Tensor, out: torch.Tensor | None = None, relu: bool = True,
         scale: float = 1.0) -> torch.Tensor:
    """conv(x) (x NCHW) with its bias, relu or none and scale applied by the
    epilogue, into ``out`` (NHWC; default the conv's own output) -> out."""
    return epilogue.bias_act(nhwc(conv.raw(x)), conv.bias, out, relu, scale)


def _gru_pass(h: torch.Tensor, hx: torch.Tensor, state: torch.Tensor, convz: Conv2d,
              convr: Conv2d, convq: Conv2d) -> torch.Tensor:
    """One gated pass over hx = [h | x] (NHWC) whose h slot holds h (NHWC):
    r * h into the slot for convq, then h' into ``state`` and the slot -> state."""
    x = nchw(hx)
    z, r = nhwc(convz.raw(x)), nhwc(convr.raw(x))
    slot = hx[..., :z.shape[3]]
    epilogue.gru_gate(z, r, convz.bias, convr.bias, h, slot)
    return epilogue.gru_update(nhwc(convq.raw(x)), convq.bias, z, h, state, slot)


def _motion_fused(enc: nn.Module, corr_convs: tuple, flow: torch.Tensor, corr: torch.Tensor,
                  cf: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """A motion encoder without gradient: the relu'd correlation features
    (``corr_convs`` in turn) and flow features into cf = [cor | flo] (NHWC),
    the last conv into out[..., :C] and the flow after them (out NHWC, the
    width of the concatenation [out | flow]) -> out."""
    cor = corr
    for conv in corr_convs[:-1]:
        cor = nchw(_act(conv, cor))
    c = corr_convs[-1].out_channels
    _act(corr_convs[-1], cor, cf[..., :c])
    _act(enc.convf2, nchw(_act(enc.convf1, flow)), cf[..., c:])
    c = enc.conv.out_channels
    _act(enc.conv, nchw(cf), out[..., :c])
    out[..., c:].copy_(nhwc(flow))
    return out


class FusedBuffers:
    """One forward's buffers of an update block's fused path (module
    docstring): hx [B, h, w, hidden + x_channels] = [h | inp | motion ...],
    the hidden state [B, h, w, hidden], the motion encoder's cf [B, h, w,
    cf_channels] and, where a consumer needs the motion features contiguous
    (GMA's aggregation), ``motion`` [B, h, w, 128]; all NHWC in net's dtype.
    ``load`` fills hx's h and inp slots when the block is handed another net
    or inp than the ones they hold."""

    def __init__(self, net: torch.Tensor, x_channels: int, cf_channels: int,
                 motion: bool = False):
        b, hidden, h, w = net.shape

        def new(c):
            return torch.empty((b, h, w, c), dtype=net.dtype, device=net.device)

        self.hx, self.state, self.cf = new(hidden + x_channels), new(hidden), new(cf_channels)
        self.motion = new(128) if motion else None
        self.net_out = nchw(self.state)  # the block's net: the state, NCHW
        self.net = self.inp = None  # what hx's h and inp slots hold

    def load(self, net: torch.Tensor, inp: torch.Tensor) -> None:
        hidden, ci = self.state.shape[3], inp.shape[1]
        if net is not self.net:
            self.hx[..., :hidden].copy_(nhwc(net))
            self.net = net
        if inp is not self.inp:
            self.hx[..., hidden:hidden + ci].copy_(nhwc(inp))
            self.inp = inp

    def gru(self, gru: nn.Module, net: torch.Tensor) -> torch.Tensor:
        """The GRU's passes over hx from net (its first pass reads net, every
        later one the state) -> the state, NCHW; hx's h slot holds it after."""
        h = nhwc(net)
        for convs in gru.passes():
            h = _gru_pass(h, self.hx, self.state, *convs)
        self.net = self.net_out
        return self.net_out


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = conv2d(cin, hidden_dim, 3)
        self.convr = conv2d(cin, hidden_dim, 3)
        self.convq = conv2d(cin, hidden_dim, 3)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return SepConvGRU._step(h, x, self.convz, self.convr, self.convq)

    def passes(self) -> tuple:
        return ((self.convz, self.convr, self.convq),)


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

    def passes(self) -> tuple:
        """The (convz, convr, convq) of each pass, in order."""
        return ((self.convz1, self.convr1, self.convq1), (self.convz2, self.convr2, self.convq2))


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = conv2d(input_dim, hidden_dim, 3)
        self.conv2 = conv2d(hidden_dim, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))

    def fused(self, x: torch.Tensor) -> torch.Tensor:
        """The forward without gradient, through the epilogue -> NCHW."""
        return nchw(_act(self.conv2, nchw(_act(self.conv1, x)), relu=False))


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

    def fused(self, flow, corr, cf, out):
        """The forward without gradient into out (NHWC, 128 channels) through
        cf [B, h, w, 256] (``_motion_fused``) -> out."""
        return _motion_fused(self, (self.convc1, self.convc2), flow, corr, cf, out)


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

    def fused(self, flow, corr, cf, out):
        """The forward without gradient into out (NHWC, 82 channels) through
        cf [B, h, w, 128] (``_motion_fused``) -> out."""
        return _motion_fused(self, (self.convc1,), flow, corr, cf, out)


def mask_head() -> nn.Sequential:
    """The convex-upsampling mask head: 3x3 conv 256 -> relu -> 1x1 conv 576."""
    return nn.Sequential(
        conv2d(128, 256, 3),
        nn.ReLU(inplace=True),
        conv2d(256, 8 * 8 * 9, 1),  # 9 neighbours x 8x8 sub-pixels
    )


def mask_fused(mask: nn.Sequential, net: torch.Tensor) -> torch.Tensor:
    """0.25 * mask(net) without gradient, through the epilogue -> NCHW."""
    return nchw(_act(mask[2], nchw(_act(mask[0], net)), relu=False, scale=0.25))


def fused_block(block: nn.Module, net, inp, corr, flow, buf: FusedBuffers | None,
                attention=None):
    """An update block's forward without gradient (module docstring), in
    ``buf`` (``block.buffers(net, inp)``; None: new ones for this call) ->
    (net, mask logits or None, delta_flow), NCHW. ``attention``: GMA's map;
    its block's motion features land in ``buf.motion`` (to_v's 1x1 conv reads
    them contiguous), are copied into their slot of hx, and the aggregation
    writes its sum into the next slot."""
    buf = block.buffers(net, inp) if buf is None else buf
    buf.load(net, inp)
    c0 = net.shape[1] + inp.shape[1]
    if attention is None:
        block.encoder.fused(flow, corr, buf.cf, buf.hx[..., c0:])
    else:
        motion = block.encoder.fused(flow, corr, buf.cf, buf.motion)
        buf.hx[..., c0:c0 + motion.shape[3]].copy_(motion)
        block.aggregator(attention, nchw(motion), out=nchw(buf.hx[..., c0 + motion.shape[3]:]))
    net = buf.gru(block.gru, net)
    epilogue.fused_passes += 1
    mask = getattr(block, "mask", None)
    return net, None if mask is None else mask_fused(mask, net), block.flow_head.fused(net)


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4, corr_radius: int = 4,
                 convex_upsampling: bool = True):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = mask_head() if convex_upsampling else None

    def buffers(self, net: torch.Tensor, inp: torch.Tensor) -> FusedBuffers:
        """The fused path's buffers for one forward from (net, inp)."""
        return FusedBuffers(net, inp.shape[1] + 128, 256)

    def forward(self, net, inp, corr, flow, buffers: FusedBuffers | None = None):
        """-> (net, convex-upsampling mask logits or None without the mask
        head, delta_flow), all NCHW. Without gradient: the fused path
        (``fused_block``), in ``buffers`` (``self.buffers(net, inp)``, kept
        across a forward's calls; default new ones for this call)."""
        if not torch.is_grad_enabled():
            return fused_block(self, net, inp, corr, flow, buffers)
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

    def buffers(self, net: torch.Tensor, inp: torch.Tensor) -> FusedBuffers:
        """The fused path's buffers for one forward from (net, inp)."""
        return FusedBuffers(net, inp.shape[1] + 82, 128)

    def forward(self, net, inp, corr, flow, buffers: FusedBuffers | None = None):
        """-> (net, None: no mask head, delta_flow), all NCHW; without
        gradient the fused path, as ``BasicUpdateBlock``'s."""
        if not torch.is_grad_enabled():
            return fused_block(self, net, inp, corr, flow, buffers)
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)
