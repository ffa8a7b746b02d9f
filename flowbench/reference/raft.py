"""Plain PyTorch reference of RAFT (Teed & Deng, ECCV 2020) and GMA (Jiang et
al., ICCV 2021) inference, and of the flow supervisor's evaluation split
(Im et al., ECCV 2022): the student, then the teacher head from the
student's final state.

It reads a state dict by the reference torch RAFT's module names (``fnet``,
``cnet``, ``update_block``, ``teacher_update_block``, ``att``) and imports
nothing of the program under test. Everything runs in float32 with plain
operations: convs by ``F.conv2d``, the correlation pyramid as the all-pairs
volume of f1 against f2 average-pooled by 2^l (TF 'SAME', count-aware, as the
flow supervisor's JAX code pools), each lookup a 4-tap bilinear gather of a
(2r+1)^2 window, out-of-map taps reading 0, channels dx-major.

``quant`` rounds the operands of every conv and matrix product (identity by
default); the benchmark's control passes ``precision.fp8`` to put the
reference in a lower precision than the configuration states.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

EPS = 1e-5


def same_pool(fmap: torch.Tensor, k: int) -> torch.Tensor:
    """NHWC fmap average-pooled by k (kernel = stride = k), TF 'SAME' padding,
    each window divided by its taps inside the map."""
    if k == 1:
        return fmap
    b, h, w, c = fmap.shape

    def pads(n):
        total = max(-(-n // k) * k - n, 0)
        return total // 2, total - total // 2

    (pt, pb), (pl, pr) = pads(h), pads(w)
    x = F.pad(fmap.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    ones = F.pad(torch.ones((1, 1, h, w), device=fmap.device), (pl, pr, pt, pb))
    summed = F.avg_pool2d(x, k, k, divisor_override=1)
    counts = F.avg_pool2d(ones, k, k, divisor_override=1)
    return (summed / counts).permute(0, 2, 3, 1)


def grid(b: int, h: int, w: int, device) -> torch.Tensor:
    """[b, h, w, 2] pixel coordinates, (x, y)."""
    y, x = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                          indexing="ij")
    return torch.stack([x, y], -1).float()[None].expand(b, h, w, 2)


def lookup(vols: list[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """vols[l] [B, Q, h2, w2]; coords [B, h, w, 2] at level 0 -> windows
    [B, h, w, L * (2r+1)^2], level-major, dx-major within a level."""
    b, h, w, _ = coords.shape
    k = 2 * radius + 1
    d = torch.arange(k, device=coords.device, dtype=torch.float32) - radius
    dx, dy = torch.meshgrid(d, d, indexing="ij")  # dx-major
    dx, dy = dx.reshape(-1), dy.reshape(-1)
    outs = []
    for lvl, vol in enumerate(vols):
        h2, w2 = vol.shape[2], vol.shape[3]
        c = coords.reshape(b, h * w, 1, 2) / 2.0 ** lvl
        x, y = c[..., 0] + dx, c[..., 1] + dy
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        flat = vol.reshape(b, h * w, h2 * w2)
        acc = 0.0
        for ox, oy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                            (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
            xi, yi = x0 + ox, y0 + oy
            inside = (xi >= 0) & (xi <= w2 - 1) & (yi >= 0) & (yi <= h2 - 1)
            idx = (yi.clamp(0, h2 - 1) * w2 + xi.clamp(0, w2 - 1)).long()
            acc = acc + torch.gather(flat, 2, idx) * torch.where(inside, wgt, 0.0)
        outs.append(acc)
    return torch.cat(outs, -1).reshape(b, h, w, -1)


def upsample_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x8 convex upsampling: flow [B, h, w, 2] (1/8 px), mask logits
    [B, h, w, 576] (neighbour-major: n * 64 + sub_row * 8 + sub_col) ->
    [B, 8h, 8w, 2] in full-resolution px."""
    b, h, w, c = flow.shape
    m = torch.softmax(mask.reshape(b, h, w, 9, 64), dim=3)
    xp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    nb = torch.stack([xp[:, i : i + h, j : j + w] for i in range(3) for j in range(3)], 3)
    up = torch.einsum("bhwns,bhwnc->bhwsc", m, nb)
    return up.reshape(b, h, w, 8, 8, c).permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, c)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class Raft:
    """The reference forward over a state dict ``p`` of float32 tensors.

    ``gma``: GMA's attention over the context once a forward and its
    aggregation in every iteration (heads of 128 channels, the content
    similarity). ``quant``: the rounding of conv and matmul operands."""

    def __init__(self, p: dict, gma: bool = False, heads: int = 1, radius: int = 4,
                 levels: int = 4, quant: Optional[Callable] = None):
        self.p, self.gma, self.heads = p, gma, heads
        self.radius, self.levels = radius, levels
        self.q = quant or (lambda t: t)

    # ---- layers -------------------------------------------------------------

    def conv(self, x, name, stride=1):
        wgt = self.p[name + ".weight"]
        kh, kw = wgt.shape[2], wgt.shape[3]
        return F.conv2d(self.q(x), self.q(wgt), self.p.get(name + ".bias"), stride,
                        (kh // 2, kw // 2))

    def norm(self, x, name, kind):
        if kind == "instance":
            var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
            return (x - mean) * torch.rsqrt(var + EPS)
        return F.batch_norm(x, self.p[name + ".running_mean"], self.p[name + ".running_var"],
                            self.p[name + ".weight"], self.p[name + ".bias"], False, 0.0, EPS)

    def block(self, x, name, stride, kind):
        y = F.relu(self.norm(self.conv(x, name + ".conv1", stride), name + ".norm1", kind))
        y = F.relu(self.norm(self.conv(y, name + ".conv2"), name + ".norm2", kind))
        if stride != 1:
            x = self.norm(self.conv(x, name + ".downsample.0", stride), name + ".downsample.1",
                          kind)
        return F.relu(x + y)

    def encoder(self, img, name, kind):
        """NHWC images in [0, 1] -> NCHW features at 1/8 resolution."""
        x = nchw(2.0 * img - 1.0)
        x = F.relu(self.norm(self.conv(x, name + ".conv1", 2), name + ".norm1", kind))
        for i, stride in ((1, 1), (2, 2), (3, 2)):
            x = self.block(x, f"{name}.layer{i}.0", stride, kind)
            x = self.block(x, f"{name}.layer{i}.1", 1, kind)
        return self.conv(x, name + ".conv2")

    # ---- the model ----------------------------------------------------------

    def features(self, img1, img2):
        f = nhwc(self.encoder(torch.cat([img1, img2]), "fnet", "instance"))
        return f.chunk(2)

    def pyramid(self, f1, f2):
        """[B, Q, h2, w2] volumes per level: f1 . pool(f2)^T / sqrt(C)."""
        b, h, w, c = f1.shape
        rows = f1.reshape(b, h * w, c)
        vols = []
        for lvl in range(self.levels):
            f2l = same_pool(f2, 2 ** lvl)
            cols = f2l.reshape(b, -1, c)
            vol = torch.matmul(self.q(rows), self.q(cols).transpose(1, 2)) / math.sqrt(c)
            vols.append(vol.reshape(b, h * w, f2l.shape[1], f2l.shape[2]))
        return vols

    def context(self, img):
        out = self.encoder(img, "cnet", "batch")
        net, inp = out.split([128, 128], dim=1)
        return torch.tanh(net), torch.relu(inp)

    def attention(self, inp):
        """GMA's map [B, heads, N, N] over the context (NCHW)."""
        if not self.gma:
            return None
        b, _, h, w = inp.shape
        qk = nhwc(self.conv(inp, "att.to_qk")).reshape(b, h * w, 2, self.heads, -1)
        q = qk[:, :, 0].transpose(1, 2) * qk.shape[-1] ** -0.5
        k = qk[:, :, 1].transpose(1, 2)
        return torch.softmax(torch.matmul(self.q(q), self.q(k).transpose(-1, -2)), dim=-1)

    def aggregate(self, attn, motion, name):
        b, _, h, w = motion.shape
        v = nhwc(self.conv(motion, name + ".to_v")).reshape(b, h * w, self.heads, -1)
        out = torch.matmul(self.q(attn), self.q(v.transpose(1, 2)))  # [B, heads, N, d]
        out = nchw(out.transpose(1, 2).reshape(b, h, w, -1))
        if name + ".project.weight" in self.p:
            out = self.conv(out, name + ".project")
        return motion + self.p[name + ".gamma"] * out

    def update(self, name, net, inp, corr, flow, attn):
        """One refinement step -> (net, mask logits NHWC, delta flow NHWC)."""
        e = name + ".encoder"
        cor = F.relu(self.conv(F.relu(self.conv(nchw(corr), e + ".convc1")), e + ".convc2"))
        flo = F.relu(self.conv(F.relu(self.conv(nchw(flow), e + ".convf1")), e + ".convf2"))
        motion = torch.cat([F.relu(self.conv(torch.cat([cor, flo], 1), e + ".conv")),
                            nchw(flow)], 1)
        x = [inp, motion]
        if self.gma:
            x.append(self.aggregate(attn, motion, name + ".aggregator"))
        x = torch.cat(x, 1)
        g = name + ".gru"
        for z, r, q in (("convz1", "convr1", "convq1"), ("convz2", "convr2", "convq2")):
            hx = torch.cat([net, x], 1)
            zt = torch.sigmoid(self.conv(hx, f"{g}.{z}"))
            rt = torch.sigmoid(self.conv(hx, f"{g}.{r}"))
            qt = torch.tanh(self.conv(torch.cat([rt * net, x], 1), f"{g}.{q}"))
            net = (1.0 - zt) * net + zt * qt
        delta = self.conv(F.relu(self.conv(net, name + ".flow_head.conv1")),
                          name + ".flow_head.conv2")
        mask = 0.25 * self.conv(F.relu(self.conv(net, name + ".mask.0")), name + ".mask.2")
        return net, nhwc(mask), nhwc(delta)

    def iterate(self, name, net, inp, vols, coords0, coords1, iters, attn, every=False):
        """``iters`` steps of block ``name`` -> (net, low flows, upsampled
        flows: every iteration's with ``every``, else the last one's)."""
        lows, ups = [], []
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = lookup(vols, coords1, self.radius)
            net, mask, delta = self.update(name, net, inp, corr, coords1 - coords0, attn)
            coords1 = coords1 + delta
            lows.append(coords1 - coords0)
            if every:
                ups.append(upsample_convex(lows[-1], mask))
        if not every:
            ups.append(upsample_convex(lows[-1], mask))
        return net, lows, ups

    @torch.no_grad()
    def forward(self, img1, img2, iters, flow_init=None, with_low=False):
        """img1/2 [B, H, W, 3] in [0, 1] (H, W multiples of 8) -> final flow
        [B, H, W, 2] (and with ``with_low`` the final low flow [B, H/8, W/8,
        2]); flow_init [B, H/8, W/8, 2] starts the refinement."""
        f1, f2 = self.features(img1, img2)
        vols = self.pyramid(f1, f2)
        net, inp = self.context(img1)
        b, h, w, _ = f1.shape
        coords0 = grid(b, h, w, img1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        _, lows, ups = self.iterate("update_block", net, inp, vols, coords0, coords1, iters,
                                    self.attention(inp))
        return (ups[-1], lows[-1]) if with_low else ups[-1]

    @torch.no_grad()
    def teacher_split(self, img1, img2, iters, teacher_iters, flow_init=None):
        """The evaluation of a model with a teacher head: the student for
        ``iters`` from flow_init, then the teacher head for ``teacher_iters``
        from the student's final hidden state and flow, one pyramid, context
        and attention map for both -> (student flow, teacher flow, the
        student's final low flow)."""
        f1, f2 = self.features(img1, img2)
        vols = self.pyramid(f1, f2)
        net, inp = self.context(img1)
        attn = self.attention(inp)
        b, h, w, _ = f1.shape
        coords0 = grid(b, h, w, img1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        net, lows, ups = self.iterate("update_block", net, inp, vols, coords0, coords1, iters,
                                      attn)
        _, _, t_ups = self.iterate("teacher_update_block", net, inp, vols, coords0,
                                   coords0 + lows[-1], teacher_iters, attn)
        return ups[-1], t_ups[-1], lows[-1]


def pad_sintel(img: torch.Tensor, multiple: int = 8):
    """Replicate-edge pad NHWC to a multiple of ``multiple``, centred ->
    (padded, ((top, bottom), (left, right)))."""
    h, w = img.shape[1], img.shape[2]
    ph, pw = (-h) % multiple, (-w) % multiple
    spec = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
    (t, b_), (l, r) = spec
    out = F.pad(img.permute(0, 3, 1, 2), (l, r, t, b_), mode="replicate").permute(0, 2, 3, 1)
    return out, spec


def unpad(x: torch.Tensor, spec) -> torch.Tensor:
    (t, b), (l, r) = spec
    return x[:, t : x.shape[1] - b, l : x.shape[2] - r]
