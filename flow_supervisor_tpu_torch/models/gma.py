"""GMA, Global Motion Aggregation (counterpart of flow_supervisor_tpu/models/gma.py).

- ``RelPosEmb``: tables of 2 * max_pos_size - 1 rows of dim_head, gathered at
  i - j + max_pos_size - 1 for the rows and the columns; the score of query
  (x, y) and key (u, v) is q . height[x - u] + q . width[y - v].
- ``Attention``: 1x1 conv (no bias) -> q, k in ``heads`` heads of dim_head;
  q scaled by dim_head^-0.5; the similarity is the content term q . k
  (default), the position term alone (``position_only``) or their sum
  (``position_and_content``); softmax over the source pixels in fp32, the
  map in the dtype of the scores as JAX's type promotion gives it: the
  position term is q against JAX's fp32 tables, in fp32, so in a bf16 run
  the map is fp32 in the two position modes and bf16 in the content mode.
  Beyond the tables (h or w > max_pos_size) the port raises where JAX's
  gather clamps.
- ``Aggregate``: 1x1 conv (no bias) -> v; the attention-weighted sum of v
  (in the map's dtype when it is wider: an fp32 map weighs v promoted to
  fp32, as JAX's einsum does); a 1x1 projection (no bias, in fmap's
  dtype) where heads * dim_head != dim; the residual scaled by ``gamma``,
  a scalar that starts at zero.
- ``GMAUpdateBlock``: the GRU input is context 128 + motion 128 + the motion
  aggregated over the frame 128. Without gradient it takes the fused path of
  models/update.py: the motion features land in a contiguous buffer (to_v's
  1x1 conv reads them), are copied into their slot of the GRU's input, and
  the aggregation writes its sum into the next slot.

The attention map is computed once per forward from the relu'd context and
serves every refinement iteration. Its two products, q . k^T once and attn .
v in every iteration, are ``torch.matmul`` on [B, heads, N, d] (N = h8 * w8):
one map weighs twelve different v's, so no fused attention call fits.

Under a space shard (parallel/spatial.py) the queries stay the shard's
rows: ``Attention`` gathers k, the position term's height table takes the
shard's global rows against all rows, and ``Aggregate`` gathers v in every
iteration.

Module names follow the reference torch GMA (``att.to_qk``,
``att.pos_emb.rel_height``, ``update_block.aggregator.to_v``, ...). The
reference keeps its index table as a buffer (``rel_ind``); here the indices
are computed at each call, as in the JAX package, so the state dict holds
the two tables alone.

Activations are NCHW in ``torch.channels_last`` memory format.
"""
from __future__ import annotations

import torch
from torch import nn

from flow_supervisor_tpu_torch.models.layers import Conv2d, nchw, nhwc
from flow_supervisor_tpu_torch.parallel import spatial
from flow_supervisor_tpu_torch.parallel.spatial import first_row
from flow_supervisor_tpu_torch.tracing import span
from flow_supervisor_tpu_torch.models.update import (
    BasicMotionEncoder,
    FlowHead,
    FusedBuffers,
    SepConvGRU,
    fused_block,
    mask_head,
)


def _conv1x1(c_in: int, c_out: int) -> Conv2d:
    """A bias-free 1x1 conv; torch's default init draws U(+-1/sqrt(c_in)),
    the JAX package's VarianceScaling(1/3, fan_in, uniform)."""
    return Conv2d(c_in, c_out, 1, bias=False)


class RelPosEmb(nn.Module):
    def __init__(self, max_pos_size: int = 160, dim_head: int = 128):
        super().__init__()
        self.max_pos_size = max_pos_size
        self.rel_height = nn.Embedding(2 * max_pos_size - 1, dim_head)
        self.rel_width = nn.Embedding(2 * max_pos_size - 1, dim_head)

    def _table(self, emb: nn.Embedding, n: int, rows: int | None = None,
               row0: int = 0) -> torch.Tensor:
        """emb's rows at i - j + max_pos_size - 1 for the queries i in [row0,
        row0 + rows) (default all n) and the keys j in [0, n) -> [rows, n, dim_head]."""
        dev = emb.weight.device
        i = torch.arange(row0, row0 + (n if rows is None else rows), device=dev)
        j = torch.arange(n, device=dev)
        return emb.weight[i[:, None] - j[None, :] + self.max_pos_size - 1]

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        """q [B, heads, h, w, d] -> scores [B, heads, h, w, H, w] in fp32:
        JAX's tables are fp32 parameters (here they may be stored in the
        compute dtype), and its einsum promotes q to them. H is the frame's
        height: under a space shard q holds the shard's h rows, whose global
        indices (``spatial.first_row``) index the height table against all
        H rows; otherwise H = h."""
        h, w = q.shape[2], q.shape[3]
        full_h = h * spatial.space_world()
        if max(full_h, w) > self.max_pos_size:
            # JAX's gather clamps the out-of-range indices; the port refuses them
            raise ValueError(
                f"RelPosEmb: a {full_h}x{w} feature map exceeds max_pos_size "
                f"{self.max_pos_size} (the position tables cover offsets below it)"
            )
        q = q.float()
        rows = self._table(self.rel_height, full_h, h, first_row(h)).float()
        height = torch.einsum("bnxyd,xud->bnxyu", q, rows)
        width = torch.einsum("bnxyd,yvd->bnxyv", q, self._table(self.rel_width, w).float())
        return height[..., :, None] + width[..., None, :]


class Attention(nn.Module):
    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128,
                 max_pos_size: int = 160, position_only: bool = False,
                 position_and_content: bool = False):
        super().__init__()
        if heads < 1:
            raise ValueError(f"Attention(heads={heads}): at least one head")
        self.heads, self.dim_head = heads, dim_head
        self.position_only = position_only
        self.position_and_content = position_and_content
        self.to_qk = _conv1x1(dim, 2 * heads * dim_head)
        if position_only or position_and_content:  # tables N(0, 1), as flax's
            self.pos_emb = RelPosEmb(max_pos_size, dim_head)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        """fmap NCHW [B, dim, h, w] -> the attention map [B, heads, N, N] in
        the scores' dtype (module docstring), rows (queries) summing to 1
        over the source pixels. Under a space shard fmap holds the shard's
        rows, the map [B, heads, N / n, N] its queries against the whole
        frame's keys (gathered), the softmax over all N."""
        b, _, h, w = fmap.shape
        inner = self.heads * self.dim_head
        qk = nhwc(self.to_qk(fmap))  # [B, h, w, 2 * inner]

        def heads(t):  # [B, rows, w, inner] -> [B, heads, rows, w, d]
            return t.reshape(b, -1, w, self.heads, self.dim_head).permute(0, 3, 1, 2, 4)

        q = heads(qk[..., :inner]) * (self.dim_head ** -0.5)
        n_q = h * w
        n = n_q * spatial.space_world()  # the keys: every row of the frame
        if self.position_only:
            sim = self.pos_emb(q).reshape(b, self.heads, n_q, n)
        else:
            k = heads(spatial.gather_rows(qk[..., inner:].contiguous()))
            sim = torch.matmul(q.reshape(b, self.heads, n_q, self.dim_head),
                               k.reshape(b, self.heads, n, self.dim_head).transpose(-1, -2))
            if self.position_and_content:
                sim = sim + self.pos_emb(q).reshape(b, self.heads, n_q, n)
        return torch.softmax(sim.float(), dim=-1).to(sim.dtype)


class Aggregate(nn.Module):
    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_v = _conv1x1(dim, inner)
        self.project = _conv1x1(inner, dim) if inner != dim else None
        self.gamma = nn.Parameter(torch.zeros(1))

    @span("fst.aggregate")
    def forward(self, attn: torch.Tensor, fmap: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
        """attn [B, heads, N, N], fmap NCHW [B, dim, h, w] -> fmap + gamma *
        (the attention-weighted v, projected to dim), NCHW in fmap's dtype;
        written into ``out`` (NCHW, fmap's shape and dtype) where given."""
        b, _, h, w = fmap.shape
        inner = self.heads * self.dim_head
        # under a space shard: v of the whole frame, the map's rows this shard's queries
        v = spatial.gather_rows(nhwc(self.to_v(fmap)).contiguous())
        v = v.reshape(b, -1, self.heads, self.dim_head)
        dtype = torch.promote_types(attn.dtype, v.dtype)
        agg = torch.matmul(attn.to(dtype), v.transpose(1, 2).to(dtype))  # [B, heads, N, d]
        agg = nchw(agg.transpose(1, 2).reshape(b, h, w, inner))
        if self.project is not None:
            agg = self.project(agg.to(fmap.dtype))
        if out is not None:
            return torch.add(fmap, self.gamma * agg, out=out)
        return (fmap + self.gamma * agg).to(fmap.dtype)


class GMAUpdateBlock(nn.Module):
    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4, corr_radius: int = 4,
                 heads: int = 1, convex_upsampling: bool = True):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = mask_head() if convex_upsampling else None
        self.aggregator = Aggregate(128, heads, 128)

    def buffers(self, net: torch.Tensor, inp: torch.Tensor) -> FusedBuffers:
        """The fused path's buffers for one forward from (net, inp)."""
        return FusedBuffers(net, inp.shape[1] + 2 * 128, 256, motion=True)

    def forward(self, net, inp, corr, flow, attention, buffers: FusedBuffers | None = None):
        """-> (net, convex-upsampling mask logits or None, delta_flow), all
        NCHW; ``attention``: the forward's map from ``Attention``. Without
        gradient: the fused path, in ``buffers`` (as ``BasicUpdateBlock``'s)."""
        if not torch.is_grad_enabled():
            return fused_block(self, net, inp, corr, flow, buffers, attention)
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        delta_flow = self.flow_head(net)
        return net, None if self.mask is None else 0.25 * self.mask(net), delta_flow
