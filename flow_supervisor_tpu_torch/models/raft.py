"""RAFT inference forward (counterpart of flow_supervisor_tpu/models/raft.py,
``lookup_backend="plane"``).

Images in [0, 1] are normalized to [-1, 1]; fnet runs over the concatenated
pair; the correlation pyramid is materialized once as per-level planes;
cnet gives (net = tanh, inp = relu); then ``iters`` refinement steps of
{plane lookup (K1) -> update block -> delta flow}, with coords updated in
fp32; the final flow is convex-upsampled x8.

Public layout follows the JAX package: images [B, H, W, 3], flows
[B, H, W, 2], coords (x, y). Parameters are held in ``cfg.dtype`` (the JAX
package keeps fp32 parameters and casts them to its compute dtype at every
apply; holding them cast gives the same rounding once).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from flow_supervisor_tpu_torch.kernels.corr_plane import (
    build_plane_pyramid,
    corr_pyramid_lookup_plane,
)
from flow_supervisor_tpu_torch.models.encoders import BasicEncoder
from flow_supervisor_tpu_torch.models.layers import init_weights_, nchw, nhwc
from flow_supervisor_tpu_torch.models.update import BasicUpdateBlock
from flow_supervisor_tpu_torch.ops.coords import coords_grid, downsample_shape, resize_flow
from flow_supervisor_tpu_torch.ops.upsample import upsample_convex


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """The fields of the JAX RAFTConfig that the ported slice uses."""

    iters: int = 12
    corr_levels: int = 4
    corr_radius: int = 4
    dtype: torch.dtype = torch.float32  # compute dtype (bfloat16 for speed)
    corr_dtype: torch.dtype = torch.float32  # correlation plane storage dtype
    convex_upsampling: bool = True  # False (bilinear) comes with the small model
    small: bool = False
    gma: bool = False
    teacher: bool = False

    hidden_dim = 128
    context_dim = 128


_NOT_PORTED = {
    "small": "the small model (ROADMAP Queue 1, item 6: SmallEncoder / SmallUpdateBlock)",
    "gma": "GMA (ROADMAP Queue 1, item 5)",
    "teacher": "the flow-supervisor teacher head (ROADMAP Queue 1, item 7)",
}
# bilinear (non-convex) upsampling comes with the small model, which needs it
_NOT_PORTED_OFF = {"convex_upsampling": _NOT_PORTED["small"]}


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig(), generator: Optional[torch.Generator] = None):
        super().__init__()
        for field, what in _NOT_PORTED.items():
            if getattr(cfg, field):
                raise NotImplementedError(f"RAFTConfig({field}=True): {what} is not ported yet")
        for field, what in _NOT_PORTED_OFF.items():
            if not getattr(cfg, field):
                raise NotImplementedError(f"RAFTConfig({field}=False): {what} is not ported yet")
        self.cfg = cfg
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch")
        self.update_block = BasicUpdateBlock(cfg.hidden_dim, cfg.corr_levels, cfg.corr_radius)
        init_weights_(self.fnet, "extractor", generator)
        init_weights_(self.cnet, "extractor", generator)
        init_weights_(self.update_block, "update", generator)
        self.to(dtype=cfg.dtype, memory_format=torch.channels_last)
        self.eval()

    # ---- components -------------------------------------------------------

    def _images(self, image: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] -> normalized NCHW (channels_last) in cfg.dtype."""
        return nchw(2.0 * image.to(self.cfg.dtype) - 1.0)

    def features(self, image1: torch.Tensor, image2: torch.Tensor):
        """fnet over the concatenated pair -> (fmap1, fmap2) NHWC."""
        fmaps = nhwc(self.fnet(self._images(torch.cat([image1, image2], dim=0))))
        return torch.chunk(fmaps, 2, dim=0)

    def context(self, image1: torch.Tensor):
        """cnet -> (net = tanh(hidden), inp = relu(context)), NCHW."""
        out = self.cnet(self._images(image1))
        net, inp = torch.split(out, [self.cfg.hidden_dim, self.cfg.context_dim], dim=1)
        return torch.tanh(net), torch.relu(inp)

    def build_corr(self, fmap1: torch.Tensor, fmap2: torch.Tensor) -> list[torch.Tensor]:
        """Per-level correlation planes [B*h8*w8, h2, w2] in cfg.corr_dtype."""
        return build_plane_pyramid(
            fmap1.to(self.cfg.dtype), fmap2.to(self.cfg.dtype),
            self.cfg.corr_levels, self.cfg.corr_dtype,
        )

    def iterate(
        self, net, inp, planes, coords0, coords1, out_size, iters: int,
        final_flow_only: bool = False,
    ):
        """Run ``iters`` refinement steps -> (net, coords1, flows_up, flows_low).

        flows_up: [iters, B, H, W, 2] (length 1 with ``final_flow_only``: only
        the last iteration is upsampled); flows_low: [iters, B, h8, w8, 2]."""
        cfg = self.cfg
        b, h8, w8 = coords1.shape[:3]
        mask = torch.zeros((b, h8, w8, 576), dtype=cfg.dtype, device=coords1.device)
        ups, lows = [], []
        for _ in range(iters):
            corr = corr_pyramid_lookup_plane(planes, coords1, cfg.corr_radius, cfg.dtype)
            flow = (coords1 - coords0).to(cfg.dtype)
            net, up_mask, delta = self.update_block(net, inp, nchw(corr), nchw(flow))
            coords1 = coords1 + nhwc(delta).float()
            flow_low = coords1 - coords0
            lows.append(flow_low)
            mask = nhwc(up_mask)
            if not final_flow_only:
                ups.append(upsample_convex(flow_low, mask.float(), out_size) * 8.0)
        if final_flow_only:
            ups = [upsample_convex(coords1 - coords0, mask.float(), out_size) * 8.0]
        return net, coords1, torch.stack(ups), torch.stack(lows)

    # ---- standard forward -------------------------------------------------

    @torch.no_grad()
    def forward(
        self,
        image1: torch.Tensor,
        image2: torch.Tensor,
        flow_init: Optional[torch.Tensor] = None,
        iters: Optional[int] = None,
        final_flow_only: bool = False,
    ) -> dict[str, torch.Tensor]:
        """image1/2: [B, H, W, 3] in [0, 1]; flow_init: [B, h, w, 2] (resized to
        1/8). Returns {"flow_up": [n, B, H, W, 2], "flow_low": [iters, B, h8, w8, 2]}."""
        iters = self.cfg.iters if iters is None else iters
        b, h, w, _ = image1.shape
        fmap1, fmap2 = self.features(image1, image2)
        planes = self.build_corr(fmap1, fmap2)
        net, inp = self.context(image1)
        h8, w8 = downsample_shape(h), downsample_shape(w)
        coords0 = coords_grid(b, h8, w8, device=image1.device)
        coords1 = coords0
        if flow_init is not None:
            coords1 = coords1 + resize_flow(flow_init.float(), (h8, w8), scaling=True)
        _, _, flows_up, flows_low = self.iterate(
            net, inp, planes, coords0, coords1, (h, w), iters, final_flow_only
        )
        return {"flow_up": flows_up, "flow_low": flows_low}
