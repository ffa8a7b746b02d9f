"""RAFT inference forward (counterpart of flow_supervisor_tpu/models/raft.py).

Images in [0, 1] are normalized to [-1, 1]; fnet runs over the concatenated
pair; the correlation pyramid is built once; cnet gives (net = tanh,
inp = relu); then ``iters`` refinement steps of {pyramid lookup -> update
block -> delta flow}, with coords updated in fp32; the final flow is
convex-upsampled x8.

Three model families, as in the JAX package's ``RAFT.setup``:

- RAFT (default): ``BasicEncoder``s (fnet instance norm, cnet batch norm),
  ``BasicUpdateBlock``, hidden and context 128;
- GMA (``gma=True``): the same encoders, ``Attention`` over cnet's relu'd
  context once per forward (``attention_map``; heads and the three
  similarity modes from the config) and ``GMAUpdateBlock``, whose
  ``Aggregate`` reads that map in every iteration (models/gma.py);
- small (``small=True``, which wins over ``gma`` as in JAX):
  ``SmallEncoder``s (fnet instance norm, output 128; cnet no norm, output
  160), ``SmallUpdateBlock``, hidden 96 and context 64, 4 levels at radius 3
  and no mask head, so every flow is upsampled bilinearly x8 with its
  vectors scaled (``convex_upsampling=False`` gives the other two families
  the same upsampling).

``RAFTConfig.lookup_backend`` picks the pyramid and its lookup, as in the JAX
package (channels dx-major in every backend):

- ``"plane"`` (default): per-level planes [B*h8*w8, h2, w2] in
  ``corr_dtype``, looked up by K1 (kernels/corr_plane.py), differentiable
  in the planes through K12;
- ``"fused"``: volume-free, the pyramid is f1 and the pooled f2 in ``dtype``;
  K6 (all levels, B == 1) or K7 (per level, B > 1) compute each query's
  support correlations at every lookup (kernels/corr_fused.py);
- ``"pallas"``: the same planes as ``"plane"``; K10 looks up every level's
  window in one launch, fp32 out as in JAX, cast to ``dtype``
  (kernels/corr_lookup_v2.py); its backward is K12 too;
- ``"einsum"``: the volume pyramid [B, h8, w8, h2, w2] in ``corr_dtype``,
  looked up by one-hot matrix products in plain PyTorch (ops/corr.py
  ``corr_pyramid_lookup``);
- ``"zero"``: the lookup ablation, zeros in place of the windows (the
  einsum pyramid is still built, as in JAX);
- ``"auto"``: resolved from the images' device at each forward
  (``resolve_lookup_backend``): fused on the card, einsum elsewhere.

Public layout follows the JAX package: images [B, H, W, 3], flows
[B, H, W, 2], coords (x, y). Parameters are held in ``param_dtype``: by
default ``cfg.dtype``, cast once at construction (the JAX package keeps fp32
parameters and casts them to its compute dtype at every apply; for inference
one cast gives the same rounding). Training builds the model with fp32
masters (``training/loop.build_model``); every conv then casts them to
``cfg.dtype`` at each call (models/layers.py), so the gradient of each of the
update block's uses (iterations, directions) comes back in fp32 and autograd
sums them in fp32.

Training (the flow supervisor, counterpart of ``semi_forward``): with
``teacher=True`` the model owns a second update block, the teacher head;
``semi_forward`` runs the student on the crop and the teacher, continuing
from the student's final state zero-padded into the full frame, over a
pyramid, context and state that carry no gradient (computed under
``torch.no_grad``, where JAX has ``stop_gradient``). Every lookup backend
trains. ``update_ckpt`` rematerializes each refinement iteration, as JAX's
``nn.remat`` of the update block: every call of the update block or the
teacher head that records a graph runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps only
its inputs and runs it again in the backward (the blocks have no batch norm
and no dropout, so the second run gives the same values). ``freeze_bn`` keeps
cnet's batch norm on its running statistics in training mode too; without
it, training mode normalizes by batch statistics and updates the running
ones, as flax does (models/layers.py ``BatchNorm2d``). ``train_forward``
(Baseline) and ``unsup_forward`` (Unsup) are the forwards with gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from flow_supervisor_tpu_torch.kernels.corr_fused import (
    build_fused_pyramid,
    corr_pyramid_lookup_fused,
)
from flow_supervisor_tpu_torch.kernels.corr_lookup_v2 import corr_pyramid_lookup_v2
from flow_supervisor_tpu_torch.kernels.corr_plane import (
    build_plane_pyramid,
    corr_pyramid_lookup_plane,
)
from flow_supervisor_tpu_torch.models.encoders import BasicEncoder, SmallEncoder
from flow_supervisor_tpu_torch.models.gma import Attention, GMAUpdateBlock
from flow_supervisor_tpu_torch.models.layers import init_weights_, nchw, nhwc
from flow_supervisor_tpu_torch.models.update import BasicUpdateBlock, SmallUpdateBlock
from flow_supervisor_tpu_torch.ops.coords import coords_grid, downsample_shape, resize_flow
from flow_supervisor_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps, corr_pyramid_lookup
from flow_supervisor_tpu_torch.ops.pad import crop_bboxes, pad_bboxes
from flow_supervisor_tpu_torch.ops.upsample import upsample_convex


def _crop_upsample(flow_low, mask, crop_yx8, hw8, out_size):
    """Convex-upsample only each sample's (h8, w8) window at crop_yx8 of a
    full-frame low-res field: equal to cropping the full-frame upsample (each
    output pixel reads one mask cell and its 3x3 neighbourhood), with the 1-px
    halo taken from the zero-padded full field."""
    h8, w8 = hw8
    xp = torch.nn.functional.pad(flow_low, (0, 0, 1, 1, 1, 1))
    halo = crop_bboxes(xp, crop_yx8, (h8 + 2, w8 + 2))
    mask_c = crop_bboxes(mask, crop_yx8, (h8, w8))
    return upsample_convex(halo, mask_c, out_size, pre_padded=True)


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """The fields of the JAX RAFTConfig that the port uses."""

    iters: int = 12
    corr_levels: int = 4
    corr_radius: int = 4
    dtype: torch.dtype = torch.float32  # compute dtype (bfloat16 for speed)
    corr_dtype: torch.dtype = torch.float32  # correlation plane storage dtype
    lookup_backend: str = "plane"  # one of LOOKUP_BACKENDS (module docstring)
    convex_upsampling: bool = True  # False: bilinear x8 (the small model's)
    small: bool = False  # SmallEncoder / SmallUpdateBlock, radius 3, bilinear upsampling
    gma: bool = False  # GMA: the attention map and GMAUpdateBlock (ignored when small)
    num_heads: int = 1  # GMA's attention heads
    position_only: bool = False  # GMA: the relative-position term alone
    position_and_content: bool = False  # GMA: the content term plus the position term
    teacher: bool = False  # add the flow-supervisor teacher update block
    teacher_iters: int = 12
    update_ckpt: bool = False  # remat each refinement iteration (update block, teacher head)
    freeze_bn: bool = False  # batch norm on running statistics in training too

    @property
    def hidden_dim(self) -> int:
        return 96 if self.small else 128

    @property
    def context_dim(self) -> int:
        return 64 if self.small else 128

    def resolved(self) -> "RAFTConfig":
        """The correlation levels and radius (and the small model's bilinear
        upsampling) as JAX's ``RAFTConfig.resolved`` fixes them, whatever
        the fields hold: 4 levels, radius 4, or radius 3 for the small model.
        The lookup backend stays as it is (``resolve_lookup_backend``)."""
        if self.small:
            return dataclasses.replace(self, corr_levels=4, corr_radius=3,
                                       convex_upsampling=False)
        return dataclasses.replace(self, corr_levels=4, corr_radius=4)


LOOKUP_BACKENDS = ("plane", "fused", "pallas", "einsum", "zero", "auto")


def resolve_lookup_backend(backend: str, device) -> str:
    """The lookup backend that runs for images on ``device``: ``"auto"`` is
    ``"fused"`` on a CUDA device and ``"einsum"`` elsewhere; any other name
    is itself.

    The JAX package's rule (``RAFTConfig.resolved``) takes fused on a TPU
    and einsum elsewhere, so on a GPU it would take einsum. The port's rule
    takes fused there: on the H100 it needs less device time than the plane
    lookup (7.97 against 9.01 ms per 448x1024 forward at B=1, 41.6 against
    47.8 at B=8) and holds no volume (2.25 GB less at B=8; PERF.md)."""
    if backend != "auto":
        return backend
    return "fused" if torch.device(device).type == "cuda" else "einsum"


class RAFT(nn.Module):
    def __init__(
        self, cfg: RAFTConfig = RAFTConfig(), generator: Optional[torch.Generator] = None,
        param_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if cfg.lookup_backend not in LOOKUP_BACKENDS:
            raise ValueError(
                f"RAFTConfig(lookup_backend={cfg.lookup_backend!r}): one of {LOOKUP_BACKENDS}"
            )
        if cfg.small:  # 4 levels at radius 3, no mask head: bilinear upsampling
            cfg = cfg.resolved()
        self.cfg = cfg
        hdim, cdim = cfg.hidden_dim, cfg.context_dim
        self.gma = cfg.gma and not cfg.small
        if cfg.small:
            self.fnet = SmallEncoder(128, "instance")
            self.cnet = SmallEncoder(hdim + cdim, "none")
        else:
            self.fnet = BasicEncoder(256, "instance")
            self.cnet = BasicEncoder(hdim + cdim, "batch")
        if self.gma:
            self.att = Attention(cdim, cfg.num_heads, cdim, 160, cfg.position_only,
                                 cfg.position_and_content)

        def block():
            if cfg.small:
                return SmallUpdateBlock(hdim, cfg.corr_levels, cfg.corr_radius)
            if self.gma:
                return GMAUpdateBlock(hdim, cfg.corr_levels, cfg.corr_radius, cfg.num_heads,
                                      cfg.convex_upsampling)
            return BasicUpdateBlock(hdim, cfg.corr_levels, cfg.corr_radius, cfg.convex_upsampling)

        init_weights_(self.fnet, "extractor", generator)
        init_weights_(self.cnet, "extractor", generator)
        self.update_block = block()
        init_weights_(self.update_block, "update", generator)
        if self.gma:
            init_weights_(self.att, "update", generator)
            if hasattr(self.att, "pos_emb"):  # flax's normal(1.0) tables
                for table in (self.att.pos_emb.rel_height, self.att.pos_emb.rel_width):
                    with torch.no_grad():
                        table.weight.normal_(generator=generator)
        if cfg.teacher:
            self.teacher_update_block = block()
            init_weights_(self.teacher_update_block, "update", generator)
        self.to(dtype=param_dtype or cfg.dtype, memory_format=torch.channels_last)
        self.eval()

    def train(self, mode: bool = True):
        """Training mode; with ``cfg.freeze_bn`` batch norm stays on its
        running statistics (reference: frozen for every stage but chairs)."""
        super().train(mode)
        if mode and self.cfg.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

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

    def build_corr(self, fmap1: torch.Tensor, fmap2: torch.Tensor):
        """"fused": the factors (f1, pooled f2 per level) in cfg.dtype;
        "plane" / "pallas": per-level planes [B*h8*w8, h2, w2] in cfg.corr_dtype;
        "einsum" / "zero": per-level volumes [B, h8, w8, h2, w2] in cfg.corr_dtype."""
        cfg = self.cfg
        backend = resolve_lookup_backend(cfg.lookup_backend, fmap1.device)
        fmap1, fmap2 = fmap1.to(cfg.dtype), fmap2.to(cfg.dtype)
        if backend == "fused":
            return build_fused_pyramid(fmap1, fmap2, cfg.corr_levels)
        if backend in ("einsum", "zero"):
            return build_corr_pyramid_from_fmaps(fmap1, fmap2, cfg.corr_levels, cfg.corr_dtype)
        return build_plane_pyramid(fmap1, fmap2, cfg.corr_levels, cfg.corr_dtype)

    def lookup(self, pyramid, coords1: torch.Tensor) -> torch.Tensor:
        """Window channels [B, h8, w8, L * (2r+1)^2] in cfg.dtype at coords1."""
        cfg = self.cfg
        backend = resolve_lookup_backend(cfg.lookup_backend, coords1.device)
        if backend == "fused":
            return corr_pyramid_lookup_fused(pyramid, coords1, cfg.corr_radius, cfg.dtype)
        if backend == "pallas":
            return corr_pyramid_lookup_v2(pyramid, coords1, cfg.corr_radius).to(cfg.dtype)
        if backend == "einsum":
            return corr_pyramid_lookup(pyramid, coords1, cfg.corr_radius).to(cfg.dtype)
        if backend == "zero":
            k2 = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
            zeros = torch.zeros((*coords1.shape[:3], k2), device=coords1.device)
            return (zeros + torch.sum(coords1) * 0.0).to(cfg.dtype)
        return corr_pyramid_lookup_plane(pyramid, coords1, cfg.corr_radius, cfg.dtype)

    def attention_map(self, inp: torch.Tensor) -> Optional[torch.Tensor]:
        """GMA's attention map [B, heads, N, N] over the relu'd context ``inp``
        (NCHW), in cfg.dtype, computed once per forward; None for the other
        models."""
        return self.att(inp) if self.gma else None

    def iterate(
        self, net, inp, pyramid, coords0, coords1, out_size, iters: int,
        final_flow_only: bool = False, teacher: bool = False, crop=None, attention=None,
    ):
        """Run ``iters`` refinement steps -> (net, coords1, flows_up, flows_low).

        flows_up: [iters, B, H, W, 2] (length 1 with ``final_flow_only``: only
        the last iteration is upsampled); flows_low: [iters, B, h8, w8, 2].
        coords are detached at the top of every iteration (JAX's
        ``stop_gradient``). ``teacher``: refine with the teacher head.
        ``crop``: ``(crop_yx8, (h8, w8), (h, w))``, upsample only each
        sample's crop window, at crop resolution (``_crop_upsample``; the
        bilinear upsample of a model without the mask head upsamples the
        full frame and crops it, as JAX does). ``attention``: GMA's map
        (``attention_map``), passed to every step of its update block."""
        cfg = self.cfg
        block = self.teacher_update_block if teacher else self.update_block
        b, h8, w8 = coords1.shape[:3]
        mask = (torch.zeros((b, h8, w8, 576), dtype=cfg.dtype, device=coords1.device)
                if cfg.convex_upsampling else None)
        extra = (attention,) if self.gma else ()
        if cfg.update_ckpt and torch.is_grad_enabled():
            plain_block = block

            def block(*args):  # JAX's nn.remat(block)
                return torch.utils.checkpoint.checkpoint(plain_block, *args, use_reentrant=False)

        def upsample(flow_low, mask):
            if mask is None:  # bilinear x8 with scaling (no mask head)
                up = resize_flow(flow_low, out_size, scaling=True)
                return up if crop is None else crop_bboxes(up, crop[0] * 8, crop[2])
            if crop is not None:
                return _crop_upsample(flow_low, mask.float(), *crop) * 8.0
            return upsample_convex(flow_low, mask.float(), out_size) * 8.0

        ups, lows = [], []
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = self.lookup(pyramid, coords1)
            flow = (coords1 - coords0).to(cfg.dtype)
            net, up_mask, delta = block(net, inp, nchw(corr), nchw(flow), *extra)
            coords1 = coords1 + nhwc(delta).float()
            flow_low = coords1 - coords0
            lows.append(flow_low)
            mask = None if up_mask is None else nhwc(up_mask)
            if not final_flow_only:
                ups.append(upsample(flow_low, mask))
        if final_flow_only:
            ups = [upsample(coords1 - coords0, mask)]
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
        1/8). Returns {"flow_up": [n, B, H, W, 2], "flow_low": [iters, B, h8, w8, 2]}.
        Inference: no gradient (``train_forward`` is the same forward with one)."""
        return self._flow(image1, image2, flow_init, iters, final_flow_only)

    def train_forward(self, image1: torch.Tensor, image2: torch.Tensor) -> dict[str, torch.Tensor]:
        """The standard forward with gradient, every iteration upsampled (the
        Baseline step's forward; JAX's ``__call__(train=True)``)."""
        return self._flow(image1, image2)

    def _flow(self, image1, image2, flow_init=None, iters=None, final_flow_only=False):
        iters = self.cfg.iters if iters is None else iters
        b, h, w, _ = image1.shape
        fmap1, fmap2 = self.features(image1, image2)
        pyramid = self.build_corr(fmap1, fmap2)
        net, inp = self.context(image1)
        h8, w8 = downsample_shape(h), downsample_shape(w)
        coords0 = coords_grid(b, h8, w8, device=image1.device)
        coords1 = coords0
        if flow_init is not None:
            coords1 = coords1 + resize_flow(flow_init.float(), (h8, w8), scaling=True)
        _, _, flows_up, flows_low = self.iterate(
            net, inp, pyramid, coords0, coords1, (h, w), iters, final_flow_only,
            attention=self.attention_map(inp),
        )
        return {"flow_up": flows_up, "flow_low": flows_low}

    # ---- flow-supervisor forward (counterpart of RAFT.semi_forward) --------

    def teacher_iterate(self, net, inp, pyramid, coords0, coords1, out_size, iters: int,
                        final_flow_only: bool = False, attention=None):
        """Continue refinement with the teacher head."""
        return self.iterate(net, inp, pyramid, coords0, coords1, out_size, iters,
                            final_flow_only, teacher=True, attention=attention)

    def _directional(
        self, image1, pyramid, teacher_pyramid, teacher_image1, crop_yx8,
        teacher_final_only: bool, teacher_grad: bool,
    ):
        """One direction: the student on the crop, then the teacher from the
        student's final hidden state and flow zero-padded into the full frame,
        with the teacher context from the full image; the teacher's
        predictions come back in the crop's frame. GMA: the student's
        attention map comes from its crop's context, the teacher's from the
        full frame's, without gradient."""
        cfg = self.cfg
        b, h, w, _ = image1.shape
        fh, fw = teacher_image1.shape[1], teacher_image1.shape[2]
        h8, w8 = downsample_shape(h), downsample_shape(w)
        fh8, fw8 = downsample_shape(fh), downsample_shape(fw)

        net, inp = self.context(image1)
        coords0 = coords_grid(b, h8, w8, device=image1.device)
        net, _, stu_up, stu_low = self.iterate(
            net, inp, pyramid, coords0, coords0, (h, w), cfg.iters,
            attention=self.attention_map(inp),
        )
        t_net = pad_bboxes(nhwc(net.detach()), crop_yx8, (fh8, fw8))
        t_flow = pad_bboxes(stu_low[-1].detach(), crop_yx8, (fh8, fw8))
        with torch.no_grad():
            _, t_inp = self.context(teacher_image1)
            t_attention = self.attention_map(t_inp)
        t_coords0 = coords_grid(b, fh8, fw8, device=image1.device)
        with torch.set_grad_enabled(teacher_grad and torch.is_grad_enabled()):
            _, _, tea_up, tea_low = self.iterate(
                nchw(t_net), t_inp, teacher_pyramid, t_coords0, t_coords0 + t_flow, (fh, fw),
                cfg.teacher_iters, final_flow_only=teacher_final_only, teacher=True,
                crop=(crop_yx8, (h8, w8), (h, w)), attention=t_attention,
            )
        return stu_up, stu_low, tea_up, tea_low

    def semi_forward(
        self, image1, image2, orig_image1, orig_image2, crop_yx,
        use_bw: bool = True, teacher_final_only: bool = False, teacher_grad: bool = True,
    ) -> dict[str, torch.Tensor]:
        """Teacher-student forward of the flow supervisor.

        image1/2: [B, h, w, 3] crops of orig_image1/2 [B, H, W, 3] at crop_yx
        [B, 2] int (y, x), multiples of 8. Returns student_fw/bw [iters, B, h,
        w, 2], teacher_fw/bw [teacher_iters (1 with ``teacher_final_only``),
        B, h, w, 2] in the crop's frame, and the low-res flows
        student_low_* [iters, B, h8, w8, 2], teacher_low_* [teacher_iters, B,
        H8, W8, 2] (full frame). The teacher's pyramid, context and starting
        state carry no gradient; ``teacher_grad=False`` runs the teacher head
        without gradient too, for callers that use its predictions only as a
        target."""
        if not self.cfg.teacher:
            raise ValueError("semi_forward needs RAFTConfig(teacher=True)")
        fmap1, fmap2 = self.features(image1, image2)
        pyramid = self.build_corr(fmap1, fmap2)
        with torch.no_grad():
            tf1, tf2 = self.features(orig_image1, orig_image2)
            t_pyramid = self.build_corr(tf1, tf2)
        crop_yx8 = crop_yx.long() // 8
        stu_fw, stu_low_fw, tea_fw, tea_low_fw = self._directional(
            image1, pyramid, t_pyramid, orig_image1, crop_yx8, teacher_final_only, teacher_grad
        )
        out = {"student_fw": stu_fw, "student_low_fw": stu_low_fw,
               "teacher_fw": tea_fw, "teacher_low_fw": tea_low_fw}
        if use_bw:
            bw_pyramid = self.build_corr(fmap2, fmap1)
            with torch.no_grad():
                t_bw_pyramid = self.build_corr(tf2, tf1)
            stu_bw, stu_low_bw, tea_bw, tea_low_bw = self._directional(
                image2, bw_pyramid, t_bw_pyramid, orig_image2, crop_yx8, teacher_final_only,
                teacher_grad,
            )
            out.update(student_bw=stu_bw, student_low_bw=stu_low_bw,
                       teacher_bw=tea_bw, teacher_low_bw=tea_low_bw)
        return out

    # ---- unsupervised forward (counterpart of RAFT.unsup_forward) ----------

    def unsup_forward(self, image1, image2,
                      final_flow_only: bool = False) -> dict[str, torch.Tensor]:
        """Both directions of the standard forward, with gradient: flow_up /
        flow_low, and flow_up_bw / flow_low_bw from the backward pyramid (the
        fmap arguments swapped) and image2's context. ``final_flow_only``:
        upsample only the last iteration (for callers that read only it)."""
        b, h, w, _ = image1.shape
        h8, w8 = downsample_shape(h), downsample_shape(w)
        fmap1, fmap2 = self.features(image1, image2)
        pyramid = self.build_corr(fmap1, fmap2)
        net, inp = self.context(image1)
        coords0 = coords_grid(b, h8, w8, device=image1.device)
        _, _, fw_up, fw_low = self.iterate(
            net, inp, pyramid, coords0, coords0, (h, w), self.cfg.iters, final_flow_only,
            attention=self.attention_map(inp))
        bw_pyramid = self.build_corr(fmap2, fmap1)
        net2, inp2 = self.context(image2)
        _, _, bw_up, bw_low = self.iterate(
            net2, inp2, bw_pyramid, coords0, coords0, (h, w), self.cfg.iters, final_flow_only,
            attention=self.attention_map(inp2))
        return {"flow_up": fw_up, "flow_low": fw_low, "flow_up_bw": bw_up, "flow_low_bw": bw_low}
