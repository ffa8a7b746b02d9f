"""Direct 3x3 stride-1 SAME conv + bias with an instance-norm statistics
epilogue: kernel K2, counterpart of flow_supervisor_tpu/kernels/conv3x3.py
``conv3x3_stats`` / ``conv3x3_instnorm_relu``; and the same conv alone with
an optional relu: kernel K5, counterpart of ``conv3x3_fused``.

``conv3x3_stats(x, w, b)`` takes x [B, H, W, C] (NHWC), w [3, 3, C, Cout]
(HWIO) and b [Cout], all in one dtype (fp32 or bf16), and returns
(y [B, H, W, Cout] in x's dtype, stats [B, 2, Cout] float32) where the stats
are (mean, rsqrt(var + 1e-5)) of the fp32 conv output taken before the cast,
as the TPU kernel takes them (csrc/conv3x3.cu, replaces ``_conv_stats_kernel``).
``conv3x3_instnorm_relu`` finishes the pair with K4 (kernels/norm.py); it is
a ``torch.autograd.Function`` whose backward is ``_cin_bwd``'s (below).

``conv3x3_fused(x, w, b, relu=False)`` (K5, csrc/conv3x3.cu, replaces
``_conv_kernel``): y = conv3x3(x, w) + b (+ relu) accumulated in fp32 and
written in x's dtype; a ``torch.autograd.Function`` whose backward is the
JAX package's ``_conv_bwd``: PyTorch's conv backward in x's dtype, the relu
mask taken from the conv recomputed in x's dtype (not from the fp32 forward),
the incoming cotangent cast to that dtype first. In the JAX package its own
function is the only caller; in the port the space-sharded encoders call
``conv3x3_bare`` for every pair K2 carries unsharded (models/encoders.py).

Each wrapper takes the plain PyTorch version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. The kernel has two bodies
(csrc/conv3x3.cu): bf16 convs of the shapes ``tensor_core_body`` accepts (every
conv of the model) run on the tensor cores, fp32 and other bf16 shapes on the
CUDA cores. ``launches`` (K2) and ``bare_launches`` (K5) count every kernel
launch, ``tc_launches`` those of K2 and K5 that ran the tensor-core body.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from flow_supervisor_tpu_torch.kernels import _build
from flow_supervisor_tpu_torch.kernels.norm import EPS, instance_norm_apply, norm_backward

launches = 0
bare_launches = 0
tc_launches = 0


def tensor_core_body(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a conv of x [B, H, W, C] by w [3, 3, C, Cout] runs the
    tensor-core body: bf16, C % 16 == 0 and C <= 128, Cout % 8 == 0 and
    Cout <= 128, x and w 16-byte aligned (csrc/conv3x3.cu ``tc_shape_ok``)."""
    c, cout = x.shape[3], w.shape[3]
    return (
        x.dtype == torch.bfloat16
        and c % 16 == 0 and 16 <= c <= 128
        and cout % 8 == 0 and 8 <= cout <= 128
        and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    )


def conv3x3_stats_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = EPS
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 conv (+bias) and the stats of its fp32 output; y cast to x's dtype."""
    _, h, wd, _ = x.shape
    y32 = F.conv2d(
        x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), b.float(),
        padding=1,
    )
    m = float(h * wd)
    mean = y32.sum(dim=(2, 3)) / m
    var = torch.clamp((y32 * y32).sum(dim=(2, 3)) / m - mean * mean, min=0.0)
    stats = torch.stack([mean, torch.rsqrt(var + eps)], dim=1)
    y = y32.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    return y, stats


def _check_args(x, w, b, what="conv3x3_stats"):
    _build.check_nhwc(x, what)
    c = x.shape[3]
    if w.dim() != 4 or w.shape[:3] != (3, 3, c) or not w.is_contiguous():
        raise ValueError(
            f"{what}: weight must be contiguous HWIO [3, 3, {c}, Cout], got {tuple(w.shape)}"
        )
    if b.shape != (w.shape[3],) or not b.is_contiguous():
        raise ValueError(f"{what}: bias must be [{w.shape[3]}], got {tuple(b.shape)}")
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(
            f"{what}: x, weight and bias must share a dtype, got {x.dtype}, {w.dtype}, {b.dtype}"
        )


def conv3x3_stats(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = EPS
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: (conv3x3(x, w) + b in x's dtype, fp32 stats [B, 2, Cout])."""
    global launches, tc_launches
    _check_args(x, w, b)
    if not _build.uses_kernel("conv3x3_stats", x, w, b):
        return conv3x3_stats_plain(x, w, b, eps)
    bsz, h, wd, c = x.shape
    cout = w.shape[3]
    lib = _build.lib()
    parts = lib.fst_conv3x3_partials(h, wd)
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    partials = torch.empty((bsz, parts, 2, cout), dtype=torch.float32, device=x.device)
    stats = torch.empty((bsz, 2, cout), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), partials.data_ptr(),
            stats.data_ptr(), bsz, h, wd, c, cout)
    tc = tensor_core_body(x, w)
    with torch.cuda.device(x.device):
        if tc:
            rc = lib.fst_conv3x3_tc_stats(*ptrs, eps, _build.stream_of(x))
        else:
            rc = lib.fst_conv3x3_stats(*ptrs, _build.dtype_code(x), eps, _build.stream_of(x))
    _build.check(rc, "conv3x3_stats")
    launches += 1
    tc_launches += tc
    return y, stats


class _Conv3x3InstNormRelu(torch.autograd.Function):
    """Forward K2 + K4; backward ``_cin_bwd`` of the JAX package: the
    closed-form norm VJP from the saved statistics, cast to y's dtype, then
    the conv's input, weight and bias gradients in that one dtype (PyTorch's
    convolution backward, where JAX used XLA's conv transpose)."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        y, stats = conv3x3_stats(x, w, b)
        ctx.relu = relu
        ctx.save_for_backward(x, w, y, stats)
        return instance_norm_apply(y, stats, relu)

    @staticmethod
    def backward(ctx, g):
        x, w, y, stats = ctx.saved_tensors
        dy = norm_backward(y, stats, g, ctx.relu)
        dx, dw, db = torch.ops.aten.convolution_backward(
            dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
            [w.shape[3]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            list(ctx.needs_input_grad[:3]),
        )
        return (
            None if dx is None else dx.permute(0, 2, 3, 1),
            None if dw is None else dw.permute(2, 3, 1, 0),
            db, None,
        )


def conv3x3_instnorm_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """conv3x3 (+bias) -> affine-free instance norm -> (relu), NHWC: K2 then
    K4, differentiable."""
    return _Conv3x3InstNormRelu.apply(x, w, b, relu)


def conv3x3_bare_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """fp32 conv + bias (+ relu), cast to x's dtype."""
    y32 = F.conv2d(
        x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), b.float(), padding=1
    )
    if relu:
        y32 = torch.relu(y32)
    return y32.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3_bare(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """K5: conv3x3(x, w) + b (+ relu) in x's dtype, NHWC / HWIO."""
    global bare_launches, tc_launches
    _check_args(x, w, b, "conv3x3_fused")
    if not _build.uses_kernel("conv3x3_fused", x, w, b):
        return conv3x3_bare_plain(x, w, b, relu)
    bsz, h, wd, c = x.shape
    cout = w.shape[3]
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h, wd, c, cout)
    tc = tensor_core_body(x, w)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        if tc:
            rc = lib.fst_conv3x3_tc(*ptrs, int(relu), _build.stream_of(x))
        else:
            rc = lib.fst_conv3x3(*ptrs, _build.dtype_code(x), int(relu), _build.stream_of(x))
    _build.check(rc, "conv3x3_fused")
    bare_launches += 1
    tc_launches += tc
    return y


class _Conv3x3Fused(torch.autograd.Function):
    """Forward K5; backward ``_conv_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        ctx.relu = relu
        ctx.save_for_backward(x, w, b)
        return conv3x3_bare(x, w, b, relu)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        dy = g.to(x.dtype).permute(0, 3, 1, 2)
        if ctx.relu:
            # the dtype-uniform conv's relu; jnp.maximum splits a tie at 0 in halves
            y = F.conv2d(xn, wn, padding=1) + b.view(1, -1, 1, 1)
            dy = dy * ((y > 0).to(dy.dtype) + 0.5 * (y == 0).to(dy.dtype))
        dx, dw, db = torch.ops.aten.convolution_backward(
            dy, xn, wn, [w.shape[3]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            list(ctx.needs_input_grad[:3]),
        )
        return (
            None if dx is None else dx.permute(0, 2, 3, 1),
            None if dw is None else dw.permute(2, 3, 1, 0),
            db, None,
        )


def conv3x3_fused(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """3x3 stride-1 SAME conv (+ bias, optional relu), NHWC x [B, H, W, C],
    HWIO w [3, 3, C, Cout], fp32 or bf16: K5 forward, differentiable."""
    return _Conv3x3Fused.apply(x, w, b, relu)
