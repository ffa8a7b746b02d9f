"""Affine-free instance norm (+ optional relu) over NHWC activations: kernels
K3 (statistics) and K4 (apply), counterpart of flow_supervisor_tpu/kernels/norm.py.

- ``instance_norm_stats``: per-(b, c) fp32 sum and sum of squares over H*W ->
  stats [B, 2, C] = (mean, rsqrt(max(E[x^2] - mean^2, 0) + eps)), eps 1e-5
  (csrc/norm.cu, replaces ``_stats_kernel``).
- ``instance_norm_apply``: y = (x - mean) * r, optional relu, cast to x's dtype
  (csrc/norm.cu, replaces ``_apply_kernel``); it also finishes the
  conv3x3 + instance-norm pair (kernels/conv3x3.py).

Each wrapper takes its plain PyTorch version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. ``stats_launches`` /
``apply_launches`` count kernel launches.

``instance_norm`` is a ``torch.autograd.Function``: forward K3 + K4, backward
the closed-form ``norm_backward`` from the saved statistics (counterpart of
``instance_norm_fused`` and its ``_norm_bwd``).
"""
from __future__ import annotations

import torch

from flow_supervisor_tpu_torch.kernels import _build

EPS = 1e-5

stats_launches = 0
apply_launches = 0


def instance_norm_stats_plain(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """fp32 (mean, rsqrt(var + eps)) of x [B, H, W, C] -> [B, 2, C]."""
    b, h, w, c = x.shape
    x32 = x.float()
    m = float(h * w)
    mean = x32.sum(dim=(1, 2)) / m
    var = torch.clamp((x32 * x32).sum(dim=(1, 2)) / m - mean * mean, min=0.0)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def instance_norm_apply_plain(
    x: torch.Tensor, stats: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """(x - mean) * r (+ relu) in fp32, cast to x's dtype."""
    mean = stats[:, 0][:, None, None, :]
    r = stats[:, 1][:, None, None, :]
    y = (x.float() - mean) * r
    if relu:
        y = torch.clamp(y, min=0.0)
    return y.to(x.dtype)


def _check_stats(stats: torch.Tensor, x: torch.Tensor, what: str) -> None:
    b, _, _, c = x.shape
    if (
        stats.shape != (b, 2, c)
        or stats.dtype != torch.float32
        or not stats.is_contiguous()
    ):
        raise ValueError(
            f"{what}: stats must be contiguous float32 [{b}, 2, {c}], got "
            f"{stats.dtype} {tuple(stats.shape)}"
        )


def instance_norm_stats(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """K3: statistics of x [B, H, W, C] -> [B, 2, C] float32."""
    global stats_launches
    _build.check_nhwc(x, "instance_norm_stats")
    if not _build.uses_kernel("instance_norm_stats", x):
        return instance_norm_stats_plain(x, eps)
    b, h, w, c = x.shape
    lib = _build.lib()
    parts = lib.fst_instance_norm_chunks(h * w)
    partials = torch.empty((b, parts, 2, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.fst_instance_norm_stats(
            x.data_ptr(), partials.data_ptr(), stats.data_ptr(), b, h * w, c,
            _build.dtype_code(x), eps, _build.stream_of(x),
        )
    _build.check(rc, "instance_norm_stats")
    stats_launches += 1
    return stats


def instance_norm_apply(
    x: torch.Tensor, stats: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """K4: normalize x [B, H, W, C] by stats [B, 2, C] (+ relu), in x's dtype."""
    global apply_launches
    _build.check_nhwc(x, "instance_norm_apply")
    _check_stats(stats, x, "instance_norm_apply")
    if not _build.uses_kernel("instance_norm_apply", x, stats):
        return instance_norm_apply_plain(x, stats, relu)
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _build.lib().fst_instance_norm_apply(
            x.data_ptr(), stats.data_ptr(), y.data_ptr(), b, h * w, c,
            _build.dtype_code(x), int(relu), _build.stream_of(x),
        )
    _build.check(rc, "instance_norm_apply")
    apply_launches += 1
    return y


def norm_backward(
    x: torch.Tensor, stats: torch.Tensor, g: torch.Tensor, relu: bool
) -> torch.Tensor:
    """Closed-form VJP of (x - mean) * r (+ relu) with the statistics taken
    from x itself (``_norm_bwd`` of the JAX package), in fp32 from the saved
    statistics: dx = r * (g - mean(g) - yhat * mean(g * yhat)), in x's dtype."""
    mean = stats[:, 0][:, None, None, :]
    r = stats[:, 1][:, None, None, :]
    yhat = (x.float() - mean) * r
    g32 = g.float()
    if relu:
        g32 = torch.where(yhat > 0, g32, torch.zeros_like(g32))
    gm = g32.mean(dim=(1, 2), keepdim=True)
    gym = (g32 * yhat).mean(dim=(1, 2), keepdim=True)
    return (r * (g32 - gm - yhat * gym)).to(x.dtype)


class _InstanceNorm(torch.autograd.Function):
    """Forward K3 + K4; backward ``norm_backward`` in plain PyTorch (the JAX
    package's backward is XLA code, not a Pallas kernel)."""

    @staticmethod
    def forward(ctx, x, relu):
        stats = instance_norm_stats(x)
        ctx.relu = relu
        ctx.save_for_backward(x, stats)
        return instance_norm_apply(x, stats, relu)

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        return norm_backward(x, stats, g, ctx.relu), None


def instance_norm(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Instance norm (+ relu) of x [B, H, W, C]: K3 then K4, differentiable."""
    return _InstanceNorm.apply(x, relu)
