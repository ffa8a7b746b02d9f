"""Window lookup from the 5-D correlation volume pyramid: kernel K11,
counterpart of flow_supervisor_tpu/kernels/corr_lookup.py
(``lookup_level_pallas`` / ``corr_pyramid_lookup_pallas``), a drop-in
replacement for ``ops.corr.corr_pyramid_lookup_gather`` on the volumes of
``ops.corr.build_corr_pyramid_from_fmaps``.

For each query of a level's volume [B, h1, w1, h2, w2] (fp32 or bf16) and
its coords (x, y) at the level's scale, the (2r+1)^2 bilinear window, taps
outside the plane reading 0, in fp32, channels dx-major: [B, h1, w1,
(2r+1)^2]. The pyramid lookup is one launch for all levels at coords /
2^level, levels concatenated: [B, h1, w1, L * (2r+1)^2] (csrc/corr_lookup.cu,
replaces ``_lookup_kernel``; the body is csrc/window.cuh's, shared with K1
and K10, which read the same [BQ, h2, w2] layout). No VJP, as in JAX.

The plain version is the TPU kernel's padded-window bilinear: each plane
zero-padded by 2r+2 in fp32, the window base floor(c) - r + pad clamped into
the padded plane, the (2r+2)^2 support gathered and combined. The wrapper
takes it only for CPU tensors; for CUDA tensors it launches the kernel or
raises. ``launches`` counts kernel launches. No model path of either package
calls these functions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from flow_supervisor_tpu_torch.kernels import _build
from flow_supervisor_tpu_torch.kernels.corr_plane import MAX_LEVELS, level_arrays, window_fits

launches = 0


def lookup_level_plain(vol: torch.Tensor, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """vol [B, h1, w1, h2, w2], coords [B, h1, w1, 2] at the level's scale ->
    [B, h1, w1, (2r+1)^2] fp32."""
    b, h1, w1, h2, w2 = vol.shape
    k = 2 * radius + 1
    pad = k + 1
    bq = b * h1 * w1
    vp = F.pad(vol.reshape(bq, h2, w2).float(), (pad, pad, pad, pad))
    hp, wp = h2 + 2 * pad, w2 + 2 * pad
    xy = coords.reshape(bq, 2).float()
    fl = torch.floor(xy)
    frac = xy - fl
    # clamped in float, so that far-out coords cannot overflow the integer
    base_y = torch.clamp(fl[:, 1] - radius + pad, 0, hp - (k + 1)).long()
    base_x = torch.clamp(fl[:, 0] - radius + pad, 0, wp - (k + 1)).long()
    ar = torch.arange(k + 1, device=vol.device)
    idx = (base_y[:, None] + ar)[:, :, None] * wp + (base_x[:, None] + ar)[:, None, :]
    patch = torch.gather(vp.reshape(bq, hp * wp), 1, idx.reshape(bq, -1)).reshape(bq, k + 1, k + 1)
    fy = frac[:, 1][:, None, None]
    fx = frac[:, 0][:, None, None]
    out = (
        (1.0 - fy) * (1.0 - fx) * patch[:, :k, :k]
        + (1.0 - fy) * fx * patch[:, :k, 1:]
        + fy * (1.0 - fx) * patch[:, 1:, :k]
        + fy * fx * patch[:, 1:, 1:]
    )  # [BQ, dy, dx]
    return out.transpose(1, 2).reshape(b, h1, w1, k * k)


def _check_args(pyramid, coords, radius):
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"corr_lookup: 1..{MAX_LEVELS} levels, got {len(pyramid)}")
    for vol in pyramid:
        if vol.dim() != 5 or not vol.is_contiguous() or vol.numel() == 0 \
                or vol.shape[:3] != pyramid[0].shape[:3] or vol.dtype != pyramid[0].dtype:
            raise ValueError(
                f"corr_lookup: volumes must be non-empty contiguous [B, h1, w1, h2, w2] of one "
                f"dtype and query grid, got {vol.dtype} {tuple(vol.shape)}"
            )
        _build.dtype_code(vol)
    if tuple(coords.shape) != (*pyramid[0].shape[:3], 2):
        raise ValueError(
            f"corr_lookup: coords must be [{', '.join(map(str, pyramid[0].shape[:3]))}, 2], got "
            f"{tuple(coords.shape)}"
        )
    if radius < 0:
        raise ValueError(f"corr_lookup: radius must be >= 0, got {radius}")
    if not window_fits(len(pyramid), radius):
        raise ValueError(f"corr_lookup: radius {radius} at {len(pyramid)} levels needs more "
                         f"shared memory than a block has")


def _launch(pyramid, coords, radius):
    """K11 on every level of the pyramid at coords [B, h1, w1, 2] (x, y) at
    level 0 -> [B, h1, w1, L * (2r+1)^2] fp32."""
    global launches
    b, h1, w1 = coords.shape[:3]
    flat = coords.reshape(-1, 2).float().contiguous()
    bq, nl = flat.shape[0], len(pyramid)
    out = torch.empty((bq, nl * (2 * radius + 1) ** 2), dtype=torch.float32, device=flat.device)
    with torch.cuda.device(flat.device):
        rc = _build.lib().fst_corr_lookup(
            *level_arrays(pyramid), nl, flat.data_ptr(), out.data_ptr(), bq, radius,
            _build.dtype_code(pyramid[0]), _build.stream_of(flat),
        )
    _build.check(rc, "corr_lookup")
    launches += 1
    return out.reshape(b, h1, w1, -1)


def lookup_level_pallas(vol: torch.Tensor, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """K11 on one level: vol [B, h1, w1, h2, w2], coords [B, h1, w1, 2] (x, y)
    at the level's scale -> [B, h1, w1, (2r+1)^2] fp32."""
    _check_args([vol], coords, radius)
    if not _build.uses_kernel("corr_lookup", vol, coords):
        return lookup_level_plain(vol, coords, radius)
    return _launch([vol], coords, radius)


def corr_pyramid_lookup_pallas(
    pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """K11 on all levels at coords / 2^level in one launch, levels
    concatenated: [B, h1, w1, L * (2r+1)^2] fp32."""
    _check_args(pyramid, coords, radius)
    if not _build.uses_kernel("corr_lookup", coords, *pyramid):
        return torch.cat([lookup_level_plain(vol, coords / (2.0 ** i), radius)
                          for i, vol in enumerate(pyramid)], dim=-1)
    return _launch(pyramid, coords, radius)
