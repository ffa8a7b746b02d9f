"""Window lookup from the 5-D correlation volume pyramid: kernel K11,
counterpart of flow_supervisor_tpu/kernels/corr_lookup.py
(``lookup_level_pallas`` / ``corr_pyramid_lookup_pallas``), a drop-in
replacement for ``ops.corr.corr_pyramid_lookup_gather`` on the volumes of
``ops.corr.build_corr_pyramid_from_fmaps``.

For each query of a level's volume [B, h1, w1, h2, w2] (fp32 or bf16) and
its coords (x, y) at the level's scale, the (2r+1)^2 bilinear window, taps
outside the plane reading 0, in fp32, channels dx-major: [B, h1, w1,
(2r+1)^2]. The pyramid lookup runs one launch per level at coords / 2^level
and writes each level's stripe of [B, h1, w1, L * (2r+1)^2]
(csrc/corr_lookup.cu, replaces ``_lookup_kernel``). No VJP, as in JAX.

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


def _check_args(vol, coords, radius):
    if vol.dim() != 5 or not vol.is_contiguous() or vol.numel() == 0:
        raise ValueError(
            f"corr_lookup: volume must be a non-empty contiguous [B, h1, w1, h2, w2], got "
            f"{tuple(vol.shape)}"
        )
    _build.dtype_code(vol)
    if tuple(coords.shape) != (*vol.shape[:3], 2):
        raise ValueError(
            f"corr_lookup: coords must be [{', '.join(map(str, vol.shape[:3]))}, 2], got "
            f"{tuple(coords.shape)}"
        )
    if radius < 0:
        raise ValueError(f"corr_lookup: radius must be >= 0, got {radius}")


def _launch(vol, flat, level, radius, out, col):
    """K11 on one level: flat coords [BQ, 2] fp32 at level 0, scaled by
    2^-level in the kernel; fp32 output rows of ``out`` [BQ, n] from column col."""
    global launches
    bq, n = out.shape
    with torch.cuda.device(vol.device):
        rc = _build.lib().fst_corr_lookup_level(
            vol.data_ptr(), vol.shape[3], vol.shape[4], flat.data_ptr(), level,
            out[:, col:].data_ptr(), n, bq, radius, _build.dtype_code(vol),
            _build.stream_of(vol),
        )
    _build.check(rc, "corr_lookup")
    launches += 1


def lookup_level_pallas(vol: torch.Tensor, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """K11 on one level: vol [B, h1, w1, h2, w2], coords [B, h1, w1, 2] (x, y)
    at the level's scale -> [B, h1, w1, (2r+1)^2] fp32."""
    _check_args(vol, coords, radius)
    if not _build.uses_kernel("corr_lookup", vol, coords):
        return lookup_level_plain(vol, coords, radius)
    b, h1, w1 = vol.shape[:3]
    k2 = (2 * radius + 1) ** 2
    out = torch.empty((b * h1 * w1, k2), dtype=torch.float32, device=vol.device)
    _launch(vol, coords.reshape(-1, 2).float().contiguous(), 0, radius, out, 0)
    return out.reshape(b, h1, w1, k2)


def corr_pyramid_lookup_pallas(
    pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """K11 per level at coords / 2^level, levels concatenated:
    [B, h1, w1, L * (2r+1)^2] fp32."""
    for vol in pyramid:
        _check_args(vol, coords, radius)
    if not _build.uses_kernel("corr_lookup", coords, *pyramid):
        return torch.cat([lookup_level_plain(vol, coords / (2.0 ** i), radius)
                          for i, vol in enumerate(pyramid)], dim=-1)
    b, h1, w1 = coords.shape[:3]
    k2 = (2 * radius + 1) ** 2
    flat = coords.reshape(-1, 2).float().contiguous()
    out = torch.empty((b * h1 * w1, len(pyramid) * k2), dtype=torch.float32, device=coords.device)
    for lvl, vol in enumerate(pyramid):
        _launch(vol, flat, lvl, radius, out, lvl * k2)
    return out.reshape(b, h1, w1, -1)
