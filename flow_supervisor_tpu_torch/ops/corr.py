"""All-pairs correlation, pooled pyramid and the gather lookup oracle
(counterpart of flow_supervisor_tpu/ops/corr.py).

- ``all_pairs_correlation``: corr[b, i, j, k, l] = <f1[b,i,j], f2[b,k,l]> / sqrt(C),
  accumulated in fp32.
- ``build_corr_pyramid_from_fmaps``: level i correlates f1 with f2 average-pooled
  by 2^i (kernel = stride, TF 'SAME' padding, edge windows divide by their
  valid taps). Pooling commutes with the inner product, so this equals pooling
  the full volume.
- ``corr_pyramid_lookup_gather``: per level, a (2r+1)^2 bilinear window at
  coords / 2^level; out-of-bounds taps read 0; channels dx-major / dy-minor.
- ``corr_pyramid_lookup``: the same windows by the JAX package's gather-free
  formulation (the ``einsum`` lookup backend): per query, one-hot support
  matrices pick the (2r+2)^2 support patch by two batched matrix products,
  then the 4-tap bilinear combine.
- ``window_support`` / ``combine_support``: the same window from per-query
  planes in two plain steps, the (2r+2)^2 support patch and its 4-tap
  bilinear combine (the plain versions behind the plane, fused and pallas
  lookup kernels); ``support_cotangent`` is the combine's transpose (the
  plain version behind the fused lookup's backward kernels).
- ``lookup_vjp_dvols``: the cotangent of the window lookup with respect to
  the per-query planes (JAX's ``corr_fused.lookup_vjp_dvols``, the backward
  of the plane and pallas lookups): each query's support cotangent written
  at its support position in a zeroed plane row (the plain version of K12).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def all_pairs_correlation(
    fmap1: torch.Tensor, fmap2: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """[B, H1, W1, C] x [B, H2, W2, C] -> [B, H1, W1, H2, W2] = f1 . f2^T / sqrt(C).

    Inputs are upcast to fp32 before the product, so bf16 features multiply
    exactly and accumulate in fp32 (the JAX package's preferred_element_type)."""
    b, h1, w1, c = fmap1.shape
    _, h2, w2, c2 = fmap2.shape
    if c != c2:
        raise ValueError(f"channel mismatch: {tuple(fmap1.shape)} vs {tuple(fmap2.shape)}")
    a = fmap1.reshape(b, h1 * w1, c).float()
    bb = fmap2.reshape(b, h2 * w2, c).float()
    corr = torch.matmul(a, bb.transpose(1, 2)) / torch.sqrt(torch.tensor(float(c)))
    return corr.to(out_dtype).reshape(b, h1, w1, h2, w2)


def _same_pads(size: int, k: int) -> tuple[int, int]:
    """TF 'SAME' (before, after) padding for kernel = stride = k."""
    out = -(-size // k)
    total = max(out * k - size, 0)
    return total // 2, total - total // 2


def _avg_pool_fmap_same(fmap: torch.Tensor, k: int) -> torch.Tensor:
    """TF-'SAME' count-aware average pool over the spatial dims of an NHWC map."""
    b, h, w, c = fmap.shape
    (pt, pb), (pl, pr) = _same_pads(h, k), _same_pads(w, k)
    x = fmap.permute(0, 3, 1, 2).float()
    ones = torch.ones((1, 1, h, w), dtype=torch.float32, device=fmap.device)
    pads = (pl, pr, pt, pb)
    summed = F.avg_pool2d(F.pad(x, pads), k, k, divisor_override=1)
    counts = F.avg_pool2d(F.pad(ones, pads), k, k, divisor_override=1)
    return (summed / counts).permute(0, 2, 3, 1).to(fmap.dtype)


def build_corr_pyramid_from_fmaps(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4,
    out_dtype=torch.float32,
) -> list[torch.Tensor]:
    """Pyramid of volumes [B, h1, w1, h2_l, w2_l] via pooled feature maps."""
    pyramid = [all_pairs_correlation(fmap1, fmap2, out_dtype)]
    scale = 2
    for _ in range(num_levels - 1):
        pooled = _avg_pool_fmap_same(fmap2, scale)
        pyramid.append(all_pairs_correlation(fmap1, pooled, out_dtype))
        scale *= 2
    return pyramid


def _lookup_window_offsets(radius: int, device=None) -> torch.Tensor:
    """[(2r+1)^2, 2] (x, y) offsets, dx-major / dy-minor."""
    k = 2 * radius + 1
    d = torch.arange(k, device=device, dtype=torch.float32) - radius
    dx, dy = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx, dy], dim=-1).reshape(k * k, 2)


def _lookup_level(vol: torch.Tensor, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """vol [B, h1, w1, h2, w2]; coords [B, h1, w1, 2] at this level's scale."""
    b, h1, w1, h2, w2 = vol.shape
    k2 = (2 * radius + 1) ** 2
    flat = vol.reshape(b, h1 * w1, h2 * w2)
    delta = _lookup_window_offsets(radius, coords.device)
    q = coords.reshape(b, h1 * w1, 1, 2).float() + delta[None, None]
    x, y = q[..., 0], q[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0

    def tap(xi, yi, wgt):
        valid = (xi >= 0) & (xi <= w2 - 1) & (yi >= 0) & (yi <= h2 - 1)
        xi_c = torch.clamp(xi, 0, w2 - 1).long()
        yi_c = torch.clamp(yi, 0, h2 - 1).long()
        idx = (yi_c * w2 + xi_c).reshape(b, h1 * w1, k2)
        vals = torch.gather(flat, 2, idx).float()
        return vals * torch.where(valid, wgt, torch.zeros_like(wgt))

    out = (
        tap(x0, y0, (1.0 - dx) * (1.0 - dy))
        + tap(x0 + 1.0, y0, dx * (1.0 - dy))
        + tap(x0, y0 + 1.0, (1.0 - dx) * dy)
        + tap(x0 + 1.0, y0 + 1.0, dx * dy)
    )
    return out.reshape(b, h1, w1, k2)


def corr_pyramid_lookup_gather(
    pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """Gather-based lookup over volumes (correctness oracle): [B, h1, w1, L*(2r+1)^2]."""
    outs = [
        _lookup_level(vol, coords / (2.0 ** i), radius) for i, vol in enumerate(pyramid)
    ]
    return torch.cat(outs, dim=-1)


def _interp_matrix(pos: torch.Tensor, size: int, radius: int, dtype) -> torch.Tensor:
    """One-hot support matrix R [B, Q, 2r+2, size] of positions pos [B, Q]:
    R[..., u, c] = 1 iff c == floor(pos) + u - r. A support row outside
    [0, size) matches no column, which gives out-of-bounds taps their 0. The
    first support index is clamped to [-(2r+2), size] in float before the
    integer conversion, which changes no match and keeps far-out coords
    (up to 3e38) from overflowing."""
    sup = 2 * radius + 2
    base = torch.clamp(torch.floor(pos) - radius, -sup, size).long()
    s = base[..., None] + torch.arange(sup, device=pos.device)
    return (s[..., None] == torch.arange(size, device=pos.device)).to(dtype)


def _lookup_level_matmul(vol: torch.Tensor, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """vol [B, h1, w1, h2, w2]; coords [B, h1, w1, 2] at this level's scale ->
    [B, h1, w1, (2r+1)^2] fp32, channels dx-major. patch[q] = R_y[q] . vol[q]
    . R_x[q]^T: the first product takes the volume's dtype (each output is one
    volume value, so it is exact), the second runs in fp32."""
    b, h1, w1, h2, w2 = vol.shape
    k = 2 * radius + 1
    q = h1 * w1
    x = coords[..., 0].reshape(b, q).float()
    y = coords[..., 1].reshape(b, q).float()
    fx = (x - torch.floor(x))[..., None, None]
    fy = (y - torch.floor(y))[..., None, None]
    ry = _interp_matrix(y, h2, radius, vol.dtype)
    rx = _interp_matrix(x, w2, radius, torch.float32)
    tmp = torch.matmul(ry, vol.reshape(b, q, h2, w2)).float()
    patch = torch.matmul(tmp, rx.transpose(-1, -2))  # [B, Q, y support, x support]
    out = (
        (1.0 - fy) * (1.0 - fx) * patch[..., :k, :k]
        + (1.0 - fy) * fx * patch[..., :k, 1:]
        + fy * (1.0 - fx) * patch[..., 1:, :k]
        + fy * fx * patch[..., 1:, 1:]
    )
    return out.transpose(-1, -2).reshape(b, h1, w1, k * k)


def corr_pyramid_lookup(
    pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """The ``einsum`` lookup: [B, h1, w1, L*(2r+1)^2] fp32 over the volumes of
    ``build_corr_pyramid_from_fmaps``, the windows of
    ``corr_pyramid_lookup_gather`` up to fp32 summation order. An fp32
    volume multiplies in full fp32, as JAX's ``Precision.HIGHEST`` does, so
    this raises on the card when the caller has let TF32 into fp32 matrix
    products."""
    vol = pyramid[0]
    if vol.is_cuda and vol.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the einsum lookup of an fp32 volume needs full fp32 matrix products; "
            "torch.backends.cuda.matmul.allow_tf32 is on"
        )
    outs = [_lookup_level_matmul(v, coords / (2.0 ** i), radius) for i, v in enumerate(pyramid)]
    return torch.cat(outs, dim=-1)


def support_index(coords: torch.Tensor, radius: int, h2: int, w2: int):
    """Support taps of the windows at coords [BQ, 2] (x, y), at the map's
    scale, in an [h2, w2] map: (flat index [BQ, (2r+2)^2] into h2 * w2, clamped
    into the map; valid [BQ, 2r+2, 2r+2]). The window base is
    clip(floor(c) - r, -(2r+2), dim), so far-out coords cannot overflow."""
    sup = 2 * radius + 2
    ar = torch.arange(sup, device=coords.device)
    fl = torch.floor(coords.float())
    bx = torch.clamp(fl[:, 0] - radius, -sup, w2).long()
    by = torch.clamp(fl[:, 1] - radius, -sup, h2).long()
    xs = bx[:, None] + ar  # [BQ, sup]
    ys = by[:, None] + ar
    valid = ((ys >= 0) & (ys < h2))[:, :, None] & ((xs >= 0) & (xs < w2))[:, None, :]
    idx = ys.clamp(0, h2 - 1)[:, :, None] * w2 + xs.clamp(0, w2 - 1)[:, None, :]
    return idx.reshape(coords.shape[0], -1), valid


def window_support(plane: torch.Tensor, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """plane [BQ, h2, w2], coords [BQ, 2] (x, y) at the plane's scale ->
    [BQ, 2r+2, 2r+2] fp32 support patch [y, x]; taps outside the plane read 0."""
    bq, h2, w2 = plane.shape
    sup = 2 * radius + 2
    idx, valid = support_index(coords, radius, h2, w2)
    patch = torch.gather(plane.reshape(bq, h2 * w2), 1, idx)
    patch = patch.reshape(bq, sup, sup).float()
    return torch.where(valid, patch, torch.zeros_like(patch))


def support_cotangent(g: torch.Tensor, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Transpose of ``combine_support``: window cotangent g [BQ, (2r+1)^2]
    (dx-major) at coords [BQ, 2] -> support cotangent [BQ, 2r+2, 2r+2] [y, x]
    in fp32, d_sup[u, v] = sum over the 4 taps of w_tap * g[u - a, v - b]."""
    k = 2 * radius + 1
    c = coords.float()
    frac = c - torch.floor(c)
    fx = frac[:, 0][:, None, None]
    fy = frac[:, 1][:, None, None]
    gl = g.float().reshape(-1, k, k).transpose(1, 2)  # [BQ, dy, dx]
    return (
        (1.0 - fy) * (1.0 - fx) * F.pad(gl, (0, 1, 0, 1))
        + (1.0 - fy) * fx * F.pad(gl, (1, 0, 0, 1))
        + fy * (1.0 - fx) * F.pad(gl, (0, 1, 1, 0))
        + fy * fx * F.pad(gl, (1, 0, 1, 0))
    )


def combine_support(support: torch.Tensor, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """4-tap bilinear combine of support [BQ, 2r+2, 2r+2] at the fractional
    part of coords [BQ, 2] -> [BQ, (2r+1)^2] fp32, channels dx-major."""
    k = 2 * radius + 1
    c = coords.float()
    frac = c - torch.floor(c)
    fx = frac[:, 0][:, None, None]
    fy = frac[:, 1][:, None, None]
    p = support
    out = (
        (1.0 - fy) * (1.0 - fx) * p[:, :k, :k]
        + (1.0 - fy) * fx * p[:, :k, 1:]
        + fy * (1.0 - fx) * p[:, 1:, :k]
        + fy * fx * p[:, 1:, 1:]
    )  # [BQ, dy, dx]
    return out.transpose(1, 2).reshape(-1, k * k)


def lookup_vjp_dvols(
    g: torch.Tensor, coords: torch.Tensor, shapes, radius: int, out_dtype=None,
) -> list[torch.Tensor]:
    """Cotangent of a window lookup with respect to its per-query planes:
    g [..., L * (2r+1)^2] (dx-major, the lookup's output cotangent), coords
    [..., 2] (x, y) at level 0, shapes [(h2, w2)] per level -> d_plane [BQ,
    h2, w2] per level, BQ the queries of g.

    A query's row is zero but at its support taps inside the plane, which
    hold its support cotangent (``support_cotangent``, fp32) at coords / 2^l;
    taps outside the plane drop out, as the forward's mask reads them as 0.
    The taps of one query are distinct positions, so nothing is summed. The
    dtype rule is JAX's (``corr_fused.lookup_vjp_dvols``): a bf16 g gives the
    cotangent rounded to bf16, an fp32 g keeps it in fp32; the result is
    then cast to ``out_dtype`` (the planes' dtype; default the cotangent's)."""
    k2 = (2 * radius + 1) ** 2
    sup = 2 * radius + 2
    flat_c = coords.reshape(-1, 2).float()
    gq = g.reshape(flat_c.shape[0], len(shapes), k2)
    vol_dtype = torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32
    out = []
    for lvl, (h2, w2) in enumerate(shapes):
        c = flat_c * (1.0 / 2.0 ** lvl)
        d_sup = support_cotangent(gq[:, lvl], c, radius).to(vol_dtype)
        idx, valid = support_index(c, radius, h2, w2)
        # taps outside the plane go to one spare column, dropped after
        idx = torch.where(valid.reshape(idx.shape), idx, h2 * w2)
        row = torch.zeros((flat_c.shape[0], h2 * w2 + 1), dtype=vol_dtype, device=g.device)
        row.scatter_(1, idx, d_sup.reshape(-1, sup * sup))
        out.append(row[:, : h2 * w2].reshape(-1, h2, w2).to(out_dtype or vol_dtype))
    return out
