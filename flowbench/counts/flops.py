"""Model FLOPs that the equations need at a cell's shapes: 2 per
multiply-add of every conv and matrix product (what
``torch.utils.flop_counter`` counts), with the correlation counted as the
dot products of the support taps that the lookups read
(``lookup.support_taps``), not as the all-pairs volume, so the count does
not depend on the lookup backend. Elementwise work, norms, softmax and
pooling are not counted.
"""
from __future__ import annotations


def _down(n: int) -> int:
    return -(-n // 2)


def conv(c_in: int, c_out: int, kh: int, kw: int, h_out: int, w_out: int) -> int:
    return 2 * c_in * c_out * kh * kw * h_out * w_out


def encoder(h: int, w: int, out_dim: int) -> int:
    """RAFT's BasicEncoder over one [h, w] image (either norm)."""
    h2, w2 = _down(h), _down(w)
    total = conv(3, 64, 7, 7, h2, w2) + 4 * conv(64, 64, 3, 3, h2, w2)
    c_in = 64
    for dim in (96, 128):
        h2, w2 = _down(h2), _down(w2)
        total += conv(c_in, dim, 3, 3, h2, w2) + conv(c_in, dim, 1, 1, h2, w2)
        total += 3 * conv(dim, dim, 3, 3, h2, w2)
        c_in = dim
    return total + conv(128, out_dim, 1, 1, h2, w2)


def update(h8: int, w8: int, gma: bool, levels: int = 4, radius: int = 4,
           heads_dim: int = 128) -> int:
    """One refinement step at the 1/8 grid (motion encoder, GMA's
    aggregation, the separable GRU, flow and mask heads)."""
    n = h8 * w8
    cor = levels * (2 * radius + 1) ** 2
    total = (conv(cor, 256, 1, 1, h8, w8) + conv(256, 192, 3, 3, h8, w8)
             + conv(2, 128, 7, 7, h8, w8) + conv(128, 64, 3, 3, h8, w8)
             + conv(256, 126, 3, 3, h8, w8))
    x = 256
    if gma:
        total += conv(128, heads_dim, 1, 1, h8, w8) + 2 * n * n * heads_dim
        x = 384
    total += 3 * (conv(128 + x, 128, 1, 5, h8, w8) + conv(128 + x, 128, 5, 1, h8, w8))
    total += conv(128, 256, 3, 3, h8, w8) + conv(256, 2, 3, 3, h8, w8)
    total += conv(128, 256, 3, 3, h8, w8) + conv(256, 576, 1, 1, h8, w8)
    return total


def attention(h8: int, w8: int, heads_dim: int = 128) -> int:
    """GMA's map once a forward: the q, k projection and q . k^T."""
    n = h8 * w8
    return conv(128, 2 * heads_dim, 1, 1, h8, w8) + 2 * n * n * heads_dim


def upsample(h8: int, w8: int) -> int:
    """One x8 convex upsampling: 9 weights of 64 sub-pixels, 2 channels."""
    return 2 * 9 * 64 * 2 * h8 * w8


def forward(h: int, w: int, iters: int, gma: bool, teacher_iters: int = 0) -> int:
    """One pair's forward at [h, w] (multiples of 8) without the lookups'
    dot products: fnet on both images, cnet, GMA's map, ``iters`` steps and
    one upsampling, and the teacher's ``teacher_iters`` steps and its own
    upsampling when it runs."""
    h8, w8 = h // 8, w // 8
    total = 2 * encoder(h, w, 256) + encoder(h, w, 256) + iters * update(h8, w8, gma)
    total += upsample(h8, w8)
    if gma:
        total += attention(h8, w8)
    if teacher_iters:
        total += teacher_iters * update(h8, w8, gma) + upsample(h8, w8)
    return total


def semi_step(batch: int, sup_hw, unsup_hw, full_hw, iters: int, teacher_iters: int,
              gma: bool) -> int:
    """The flow supervisor's step without the lookups' dot products: the
    backward counted as twice the forward of every part that takes a
    gradient, the parts without one (the teacher's features and context,
    the unsupervised branch's teacher) once. The supervised branch runs one
    direction, its teacher with a gradient into the teacher head (L_fl),
    every iteration upsampled in the crop; the unsupervised branch both
    directions, its teacher without gradient, the last iteration upsampled."""
    fh8, fw8 = full_hw[0] // 8, full_hw[1] // 8
    full_ctx = encoder(*full_hw, 256) + (attention(fh8, fw8) if gma else 0)

    def student(hw):
        h8, w8 = hw[0] // 8, hw[1] // 8
        return (encoder(*hw, 256) + (attention(h8, w8) if gma else 0)
                + iters * (update(h8, w8, gma) + upsample(h8, w8)))

    sup_h8, sup_w8 = sup_hw[0] // 8, sup_hw[1] // 8
    sup = (3 * (2 * encoder(*sup_hw, 256) + student(sup_hw)) + 2 * encoder(*full_hw, 256)
           + full_ctx + 3 * teacher_iters * (update(fh8, fw8, gma) + upsample(sup_h8, sup_w8)))
    unsup_h8, unsup_w8 = unsup_hw[0] // 8, unsup_hw[1] // 8
    unsup = (3 * 2 * encoder(*unsup_hw, 256) + 2 * encoder(*full_hw, 256)
             + 2 * (3 * student(unsup_hw) + full_ctx
                    + teacher_iters * update(fh8, fw8, gma) + upsample(unsup_h8, unsup_w8)))
    return batch * (sup + unsup)
