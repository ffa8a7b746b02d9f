"""Space-parallel evaluation: one image pair's rows over a ``torch.distributed``
world (counterpart of flow_supervisor_tpu/parallel/spatial.py).

The correlation pyramid of one pair is the memory wall at high resolution
(the einsum volume of a 448x1024 pair holds 7,168^2 fp32 values at level 0).
A world of n ranks splits the padded pair's rows: rank r holds rows
[r * H / n, (r + 1) * H / n), and with them the query rows of the pyramid.
The JAX package marks the split and lets XLA's SPMD partitioner insert the
collectives; here each one is written out:

- every conv reads the rows it needs beyond the shard from its neighbours
  (``halo_rows``; models/layers.py ``Conv2d``), then convolves with no
  vertical padding;
- instance and group norms take global moments: local fp32 sums of x and
  x^2 per (sample, channel), summed over the world
  (``all_reduce_moments``; models/layers.py);
- fmap2 is gathered whole on every rank before the pyramid is built
  (``gather_rows``; models/raft.py ``build_corr``), so each rank's queries
  are looked up by the model's own lookup backend, kernels included;
- GMA's attention gathers its keys and values (models/gma.py);
- the final flow is upsampled from a 1-row halo and gathered.

A shard is entered with ``shard(height, width)``, a context manager: in a
world of 1, and outside it, every module runs its unsharded code. Query
coordinates stay absolute in fmap2 (``first_row``), so a rank's coords0
starts at its first row at 1/8 resolution.

Every collective is an ``all_reduce``, which both NCCL and gloo carry for
CUDA tensors (two ranks on one card must use gloo, which has no
``send`` / ``recv`` or ``all_gather`` for CUDA tensors): a rank writes its
rows into its slot of a zeroed buffer and the world sums the buffer, which
is exact since every other slot adds zeros. bf16 travels as fp32 (exact).
A collective that fails raises; nothing is moved to the CPU in its place.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from flow_supervisor_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class SpaceShard:
    """This rank's place in a space-parallel world: rows [rank * H / world,
    (rank + 1) * H / world) of a padded pair of full size (height, width)."""

    rank: int
    world: int
    height: int
    width: int


_SHARD: contextvars.ContextVar[Optional[SpaceShard]] = contextvars.ContextVar(
    "space_shard", default=None)


def current() -> Optional[SpaceShard]:
    """The shard entered by ``shard``, or None outside one."""
    return _SHARD.get()


def check_height(height: int, world: int) -> None:
    """JAX's rule: every rank holds whole rows at 1/8 resolution."""
    if height % (8 * world) != 0:
        raise ValueError(
            f"space-parallel: H={height} must be a multiple of 8*space={8 * world} "
            "(use pad_bucket=8*space in the evaluator)")


@contextlib.contextmanager
def shard(height: int, width: int) -> Iterator[Optional[SpaceShard]]:
    """Run the model on this rank's rows of a (height, width) padded pair; in
    a world of 1 nothing is entered and the shard is None."""
    world = mesh.world_size()
    if world == 1:
        yield None
        return
    check_height(height, world)
    token = _SHARD.set(SpaceShard(mesh.rank(), world, height, width))
    try:
        yield _SHARD.get()
    finally:
        _SHARD.reset(token)


def space_world() -> int:
    """The shard's world size; 1 outside a shard."""
    sh = _SHARD.get()
    return 1 if sh is None else sh.world


def first_row(rows: int) -> int:
    """This rank's first global row at the resolution where it holds ``rows``
    rows (every rank holds as many); 0 outside a shard."""
    sh = _SHARD.get()
    return 0 if sh is None else sh.rank * rows


def local_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's rows of a full-frame tensor (x itself outside a shard)."""
    sh = _SHARD.get()
    if sh is None:
        return x
    rows = x.shape[dim] // sh.world
    return x.narrow(dim, sh.rank * rows, rows)


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    try:
        dist.all_reduce(t)
    except RuntimeError as e:
        raise RuntimeError(
            f"space-parallel: all_reduce of a {t.device.type} {t.dtype} tensor "
            f"{tuple(t.shape)} failed on the {dist.get_backend()} backend: {e}") from e
    return t


def gather_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The full tensor along ``dim`` (the rows) on every rank, contiguous; x
    outside a shard."""
    sh = _SHARD.get()
    if sh is None:
        return x
    rows = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = rows * sh.world
    buf = torch.zeros(shape, dtype=_wire_dtype(x.dtype), device=x.device)
    buf.narrow(dim, sh.rank * rows, rows).copy_(x)
    return _all_reduce(buf).to(x.dtype)


def halo_rows(x: torch.Tensor, top: int, bottom: int, dim: int = 1) -> torch.Tensor:
    """x with ``top`` rows of the ranks above and ``bottom`` rows of the ranks
    below around it along ``dim``, zeros beyond the image's top and bottom
    edges (outside a shard: zero padding). Contiguous when x is."""
    if top == 0 and bottom == 0:
        return x
    sh = _SHARD.get()
    rows = x.shape[dim]

    def zeros(n):
        shape = list(x.shape)
        shape[dim] = n
        return x.new_zeros(shape)

    if sh is None:
        return torch.cat([zeros(top), x, zeros(bottom)], dim=dim)
    if top > rows or bottom > rows:  # the halo reaches past the next rank
        full = torch.cat([zeros(top), gather_rows(x, dim), zeros(bottom)], dim=dim)
        return full.narrow(dim, sh.rank * rows, top + rows + bottom).contiguous()
    # slot r holds rank r's first `bottom` rows (the rank above's lower halo)
    # and its last `top` rows (the rank below's upper halo)
    edge = top + bottom
    shape = list(x.shape)
    shape[dim] = edge * sh.world
    buf = torch.zeros(shape, dtype=_wire_dtype(x.dtype), device=x.device)
    slot = buf.narrow(dim, sh.rank * edge, edge)
    slot.narrow(dim, 0, bottom).copy_(x.narrow(dim, 0, bottom))
    slot.narrow(dim, bottom, top).copy_(x.narrow(dim, rows - top, top))
    buf = _all_reduce(buf).to(x.dtype)
    above = (buf.narrow(dim, (sh.rank - 1) * edge + bottom, top) if sh.rank > 0
             else zeros(top))
    below = (buf.narrow(dim, (sh.rank + 1) * edge, bottom) if sh.rank < sh.world - 1
             else zeros(bottom))
    return torch.cat([above, x, below], dim=dim)


def conv_halo(k: int, stride: int, pad: int) -> tuple[int, int]:
    """(rows above, rows below) a conv of kernel height k, stride s and
    padding p reads beyond a shard of a multiple of s rows: its output rows
    [R h / s, (R + 1) h / s) read input rows R h - p to (R + 1) h - s - p + k - 1.
    A 7x7 s2 conv takes 3 and 2, a 3x3 s2 conv 1 and 0, a 1x1 s2 conv none."""
    return pad, max(k - pad - stride, 0)


def all_reduce_moments(sums: torch.Tensor) -> torch.Tensor:
    """fp32 sums (e.g. of x and x^2 per sample and channel) over the world;
    the sums themselves outside a shard."""
    if _SHARD.get() is None:
        return sums
    return _all_reduce(sums.float().clone())


def spatial_forward(model, iters: Optional[int] = None):
    """A callable ``(image1, image2, flow_init=None) -> (flow_up, flow_low)``
    over full padded images [B, H, W, 3] (flow_init [B, H, W, 2] or at 1/8)
    that runs this rank's rows of the pair and returns the final flows of the
    whole frame on every rank: flow_up [B, H, W, 2], flow_low [B, H/8, W/8,
    2]. H must be a multiple of 8 * world (``check_height``). In a world of 1
    it is the model's forward."""

    def run(image1, image2, flow_init=None):
        _, h, w, _ = image1.shape
        check_height(h, mesh.world_size())
        with shard(h, w):
            out = model(local_rows(image1), local_rows(image2), flow_init=flow_init,
                        iters=iters, final_flow_only=True)
            return out["flow_up"][-1], gather_rows(out["flow_low"][-1])

    return run
