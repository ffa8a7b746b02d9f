"""Data parallelism on ``torch.distributed`` (counterpart of
flow_supervisor_tpu/parallel/mesh.py).

The JAX package runs one jitted step over a mesh whose 'data' axis shards
the global batch; XLA all-reduces the gradients, and every batch statistic
and loss reduction is over the global batch. Here each process (a rank)
holds a full replica of the model and its rows of the global batch
(``shard_rows`` / ``shard_batch``); after the backward the train steps
average the gradients over the world (``all_reduce_grads``, flat buffers)
before the optimizer, so the per-variable clipnorm sees the global
gradient, as in JAX. ``DistributedDataParallel`` is not used: it hooks
``forward()``, and the steps call ``semi_forward``, ``unsup_forward`` and
``teacher_iterate``. What else depends on the batch goes through this
module too: training-mode batch norm takes global statistics
(``all_reduce_sum``, differentiable), the census loss a global normalizer
(``global_mean``), and the logs are averaged (``mean_log``).

The world is a flat one: ``plan_world`` turns the config's
``data_parallel`` (-1: every local device, as in JAX) and ``dcn_parallel``
(nodes, JAX's pod mesh) into a world size; the batch must divide it, so
that every rank's means cover the same count. NCCL joins CUDA ranks that
each own a card; gloo the CPU ranks, and CUDA ranks that share a card
(NCCL refuses two ranks on one GPU; gloo all-reduces CUDA tensors through
the host). Every helper is the identity in a world of 1 or without an
initialized process group.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def auto_data_parallel(batch_size: int, n_devices: int) -> int:
    """Largest device count <= n_devices that divides the global batch (JAX's
    rule; the reference errors when batch % replicas != 0)."""
    n = min(n_devices, batch_size)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return max(n, 1)


def plan_world(batch_size: int, data_parallel: int, dcn_parallel: int, n_local: int) -> int:
    """World size of a run: ``dcn_parallel`` > 1 nodes of ``n_local`` ranks
    each (the batch must divide it, JAX's assert), else
    ``auto_data_parallel`` over ``data_parallel`` devices (-1: ``n_local``)."""
    if dcn_parallel > 1:
        world = dcn_parallel * n_local
        if batch_size % world != 0:
            raise ValueError(
                f"batch_size={batch_size} must divide evenly over the world ({dcn_parallel} "
                f"nodes x {n_local} ranks = {world}); pick a batch that is a multiple of the "
                "rank count or lower --dcn_parallel")
        return world
    return auto_data_parallel(batch_size, n_local if data_parallel < 0 else data_parallel)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main() -> bool:
    return rank() == 0


def backend_for(device: torch.device, world: int) -> str:
    """NCCL for CUDA ranks that each own a card, gloo otherwise."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank_: int) -> torch.device:
    """The device of a rank: card rank % cards on CUDA, the CPU otherwise."""
    if device_type == "cuda":
        return torch.device("cuda", rank_ % torch.cuda.device_count())
    return torch.device("cpu")


def init_world(world: int, rank_: int, device: torch.device, init_method: str,
               backend: Optional[str] = None) -> None:
    """Join a world of ``world`` ranks as ``rank_`` (``init_method``: a
    ``file://`` store, which needs no network, or ``env://`` under torchrun)."""
    dist.init_process_group(backend or backend_for(device, world), init_method=init_method,
                            world_size=world, rank=rank_)


def close_world() -> None:
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def shard_rows(batch_size: int, rank_: int, world: int) -> tuple[int, int]:
    """[lo, hi): this rank's rows of a global batch that divides the world."""
    if batch_size % world != 0:
        raise ValueError(f"batch {batch_size} does not divide over {world} ranks")
    n = batch_size // world
    return rank_ * n, (rank_ + 1) * n


def shard_batch(batch: dict, rank_: Optional[int] = None, world: Optional[int] = None) -> dict:
    """This rank's rows of a global batch dict (JAX's ``shard_batch``: the
    rows a device of the 'data' axis holds)."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    lo, hi = shard_rows(len(next(iter(batch.values()))), rank_, world)
    return {k: v[lo:hi] for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the world; the cotangent is summed too, so that after the
    gradients' average each rank's share of a global statistic gets the
    global objective's gradient."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of x over the world (x itself in a world of 1)."""
    return _AllReduceSum.apply(x) if world_size() > 1 else x


@torch.no_grad()
def global_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the ranks of a quantity without gradient (x in a world of 1)."""
    world = world_size()
    if world == 1:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x / world


@torch.no_grad()
def all_reduce_grads(grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The gradients averaged over the world, through one flat buffer per
    dtype (the dict itself in a world of 1)."""
    world = world_size()
    if world == 1:
        return grads
    out = dict(grads)
    by_dtype: dict[torch.dtype, list[str]] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for names in by_dtype.values():
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        dist.all_reduce(flat)
        flat /= world
        for k, part in zip(names, torch.split(flat, [grads[k].numel() for k in names])):
            out[k] = part.view_as(grads[k])
    return out


@torch.no_grad()
def mean_log(log: dict) -> dict:
    """The step's scalar logs averaged over the world (each rank's value is
    its shard's; equal shards make the average the global batch's value).
    Entries that are not 0-d tensors (``_grads``) pass through."""
    if world_size() == 1:
        return log
    keys = [k for k, v in log.items() if torch.is_tensor(v) and v.dim() == 0]
    if not keys:
        return log
    flat = global_mean(torch.stack([log[k].float() for k in keys]))
    return {**log, **dict(zip(keys, flat.unbind()))}
