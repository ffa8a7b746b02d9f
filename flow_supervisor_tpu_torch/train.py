"""Training CLI (counterpart of the repo's root ``train.py``), on the card.

    python -m flow_supervisor_tpu_torch.train ckpts/semi/sintel \
        --stage semi-sintel_unsup_test-things_unsup --model_type raft-semi \
        --pretrained_ckpt ckpts/raft_baseline/things --image_size 400 720 ...
    python -m flow_supervisor_tpu_torch.train <ckpt_dir> ... --device cpu

It takes the root ``train.py``'s positional ``ckpt_dir`` and flags (the
fields of ``config.ModelCfg`` and ``config.TrainCfg`` and the reference
aliases), plus ``--device``: ``cuda`` (the default; exits non-zero without
a card) or ``cpu``. ``--run_eagerly`` / ``-e`` are accepted and dropped: the
port always runs eagerly. The config is restored from ``<ckpt_dir>/args.yaml``
when there is one, with the flags of this command line taking precedence,
and saved there otherwise; training reads the stage's datasets under
``FST_DATA_ROOT`` through ``data.pipeline.fetch_dataloader`` and resumes from
the directory's latest checkpoint (``training/loop.py``).

Data parallelism: ``--data_parallel N`` (-1, the default: every local card;
on the CPU, N processes) and ``--dcn_parallel M`` (M nodes) set the world
(``loop.world_of``). When it is larger than 1 and the process was not
started by ``torchrun`` (no ``RANK`` / ``WORLD_SIZE`` in the environment),
the command spawns its ranks itself with ``torch.multiprocessing``; they meet
through a ``FileStore`` in the checkpoint directory, which needs no network.
Under ``torchrun`` each process joins the world torchrun describes:

    torchrun --nproc_per_node 4 -m flow_supervisor_tpu_torch.train <ckpt_dir> ...

Each rank trains on its own card (``LOCAL_RANK`` under torchrun) or on the
CPU over gloo, with its rows of every global batch.
"""
from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv = [a for a in argv if a not in ("--run_eagerly", "-e")]

    import torch

    from flow_supervisor_tpu_torch.config import (
        ExperimentConfig,
        build_argparser,
        config_from_args,
        explicit_cli_fields,
    )

    parser = build_argparser()
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("train needs a CUDA device; none is available (pass --device cpu)",
              file=sys.stderr)
        return 2

    from flow_supervisor_tpu_torch.training.loop import check_config, world_of

    cfg = config_from_args(args)
    cfg = ExperimentConfig.maybe_restore(cfg.ckpt_dir, cfg, explicit=explicit_cli_fields(argv))
    check_config(cfg, args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        run_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), cfg, args.device,
                 "env://", int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
        return 0
    world = world_of(cfg, args.device)
    if world == 1:
        run_rank(0, 1, cfg, args.device)
        return 0
    import torch.multiprocessing as mp

    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    store = os.path.join(os.path.abspath(cfg.ckpt_dir), f".dist_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    try:
        mp.spawn(run_rank, args=(world, cfg, args.device, f"file://{store}"), nprocs=world)
    finally:
        if os.path.exists(store):
            os.remove(store)
    return 0


def run_rank(rank: int, world: int, cfg, device_type: str, init_method: str = "",
             local_rank: int | None = None) -> None:
    """Train as ``rank`` of a world of ``world`` (1: no process group) on
    its device, from this rank's shard of the stage's batches."""
    import torch

    from flow_supervisor_tpu_torch.data.pipeline import fetch_dataloader
    from flow_supervisor_tpu_torch.parallel import mesh
    from flow_supervisor_tpu_torch.training.loop import train

    device = mesh.rank_device(device_type, rank if local_rank is None else local_rank)
    if world > 1:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:  # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        mesh.init_world(world, rank, device, init_method)
    loader = fetch_dataloader(cfg.train, shard=(rank, world))
    try:
        train(cfg, loader, device=device)
    finally:
        loader.close()
        mesh.close_world()


if __name__ == "__main__":
    sys.exit(main())
