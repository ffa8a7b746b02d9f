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
"""
from __future__ import annotations

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

    from flow_supervisor_tpu_torch.data.pipeline import fetch_dataloader
    from flow_supervisor_tpu_torch.training.loop import check_config, train

    cfg = config_from_args(args)
    cfg = ExperimentConfig.maybe_restore(cfg.ckpt_dir, cfg, explicit=explicit_cli_fields(argv))
    check_config(cfg)
    loader = fetch_dataloader(cfg.train)
    try:
        train(cfg, loader, device=args.device)
    finally:
        loader.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
