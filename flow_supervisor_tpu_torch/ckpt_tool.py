"""Checkpoint maintenance CLI (counterpart of the repository's root
``ckpt_tool.py``) over the port's ``ckpt_<step>.pt`` files.

    python -m flow_supervisor_tpu_torch.ckpt_tool list <ckpt_dir>
    python -m flow_supervisor_tpu_torch.ckpt_tool clean <ckpt_dir> <out_dir> [--step N]

``list`` prints the directory's checkpoint steps. ``clean`` writes the
model state of step N (default: the latest) to ``out_dir`` with no
optimizer state, as ``ckpt_<N>.pt``, and copies ``args.yaml`` beside it so
that the evaluate and extract_flow CLIs read the cleaned directory as they
read the original. ``--device``: ``cuda`` (the default; exits non-zero
without a card) or ``cpu``, where the checkpoint's tensors are loaded on
the way through.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("cmd", choices=["list", "clean"])
    p.add_argument("ckpt_dir")
    p.add_argument("out_dir", nargs="?")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch

    from flow_supervisor_tpu_torch.config import CONFIG_FILENAME
    from flow_supervisor_tpu_torch.training import checkpoint as ckpt

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ckpt_tool needs a CUDA device; none is available (pass --device cpu)",
              file=sys.stderr)
        return 2
    if args.cmd == "list":
        print("steps:", ckpt.checkpoint_steps(args.ckpt_dir))
        return 0
    if not args.out_dir:
        print("ckpt_tool clean needs an output directory", file=sys.stderr)
        return 2
    restored = ckpt.restore_checkpoint(args.ckpt_dir, step=args.step, map_location=args.device)
    if restored is None:
        print(f"ckpt_tool: no checkpoint in {args.ckpt_dir}", file=sys.stderr)
        return 2
    step = restored["step"]
    ckpt.save_checkpoint(args.out_dir, step, restored["model"])
    config = os.path.join(args.ckpt_dir, CONFIG_FILENAME)
    if os.path.exists(config):
        shutil.copyfile(config, os.path.join(args.out_dir, CONFIG_FILENAME))
    print(f"wrote optimizer-free checkpoint step {step} to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
