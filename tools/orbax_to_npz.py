#!/usr/bin/env python
"""Convert a JAX training checkpoint (orbax) into the ``.npz`` the PyTorch
port reads.

    python tools/orbax_to_npz.py <ckpt_dir> <out.npz> [--step N]

``<ckpt_dir>`` is a directory written by
``flow_supervisor_tpu.training.checkpoint.save_checkpoint`` (an orbax
``CheckpointManager`` with one ``{"params", "batch_stats"[, "opt_state"]}``
item per step). The script restores step N (default: the latest) and writes
its parameters and batch-norm statistics as one array per leaf, keyed by the
'/'-joined flax path under ``params/`` and ``batch_stats/`` (e.g.
``params/fnet/ExtractorConv_0/Conv_0/kernel``); the optimizer state is left
out. ``flow_supervisor_tpu_torch.convert.load_flax_npz`` reads the file and
``convert.from_flax`` turns it into the port's state dict:

    from flow_supervisor_tpu_torch.convert import from_flax, load_flax_npz
    model.load_state_dict(from_flax(*load_flax_npz("raft.npz")))

It runs on the host, needs orbax and numpy, and touches no accelerator.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{'a/b/c': array} of a nested mapping of arrays."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(value, "items"):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def convert(ckpt_dir: str, out_path: str, step: int | None = None) -> int:
    """Write step's (default: the latest) variables of ``ckpt_dir`` to
    ``out_path`` -> the step converted."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(ckpt_dir))
    try:
        step = mgr.latest_step() if step is None else step
        if step is None or step not in mgr.all_steps():
            raise FileNotFoundError(f"{ckpt_dir}: no checkpoint at step {step} "
                                    f"(steps: {sorted(mgr.all_steps())})")
        restored = mgr.restore(step)
    finally:
        mgr.close()
    flat = flatten({k: restored[k] for k in ("params", "batch_stats") if k in restored})
    if not any(k.startswith("params/") for k in flat):
        raise ValueError(f"{ckpt_dir} step {step}: no 'params' in the checkpoint")
    np.savez(out_path, **flat)
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir")
    p.add_argument("out")
    p.add_argument("--step", type=int, default=None)
    args = p.parse_args(argv)
    step = convert(args.ckpt_dir, args.out, args.step)
    print(f"wrote {args.out} from step {step} of {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
