"""Flow extraction on the GPU: run pairwise inference over consecutive frames
and write Middlebury ``.flo`` files (counterpart of the repository's
``extract_flow.py``).

    python -m flow_supervisor_tpu_torch.extract_flow --source_dir frames/ \
        --target_dir out/ [--params raft.npz] [--iters 12] [--seed 0]
        [--lookup_backend plane|fused|pallas|einsum|zero|auto]

Frames are ``.npy`` arrays [H, W, 3], float in [0, 1] or uint8, taken in
sorted file-name order; pair (i, i+1) writes ``<target_dir>/<frame i>.flo``.
``--params`` is an .npz of the JAX package's variables (see
``convert.load_flax_npz``); without it the weights are random from ``--seed``
(a smoke run). A CUDA device is required.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from flow_supervisor_tpu_torch.convert import from_flax, load_flax_npz
from flow_supervisor_tpu_torch.evaluation import run_pair
from flow_supervisor_tpu_torch.flo import write_flo
from flow_supervisor_tpu_torch.models.raft import LOOKUP_BACKENDS, RAFT, RAFTConfig


def _frame(path: str) -> np.ndarray:
    x = np.load(path)
    if x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"{path}: frames must be [H, W, 3], got {x.shape}")
    if x.dtype == np.uint8:
        return x.astype(np.float32) / 255.0
    return x.astype(np.float32)


def build_model(params: str | None, seed: int, device, lookup_backend: str = "plane") -> RAFT:
    """fp32 RAFT on ``device``: weights from a JAX .npz, or random from ``seed``."""
    model = RAFT(RAFTConfig(lookup_backend=lookup_backend),
                 generator=torch.Generator().manual_seed(seed))
    if params:
        model.load_state_dict(from_flax(*load_flax_npz(params)))
    return model.to(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source_dir", required=True)
    p.add_argument("--target_dir", required=True)
    p.add_argument("--params", default=None, help="npz of JAX params; omit for random weights")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lookup_backend", default="plane", choices=LOOKUP_BACKENDS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("extract_flow needs a CUDA device; none is available")
    model = build_model(args.params, args.seed, torch.device("cuda"), args.lookup_backend)
    frames = sorted(f for f in os.listdir(args.source_dir) if f.endswith(".npy"))
    os.makedirs(args.target_dir, exist_ok=True)
    for a, b in zip(frames, frames[1:]):
        img1 = _frame(os.path.join(args.source_dir, a))
        img2 = _frame(os.path.join(args.source_dir, b))
        flow, _ = run_pair(model, img1, img2, "sintel", iters=args.iters)
        name = os.path.splitext(a)[0]
        write_flo(os.path.join(args.target_dir, name + ".flo"), flow)
        print(f"{name}: flow x[{flow[..., 0].min():.1f}, {flow[..., 0].max():.1f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
