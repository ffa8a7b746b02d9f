"""Flow extraction CLI (counterpart of the repository's root ``extract_flow.py``),
on the card: pairwise inference over frame directories, written as
Middlebury ``.flo`` files and HSV visualisation PNGs.

    python -m flow_supervisor_tpu_torch.extract_flow [ckpt_dir] \
        --source_dirs samples/davis/frames --target_dirs samples/davis/ \
        [--eval_iters 12] [--device cuda|cpu]

``ckpt_dir`` is a port checkpoint directory: its ``args.yaml`` and latest
``ckpt_<step>.pt`` give the model (RAFT, GMA or the small model, built by
``training.loop.build_model``); without it the model is the default
config's with random weights from seed 0 (a smoke run). The forward is
fp32, the student's ``Evaluator.predict`` (``evaluation.run_pair``) at
``--eval_iters``. Each source directory's frames (``.jpg``, ``.png``,
``.jpeg``, sorted by name: ``data.datasets.frames_directory``) are read by
``data.io.read_image``; each consecutive pair writes
``<target>/flo/<first frame's file name>.flo`` and
``<target>/vis/<first frame's file name>_flow.png`` (``utils.viz.visualize_flow``,
RGB), and the CLI ends with one JSON line: pairs, pairs/s and the host ms
a pair spent decoding, in the forward (which waits for the device) and
writing. ``--device``: ``cuda`` (the default; exits non-zero without a
card) or ``cpu``; ``--run_eagerly`` / ``-e`` are accepted and dropped.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("ckpt_dir", nargs="?", default=None,
                   help="checkpoint dir; omit for random weights (a smoke run)")
    p.add_argument("--source_dirs", nargs="+", required=True)
    p.add_argument("--target_dirs", nargs="+", required=True)
    p.add_argument("--eval_iters", type=int, default=12)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def load_model(ckpt_dir, device: str = "cuda"):
    """The fp32 model of ``ckpt_dir`` (its latest checkpoint, through
    ``evaluate.load_model``), or the default config's with random weights
    from seed 0, in eval mode on device."""
    if ckpt_dir:
        from flow_supervisor_tpu_torch.evaluate import load_model as load_checkpoint

        return load_checkpoint(ckpt_dir, device=device)[0]
    import torch

    from flow_supervisor_tpu_torch.config import ExperimentConfig
    from flow_supervisor_tpu_torch.training.loop import build_model

    cfg = ExperimentConfig()
    cfg.model.compute_dtype = "float32"
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    return model.to(torch.device(device)).eval()


def extract(model, source_dir: str, target_dir: str, iters: int = 12) -> dict:
    """Every consecutive pair of source_dir's frames -> flo/ and vis/ under
    target_dir. Returns the host seconds spent decoding, in the forward and
    writing, and the number of pairs."""
    import numpy as np

    from flow_supervisor_tpu_torch.data.datasets import frames_directory
    from flow_supervisor_tpu_torch.data.io import read_image, write_flo, write_png
    from flow_supervisor_tpu_torch.evaluation import run_pair
    from flow_supervisor_tpu_torch.utils.viz import visualize_flow

    flo_dir = os.path.join(target_dir, "flo")
    vis_dir = os.path.join(target_dir, "vis")
    os.makedirs(flo_dir, exist_ok=True)
    os.makedirs(vis_dir, exist_ok=True)
    secs = {"decode": 0.0, "forward": 0.0, "write": 0.0, "pairs": 0}
    for rec in frames_directory(source_dir):
        t0 = time.perf_counter()
        img1, img2 = read_image(rec.images[0]), read_image(rec.images[1])
        t1 = time.perf_counter()
        flow, _ = run_pair(model, img1, img2, "sintel", iters=iters)
        t2 = time.perf_counter()
        name = os.path.basename(rec.images[0])
        write_flo(os.path.join(flo_dir, name + ".flo"), flow)
        vis = (visualize_flow(flow) * 255).astype(np.uint8)
        write_png(os.path.join(vis_dir, name + "_flow.png"), vis)
        t3 = time.perf_counter()
        secs["decode"] += t1 - t0
        secs["forward"] += t2 - t1
        secs["write"] += t3 - t2
        secs["pairs"] += 1
        print(f"{name}: flow range x[{flow[..., 0].min():.1f},{flow[..., 0].max():.1f}]")
    return secs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv = [a for a in argv if a not in ("--run_eagerly", "-e")]
    args = build_parser().parse_args(argv)
    if len(args.source_dirs) != len(args.target_dirs):
        print("extract_flow: --source_dirs and --target_dirs differ in length", file=sys.stderr)
        return 2

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("extract_flow needs a CUDA device; none is available (pass --device cpu)",
              file=sys.stderr)
        return 2
    model = load_model(args.ckpt_dir, device=args.device)
    total = {"decode": 0.0, "forward": 0.0, "write": 0.0, "pairs": 0}
    t0 = time.perf_counter()
    for src, dst in zip(args.source_dirs, args.target_dirs):
        for k, v in extract(model, src, dst, args.eval_iters).items():
            total[k] += v
    n = max(total["pairs"], 1)
    print(json.dumps({"extract_flow": {
        "pairs": total["pairs"], "pairs_per_sec": total["pairs"] / (time.perf_counter() - t0),
        **{f"{k}_ms_per_pair": 1e3 * total[k] / n for k in ("decode", "forward", "write")}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
