"""Evaluation CLI (counterpart of the repository's root ``evaluate.py``), on the card.

    python -m flow_supervisor_tpu_torch.evaluate <ckpt_dir> --dataset sintel \
        [--eval_iters N] [--warm_start] [--use_teacher] [--pad_bucket 8] \
        [--step N] [--precision float32|bfloat16] [--device cuda|cpu]
    python -m flow_supervisor_tpu_torch.evaluate . --tf_ckpt ckpts/semi/sintel/ckpt-100000-weights

It takes the root CLI's positional ``ckpt_dir`` and flags, plus
``--device``: ``cuda`` (the default; exits non-zero without a card) or
``cpu``. ``--run_eagerly`` / ``-e`` are accepted and dropped: the port
always runs eagerly.

``--space_parallel N`` (N > 1) evaluates every pair over a world of N ranks,
each holding H / N of its padded rows (``evaluation.Evaluator``,
parallel/spatial.py; the padding aligns H to 8N). Unless the process was
started by ``torchrun`` (``RANK`` / ``WORLD_SIZE`` in the environment), the
command spawns its ranks with ``torch.multiprocessing``; they meet through a
``FileStore`` in a temporary directory (no network). Each rank runs on
``parallel.mesh.rank_device`` (card rank % cards, or the CPU), over NCCL
when every rank has a card of its own and gloo otherwise (two ranks on one
card). Rank 0 prints the results; the command exits non-zero if any rank
fails. Under torchrun N must equal the world size (else exit code 2):

    torchrun --nproc_per_node 2 -m flow_supervisor_tpu_torch.evaluate <ckpt_dir> \
        --dataset sintel --space_parallel 2

The model comes from the port's checkpoint directory: its ``args.yaml``
(``config.ExperimentConfig.load_yaml``), ``training.loop.build_model`` (RAFT,
GMA or the small model, with the teacher head for the semi types) and the
weights of ``ckpt_<step>.pt`` (``--step``, default the latest). With
``--tf_ckpt`` the weights come from a reference TensorFlow checkpoint prefix
(``convert.load_tf_checkpoint``, read without TensorFlow), the model type
``raft-semi`` when it holds the teacher head and ``raft-baseline``
otherwise, the rest of the config from ``ckpt_dir``'s ``args.yaml`` when it
has one (``.`` for the defaults). The compute dtype is ``--precision``
(fp32 by default, as the reference evaluates).

Datasets (under ``FST_DATA_ROOT``): sintel (the training split's clean and
final passes, dense, keys ``clean_*`` / ``final_*``), chairs (the
validation split), kitti and kitti2012 (the training splits, sparse, with
Fl-all). Iterations: 32 for Sintel and 24 otherwise unless
``--eval_iters``. A model with a teacher head scores the student and the
teacher. It prints the ``Evaluator``'s results as indented JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("ckpt_dir")
    p.add_argument("--dataset", default="sintel", choices=["sintel", "chairs", "kitti", "kitti2012"])
    p.add_argument("--eval_iters", type=int, default=None)
    p.add_argument("--warm_start", action="store_true")
    p.add_argument("--use_teacher", action="store_true", default=None,
                   help="force the teacher split; by default a model with a teacher head "
                        "(semi) scores the student and the teacher")
    p.add_argument("--pad_bucket", type=int, default=8,
                   help="round padded eval shapes up to this multiple (8: the reference's)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--tf_ckpt", default=None,
                   help="a reference TF checkpoint prefix; ckpt_dir then only gives the "
                        "config ('.' for the defaults)")
    p.add_argument("--space_parallel", type=int, default=1)
    p.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def load_model(ckpt_dir: str, tf_ckpt=None, step=None, precision: str = "float32",
               device: str = "cuda"):
    """The model to evaluate (module docstring), in eval mode on device ->
    (model, config)."""
    import torch

    from flow_supervisor_tpu_torch.config import CONFIG_FILENAME, ExperimentConfig
    from flow_supervisor_tpu_torch.training import checkpoint as ckpt
    from flow_supervisor_tpu_torch.training.loop import build_model

    if os.path.exists(os.path.join(ckpt_dir, CONFIG_FILENAME)):
        cfg = ExperimentConfig.load_yaml(ckpt_dir)
        cfg.ckpt_dir = ckpt_dir
    elif tf_ckpt:
        cfg = ExperimentConfig()
    else:
        raise FileNotFoundError(f"no {CONFIG_FILENAME} in {ckpt_dir} and no --tf_ckpt")
    cfg.model.compute_dtype = precision
    if tf_ckpt:
        from flow_supervisor_tpu_torch.convert import load_tf_checkpoint

        state = load_tf_checkpoint(tf_ckpt)
        cfg.model.model_type = ("raft-semi" if any(k.startswith("teacher_update_block.")
                                                   for k in state) else "raft-baseline")
    else:
        restored = ckpt.restore_checkpoint(ckpt_dir, step=step, map_location="cpu")
        if restored is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        state = restored["model"]
    model = build_model(cfg)
    model.load_state_dict(state)
    return model.to(torch.device(device)).eval(), cfg


def evaluate(model, dataset: str, iters: int, warm_start: bool = False, use_teacher=None,
             pad_bucket: int = 8, space_parallel: int = 1) -> dict:
    """The Evaluator's results over ``dataset``'s records (Sintel: both
    passes, keys prefixed ``clean_`` / ``final_``)."""
    from flow_supervisor_tpu_torch.data import datasets as D
    from flow_supervisor_tpu_torch.evaluation import Evaluator

    ev = Evaluator(model, iters=iters, use_teacher=use_teacher, pad_bucket=pad_bucket,
                   space_parallel=space_parallel)
    if dataset == "sintel":
        results = {}
        for dstype in ("clean", "final"):
            r = ev.evaluate(D.sintel(training=True, dstype=dstype), sparse=False,
                            warm_start=warm_start)
            results.update({f"{dstype}_{k}": v for k, v in r.items()})
        return results
    if dataset == "chairs":
        return ev.evaluate(D.flying_chairs(training=False), sparse=False)
    recs = D.kitti(training=True) if dataset == "kitti" else D.kitti_2012(training=True)
    return ev.evaluate(recs, sparse=True, warm_start=warm_start)


def run(args, device: str, space_parallel: int = 1) -> dict:
    """Load the model on ``device`` and evaluate it (in the current world)."""
    model, _ = load_model(args.ckpt_dir, args.tf_ckpt, args.step, args.precision, device)
    iters = args.eval_iters or (32 if args.dataset == "sintel" else 24)
    return evaluate(model, args.dataset, iters, args.warm_start, args.use_teacher,
                    args.pad_bucket, space_parallel)


def run_rank(rank: int, world: int, args, init_method: str, out_path: str | None = None,
             local_rank: int | None = None) -> dict:
    """Evaluate as ``rank`` of a world of ``world`` on this rank's device,
    with ``args.space_parallel`` ranks to a pair (the Evaluator refuses a
    count other than the world's); rank 0 writes the results to
    ``out_path`` as JSON."""
    import torch

    from flow_supervisor_tpu_torch.parallel import mesh

    device = mesh.rank_device(args.device, rank if local_rank is None else local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    mesh.init_world(world, rank, device, init_method)
    try:
        results = run(args, str(device), args.space_parallel)
    finally:
        mesh.close_world()
    if rank == 0 and out_path:
        with open(out_path, "w") as f:
            json.dump(results, f)
    return results


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv = [a for a in argv if a not in ("--run_eagerly", "-e")]
    args = build_parser().parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("evaluate needs a CUDA device; none is available (pass --device cpu)",
              file=sys.stderr)
        return 2
    if args.space_parallel < 1:
        print(f"--space_parallel must be at least 1, got {args.space_parallel}", file=sys.stderr)
        return 2
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and "RANK" in os.environ:  # torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if args.space_parallel != world:
            print(f"evaluate: --space_parallel {args.space_parallel} under torchrun needs a "
                  f"world of {args.space_parallel} ranks; torchrun started {world}",
                  file=sys.stderr)
            return 2
        results = run_rank(rank, world, args, "env://",
                           local_rank=int(os.environ.get("LOCAL_RANK", rank)))
        if rank == 0:
            print(json.dumps(results, indent=2))
        return 0
    if args.space_parallel == 1:
        print(json.dumps(run(args, args.device), indent=2))
        return 0
    import tempfile

    import torch.multiprocessing as mp

    n = args.space_parallel
    with tempfile.TemporaryDirectory(prefix="fst_eval_") as d:
        out = os.path.join(d, "results.json")
        try:
            mp.spawn(run_rank, args=(n, args, "file://" + os.path.join(d, "store"), out),
                     nprocs=n)
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            print(f"evaluate: a rank of the space-parallel world failed:\n{e}", file=sys.stderr)
            return 1
        with open(out) as f:
            results = json.load(f)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
