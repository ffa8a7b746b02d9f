"""Evaluation CLI (counterpart of the repository's root ``evaluate.py``), on the card.

    python -m flow_supervisor_tpu_torch.evaluate <ckpt_dir> --dataset sintel \
        [--eval_iters N] [--warm_start] [--use_teacher] [--pad_bucket 8] \
        [--step N] [--precision float32|bfloat16] [--device cuda|cpu]
    python -m flow_supervisor_tpu_torch.evaluate . --tf_ckpt ckpts/semi/sintel/ckpt-100000-weights

It takes the root CLI's positional ``ckpt_dir`` and flags, plus
``--device``: ``cuda`` (the default; exits non-zero without a card) or
``cpu``. ``--run_eagerly`` / ``-e`` are accepted and dropped: the port
always runs eagerly. ``--space_parallel`` above 1 is refused
(``evaluation.Evaluator``).

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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv = [a for a in argv if a not in ("--run_eagerly", "-e")]
    args = build_parser().parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("evaluate needs a CUDA device; none is available (pass --device cpu)",
              file=sys.stderr)
        return 2
    model, _ = load_model(args.ckpt_dir, args.tf_ckpt, args.step, args.precision, args.device)
    iters = args.eval_iters or (32 if args.dataset == "sintel" else 24)
    try:
        results = evaluate(model, args.dataset, iters, args.warm_start, args.use_teacher,
                           args.pad_bucket, args.space_parallel)
    except NotImplementedError as e:  # --space_parallel above 1
        print(e, file=sys.stderr)
        return 2
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
