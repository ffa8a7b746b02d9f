"""Multi-rank dry run (counterpart of flow_supervisor_tpu/parallel/dryrun.py
``run_dryrun``): one full train step over a data-parallel world of n ranks
on tiny shapes, held against the same step in one process on the whole
batch.

    python -m flow_supervisor_tpu_torch.parallel.dryrun --world 2 [--device cpu]
        [--kinds semi unsup baseline space] [--backend gloo] [--cudnn]

The step kinds (``STEPS``), each on a global batch of ``world`` rows (one
a rank) of noise images, 32x48 crops of 48x64 frames, fp32, random weights
from a seed with non-trivial batch-norm statistics and affine parameters:

- ``semi``: JAX's dry run, the flow-supervisor semi step with the teacher
  SMURF loss (``occlusion="wang"``), robust L_fr with ``lfr_sum_reduction``,
  2 student and 1 teacher iterations, frozen batch norm;
- ``unsup``: the Unsup step (census, smoothness, self-supervision; wang);
- ``baseline``: the chairs Baseline step with unfrozen batch norm.

``space`` is the space check (``run_space_check``, JAX's dryrun.py:211-223):
a RAFT forward at the einsum lookup, 2 iterations, on one 8 * world * 2 x
48 pair whose rows are sharded over the world (parallel/spatial.py),
against one process, within ``SPACE_LIMIT``.

The ranks are spawned with ``torch.multiprocessing`` and meet through a
``FileStore`` in a scratch directory (no network). Each rank saves its
step's losses, gradients, parameters after the step and running statistics;
``run_dryrun`` checks that every rank holds the same parameters and
statistics as rank 0, and measures rank 0's distance from the one-process
step (``compare``). ``main`` prints one JSON line a kind and exits non-zero
when a limit (``limits``) is not met. Both sides run batch-invariant
(``batch_invariant_cpu``, ``batch_invariant_cuda``), so the comparison sees
the data-parallel reductions and not the libraries' choices by batch size;
``--cudnn`` keeps cuDNN's convs on the card, the one-card training path.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

# the limits of a world against one process on the global batch: losses
# (relative); each gradient (of its variable's largest; a conv bias that a
# normalization by the batch's own statistics follows, whose gradient is
# zero in exact arithmetic, of its weight's largest); each parameter's
# update by the step (of lr) where the reference gradient lies beyond the
# gradient limit of zero (Adam's first step, lr * g / (|g| + eps), takes its
# sign from rounding where the gradient is noise, and the gradient limit
# holds those elements); running statistics (absolute).
LIMITS = {"loss_rel": 1e-6, "grad_rel": 1e-5, "update_lr": 0.1, "stats_abs": 1e-6}
# On the CPU a step with a census term (the Unsup step; the semi step's
# teacher SMURF loss) cannot meet the gradient limit: its gradient is
# ill-conditioned in fp32 (ROADMAP Queue 3), and a rank's B=1 correlation
# products of the coarsest level run another BLAS path than B=2's, 1e-5
# apart, which moves its gradients by up to 4.3e-4 of a variable's largest
# where the same step without the census term stays within 1e-5. There it is
# held to the repo's census limit (tests/test_torch_train_unsup.py: 1e-3 of
# the largest). On the card it meets ``LIMITS``.
CPU_CENSUS_GRAD_REL = 1e-3
# With cuDNN's convs (``--cudnn``) a rank's B=1 convs take other algorithms
# than the one process's B=2 (2.7e-5 of a variable's largest gradient on the
# card, PERF.md §6 PR 17); a disagreement of the batch statistics, such as
# cuDNN's batch norm against the global formula (3.6e-2), still fails.
CUDNN_GRAD_REL = 1e-4

CROP_HW, FULL_HW, CROP_YX = (32, 48), (48, 64), (8, 8)
STEPS = {
    "semi": (dict(model_type="raft-semi", iters=2, teacher_iters=1, teacher_smurf_weight=1.0,
                  occlusion="wang", lfr_loss_type="robust", lfr_sum_reduction=True),
             dict(stage="semi-sintel_unsup_test-things_unsup")),
    "unsup": (dict(model_type="raft-unsup", iters=2), dict(stage="sintel_unsup")),
    "baseline": (dict(model_type="raft-baseline", iters=2), dict(stage="chairs")),
}


def step_case(kind: str, batch_size: int, seed: int = 0, lookup_backend: str = "auto"):
    """(config, weights, global batch on the CPU) of a step kind."""
    import numpy as np

    from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg
    from flow_supervisor_tpu_torch.training.loop import build_model

    model_kw, train_kw = STEPS[kind]
    cfg = ExperimentConfig(
        ModelCfg(**model_kw, compute_dtype="float32", lookup_backend=lookup_backend),
        TrainCfg(**train_kw, batch_size=batch_size, lr=1e-5, lr_schedule="constant",
                 weight_decay=0.0, seed=seed))
    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg, gen)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            for t in (m.running_mean, m.running_var, m.weight, m.bias):
                t.data.uniform_(0.5, 1.5, generator=gen)
    rng = np.random.default_rng(seed)

    def img(*shape):
        return torch.from_numpy(rng.uniform(0, 1, (batch_size, *shape)).astype(np.float32))

    (h, w), (fh, fw), (y, x) = CROP_HW, FULL_HW, CROP_YX
    full1, full2 = img(fh, fw, 3), img(fh, fw, 3)
    frames = {"image1": full1[:, y:y + h, x:x + w].contiguous(),
              "image2": full2[:, y:y + h, x:x + w].contiguous(),
              "orig_image1": full1, "orig_image2": full2,
              "crop_yx": torch.tensor([[y, x]] * batch_size)}
    labels = {"flow": torch.from_numpy(rng.normal(0, 2, (batch_size, h, w, 2)).astype(np.float32)),
              "valid": torch.from_numpy(
                  (rng.uniform(0, 1, (batch_size, h, w, 1)) > 0.1).astype(np.float32))}
    if kind == "semi":
        batch = ({**frames, **labels}, dict(frames))
    elif kind == "unsup":
        batch = frames
    else:
        batch = {"image1": frames["image1"], "image2": frames["image2"], **labels}
    return cfg, model.state_dict(), batch


def batch_invariant_cpu() -> None:
    """One thread and no oneDNN: PyTorch's CPU convs then give each sample
    the same bits at any batch size (with oneDNN, or several threads, a
    96-channel 3x3 conv's outputs move by up to 1e-4 between B=1 and B=2),
    so a rank's shard computes what the one-process batch computes for the
    same rows, and the comparison sees the data-parallel reductions alone."""
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False


def batch_invariant_cuda(cudnn: bool = False) -> None:
    """Full fp32 matrix products and convs (no TF32) on both sides of a
    comparison on the card, and no cuDNN unless ``cudnn``: cuDNN picks its
    conv algorithm by shape, so a sample's bits change with the batch size
    (the chairs Baseline's gradients moved by 2.7e-5 of a variable's largest
    between a world of 2 and one process, NVIDIA H100 80GB HBM3, PERF.md §6
    PR 17); PyTorch's own CUDA convs do not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = cudnn


def run_step(cfg, weights, batch, device) -> dict:
    """One train step from ``weights`` on ``device`` in the current world ->
    its losses, the gradients it applied, the parameters after it and the
    running batch-norm statistics, on the CPU."""
    from flow_supervisor_tpu_torch.training.loop import build_model, make_step
    from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
    from flow_supervisor_tpu_torch.training.state import TrainState

    model = build_model(cfg)
    model.load_state_dict(weights)
    model.to(device)
    frozen = batchnorm_params(model) if model.cfg.freeze_bn else ()
    state = TrainState.create(dict(model.named_parameters()), make_optimizer(cfg.train, frozen))
    on = (tuple({k: v.to(device) for k, v in b.items()} for b in batch)
          if isinstance(batch, tuple) else {k: v.to(device) for k, v in batch.items()})
    state, log = make_step(model, cfg, debug_grads=True)(state, on)
    grads = {k: g.detach().cpu() for k, g in log.pop("_grads").items()}
    return {"log": {k: float(v) for k, v in log.items()}, "grads": grads,
            "params": {k: p.detach().cpu() for k, p in state.params.items()},
            "stats": {k: v.detach().cpu() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def _shard(batch, rank: int, world: int):
    from flow_supervisor_tpu_torch.parallel import mesh

    if isinstance(batch, tuple):
        return tuple(mesh.shard_batch(b, rank, world) for b in batch)
    return mesh.shard_batch(batch, rank, world)


def _rank(rank: int, world: int, kinds, device_type: str, backend, workdir: str,
          lookup_backend: str, cudnn: bool) -> None:
    """A rank of the dry run: join the world, run each kind's step on this
    rank's rows, save the results as <workdir>/<kind>_<rank>.pt."""
    from flow_supervisor_tpu_torch.parallel import mesh

    device = mesh.rank_device(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        batch_invariant_cuda(cudnn)
    else:
        batch_invariant_cpu()
    mesh.init_world(world, rank, device, "file://" + os.path.join(workdir, "store"), backend)
    try:
        for kind in kinds:
            cfg, weights, batch = step_case(kind, world, lookup_backend=lookup_backend)
            res = run_step(cfg, weights, _shard(batch, rank, world), device)
            torch.save(res, os.path.join(workdir, f"{kind}_{rank}.pt"))
    finally:
        mesh.close_world()


def noise_bias(name: str, bn_train: bool = False) -> bool:
    """A conv bias that a normalization by the batch's own statistics follows
    (all but each encoder's last conv): in fnet (instance norm) and, with
    unfrozen batch norm, in cnet. Its gradient is zero in exact arithmetic,
    fp32 noise in practice."""
    nets = ("fnet", "cnet") if bn_train else ("fnet",)
    net = name.split(".")[0]
    return net in nets and name.endswith(".bias") and not name.endswith(
        (".norm1.bias", ".norm2.bias", ".downsample.1.bias")) and name != f"{net}.conv2.bias"


def compare(run: dict, ref: dict, bn_train: bool, lr: float, grad_rel: float) -> dict:
    """How far a step's results (``run_step``) lie from a reference step's;
    ``grad_rel``: the gradient limit, beyond which (of the variable's scale)
    a reference gradient's element has its update compared."""
    grad_err, upd_err = {}, {}
    for k, g in ref["grads"].items():
        scale = float((ref["grads"][k[: -len("bias")] + "weight"] if noise_bias(k, bn_train)
                       else g).abs().max())
        grad_err[k] = float((run["grads"][k] - g).abs().max()) / max(scale, 1e-30)
        upd = (run["params"][k] - ref["params"][k]).abs()[g.abs() > grad_rel * scale]
        upd_err[k] = float(upd.max()) / lr if upd.numel() else 0.0
    worst, worst_upd = max(grad_err, key=grad_err.get), max(upd_err, key=upd_err.get)
    return {
        "max_rel_err_losses": max(abs(run["log"][k] - v) / max(abs(v), 1e-30)
                                  for k, v in ref["log"].items()),
        "max_grad_err_rel_to_largest": grad_err[worst], "worst_grad_var": worst,
        "max_update_err_lr": upd_err[worst_upd], "worst_update_var": worst_upd,
        "max_abs_err_params_all": max(float((run["params"][k] - p).abs().max())
                                      for k, p in ref["params"].items()),
        "max_abs_err_running_stats": max([float((run["stats"][k] - s).abs().max())
                                          for k, s in ref["stats"].items()] or [0.0]),
    }


def has_census(cfg) -> bool:
    mc = cfg.model
    if mc.model_type.endswith("semi"):
        return mc.teacher_smurf_weight > 0.0 and mc.census_weight > 0.0
    return mc.model_type.endswith("unsup") and mc.census_weight > 0.0


def limits(census: bool, device_type: str, cudnn: bool = False) -> dict:
    """``LIMITS``, with the gradient limit ``CPU_CENSUS_GRAD_REL`` for a
    census step on the CPU and ``CUDNN_GRAD_REL`` with cuDNN's convs."""
    grad_rel = LIMITS["grad_rel"]
    if census and device_type == "cpu":
        grad_rel = CPU_CENSUS_GRAD_REL
    if cudnn and device_type == "cuda":
        grad_rel = max(grad_rel, CUDNN_GRAD_REL)
    return {**LIMITS, "grad_rel": grad_rel}


def within_limits(err: dict, lim: dict) -> bool:
    return (err["max_rel_err_losses"] <= lim["loss_rel"]
            and err["max_grad_err_rel_to_largest"] <= lim["grad_rel"]
            and err["max_update_err_lr"] <= lim["update_lr"]
            and err["max_abs_err_running_stats"] <= lim["stats_abs"])


def run_dryrun(world: int, kinds=("semi",), device_type: str = "cpu", backend=None,
               lookup_backend: str = "auto", cudnn: bool = False, rank_fn=_rank) -> dict:
    """One step of each kind over a world of ``world`` spawned ranks against
    the same step in this process on the whole batch -> {kind: errors}, each
    with ``"ranks_equal"`` (every rank's parameters and statistics equal rank
    0's, bit for bit), the ranks' and the reference's logs, ``"limits"``
    (``limits``), ``"ok"`` (the ranks equal and ``within_limits``), and
    ``"bit_for_bit"``: rank 0's step equals the reference bit for bit. Both
    sides run batch-invariant (``batch_invariant_cpu`` /
    ``batch_invariant_cuda``, cuDNN's convs kept with ``cudnn``);
    ``lookup_backend`` is every step's. Each rank runs ``rank_fn`` (``_rank``'s
    arguments)."""
    import torch.multiprocessing as mp

    from flow_supervisor_tpu_torch.parallel import mesh
    from flow_supervisor_tpu_torch.training.loop import frozen_bn

    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    out = {}
    saved = (torch.get_num_threads(), torch.backends.mkldnn.enabled,
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.enabled)
    if device_type == "cpu":
        batch_invariant_cpu()
    else:
        batch_invariant_cuda(cudnn)
    with tempfile.TemporaryDirectory(prefix="fst_dryrun_") as workdir:
        t0 = time.perf_counter()
        mp.spawn(rank_fn, args=(world, tuple(kinds), device_type, backend, workdir,
                                lookup_backend, cudnn), nprocs=world)
        spawn_s = time.perf_counter() - t0
        for kind in kinds:
            cfg, weights, batch = step_case(kind, world, lookup_backend=lookup_backend)
            ref = run_step(cfg, weights, batch, device)
            runs = [torch.load(os.path.join(workdir, f"{kind}_{r}.pt")) for r in range(world)]
            lim = limits(has_census(cfg), device_type, cudnn)
            err = compare(runs[0], ref, not frozen_bn(cfg), cfg.train.lr, lim["grad_rel"])
            err["bit_for_bit"] = runs[0]["log"] == ref["log"] and all(
                torch.equal(runs[0][part][k], ref[part][k])
                for part in ("grads", "params", "stats") for k in ref[part])
            err["ranks_equal"] = all(
                torch.equal(r[part][k], runs[0][part][k])
                for r in runs[1:] for part in ("params", "stats") for k in runs[0][part])
            err.update(world=world, batch=world, device=device_type, lookup_backend=lookup_backend,
                       backend=backend or mesh.backend_for(device, world), cudnn=cudnn,
                       log=runs[0]["log"], log_one_process=ref["log"], spawn_seconds=spawn_s,
                       limits=lim)
            err["ok"] = bool(err["ranks_equal"] and within_limits(err, lim))
            out[kind] = err
    torch.set_num_threads(saved[0])
    (torch.backends.mkldnn.enabled, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled) = saved[1:]
    return out


# the space check (JAX's dryrun.py:211-223): RAFT at the einsum lookup, 2
# iterations, H = 8 * world * 2, W = 48, one pair's rows over a world of n
# ranks against one process; JAX's limit on the largest |d flow| (px)
SPACE_LIMIT = 2e-4
SPACE_W = 48


def space_case(world: int, seed: int = 1):
    """(model, image1, image2) on the CPU of the space check."""
    import numpy as np

    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

    model = RAFT(RAFTConfig(iters=2, lookup_backend="einsum"),
                 generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    shape = (1, 8 * world * 2, SPACE_W, 3)
    return (model, *(torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
                     for _ in range(2)))


def _space_rank(rank: int, world: int, device_type: str, backend, workdir: str) -> None:
    """A rank of the space check: its rows of the pair through
    ``spatial.spatial_forward``; saves the whole frame's flow."""
    from flow_supervisor_tpu_torch.parallel import mesh, spatial

    device = mesh.rank_device(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        batch_invariant_cuda()
    else:
        batch_invariant_cpu()
    mesh.init_world(world, rank, device, "file://" + os.path.join(workdir, "store"), backend)
    try:
        model, i1, i2 = space_case(world)
        up, _ = spatial.spatial_forward(model.to(device))(i1.to(device), i2.to(device))
        torch.save(up.cpu(), os.path.join(workdir, f"space_{rank}.pt"))
    finally:
        mesh.close_world()


def run_space_check(world: int, device_type: str = "cpu", backend=None) -> dict:
    """The space check over a world of ``world`` spawned ranks -> its
    largest |d flow| against one process, whether every rank holds the same
    flow, and ``ok`` (within ``SPACE_LIMIT``)."""
    import torch.multiprocessing as mp

    from flow_supervisor_tpu_torch.parallel import mesh

    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    with tempfile.TemporaryDirectory(prefix="fst_space_") as workdir:
        mp.spawn(_space_rank, args=(world, device_type, backend, workdir), nprocs=world)
        ups = [torch.load(os.path.join(workdir, f"space_{r}.pt")) for r in range(world)]
    model, i1, i2 = space_case(world)
    # the reference as the ranks run (TF32 convs alone are 3e-4 px away on the card)
    saved = (torch.get_num_threads(), torch.backends.mkldnn.enabled,
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.enabled)
    if device_type == "cpu":
        batch_invariant_cpu()
    else:
        batch_invariant_cuda()
    try:
        ref = model.to(device)(i1.to(device), i2.to(device),
                               final_flow_only=True)["flow_up"][-1]
    finally:
        torch.set_num_threads(saved[0])
        (torch.backends.mkldnn.enabled, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled) = saved[1:]
    err = float((ups[0] - ref.cpu()).abs().max())
    same = all(torch.equal(u, ups[0]) for u in ups[1:])
    return {"dryrun": "space", "world": world, "device": device_type,
            "backend": backend or mesh.backend_for(device, world), "hw": list(i1.shape[1:3]),
            "max_abs_err": err, "limit": SPACE_LIMIT, "ranks_equal": same,
            "ok": bool(same and err < SPACE_LIMIT)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--kinds", nargs="+", default=["semi"], choices=sorted(STEPS) + ["space"],
                   help="step kinds, and 'space': the space-parallel forward check")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    p.add_argument("--lookup_backend", default="auto")
    p.add_argument("--cudnn", action="store_true",
                   help="keep cuDNN's convs on the card (the one-card training path)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun needs a CUDA device; none is available (pass --device cpu)",
              file=sys.stderr)
        return 2
    steps = [k for k in args.kinds if k != "space"]
    res = (run_dryrun(args.world, steps, args.device, args.backend, args.lookup_backend,
                      args.cudnn) if steps else {})
    for kind, err in res.items():
        print(json.dumps({"dryrun": kind, **err}), flush=True)
    ok = all(e["ok"] for e in res.values())
    if "space" in args.kinds:
        space = run_space_check(args.world, args.device, args.backend)
        print(json.dumps(space), flush=True)
        ok = ok and space["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
