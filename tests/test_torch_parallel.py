"""Data parallelism (parallel/mesh.py, parallel/dryrun.py) on the CPU.

- ``auto_data_parallel`` against the JAX package's on a table of batch sizes
  and device counts; ``plan_world`` with ``dcn_parallel``; the row shards.
- ``dryrun.run_dryrun`` on a gloo world of 2 spawned ranks against one
  process on the global batch (B=2, 32x48 crops of 48x64 frames, fp32): the
  chairs Baseline step with unfrozen batch norm (global batch statistics),
  the Unsup step (census: a global normalizer) and the semi step with the
  teacher SMURF loss and ``lfr_sum_reduction`` (the global B). Losses within
  1e-6 relative; each gradient within 1e-5 of its variable's largest, the
  census steps' within 1e-3 (``dryrun.CPU_CENSUS_GRAD_REL``: their fp32
  gradient is ill-conditioned and a rank's B=1 forward is not bit for bit
  the B=2 one's on the CPU); each parameter's update within 0.1 lr (1e-6)
  where its gradient lies beyond the gradient limit; running statistics
  within 1e-6 (``dryrun.LIMITS``). Every rank ends with rank 0's parameters
  and statistics, bit for bit.
- The faults the comparison exists to catch, planted in the spawned ranks:
  a census normalizer of the rank's own shard (the semi and Unsup steps)
  and ``lfr_sum_reduction`` scaled by the rank's own B (the semi step) each
  put a step outside its gradient limit.
- The loader's shards: the union of the ranks' batches is the one-process
  batch, for a supervised stage and both streams of a semi stage.
- The helpers are the identity in a world of 1.
"""
import functools
import importlib
import types

import jax
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.parallel.mesh import auto_data_parallel as jax_auto_data_parallel
from flow_supervisor_tpu_torch.config import TrainCfg
from flow_supervisor_tpu_torch.data import paths as ppaths
from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree
from flow_supervisor_tpu_torch.parallel import dryrun, mesh

KINDS = ("semi", "unsup", "baseline")
CENSUS = ("semi", "unsup")


@pytest.fixture(scope="module")
def world2():
    return dryrun.run_dryrun(2, KINDS, "cpu")


@pytest.mark.parametrize("batch", [1, 2, 3, 6, 8, 10, 12])
@pytest.mark.parametrize("devices", [1, 2, 3, 4, 8])
def test_auto_data_parallel_matches_jax(batch, devices):
    assert mesh.auto_data_parallel(batch, devices) == jax_auto_data_parallel(batch, devices)
    assert len(jax.devices()) == 8  # the virtual CPU devices of tests/conftest.py


def test_plan_world_and_shards():
    assert mesh.plan_world(8, -1, 1, 4) == 4
    assert mesh.plan_world(6, -1, 1, 4) == 3  # JAX's rule: the largest divisor
    assert mesh.plan_world(8, 2, 1, 4) == 2
    assert mesh.plan_world(8, -1, 2, 4) == 8
    with pytest.raises(ValueError, match="must divide evenly"):
        mesh.plan_world(6, -1, 2, 2)
    assert [mesh.shard_rows(6, r, 3) for r in range(3)] == [(0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError):
        mesh.shard_rows(5, 0, 2)
    batch = {"a": torch.arange(4)}
    assert mesh.shard_batch(batch, 1, 2)["a"].tolist() == [2, 3]


def test_helpers_are_the_identity_in_a_world_of_one():
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_main()
    x = torch.randn(3, requires_grad=True)
    assert mesh.all_reduce_sum(x) is x and mesh.global_mean(x) is x
    grads = {"w": torch.randn(2)}
    assert mesh.all_reduce_grads(grads) is grads
    log = {"loss": torch.tensor(1.0)}
    assert mesh.mean_log(log) is log
    assert torch.equal(mesh.shard_batch({"a": torch.arange(3)})["a"], torch.arange(3))


@pytest.mark.parametrize("kind", KINDS)
def test_world_of_two_equals_one_process_on_the_global_batch(world2, kind):
    err = world2[kind]
    print(err)
    assert err["ranks_equal"], err
    assert err["limits"] == {"loss_rel": 1e-6, "grad_rel": 1e-3 if kind in CENSUS else 1e-5,
                             "update_lr": 0.1, "stats_abs": 1e-6}
    assert err["max_rel_err_losses"] <= 1e-6, err
    assert err["max_grad_err_rel_to_largest"] <= err["limits"]["grad_rel"], err
    assert err["max_update_err_lr"] <= 0.1, err
    assert err["max_abs_err_running_stats"] <= 1e-6, err
    assert err["ok"], err


def _faulty_rank(rank, *args, fault):
    """A dry-run rank with a data-parallel reduction planted per shard."""
    from flow_supervisor_tpu_torch.losses import photometric
    from flow_supervisor_tpu_torch.training import semi

    if fault == "census_normalizer":  # the rank's own mask count
        photometric.mesh = types.SimpleNamespace(**{**vars(mesh), "global_mean": lambda x: x})
    else:  # lfr_sum_reduction by the rank's own B
        semi.mesh = types.SimpleNamespace(**{**vars(mesh), "world_size": lambda: 1})
    dryrun._rank(rank, *args)


@pytest.mark.parametrize("fault,kinds", [("census_normalizer", CENSUS), ("lfr_local_batch",
                                                                        ("semi",))])
def test_a_per_shard_reduction_fails_the_dry_run(fault, kinds):
    res = dryrun.run_dryrun(2, kinds, "cpu", rank_fn=functools.partial(_faulty_rank, fault=fault))
    for kind in kinds:
        err = res[kind]
        print(fault, kind, {k: err[k] for k in ("max_rel_err_losses",
                                                "max_grad_err_rel_to_largest", "worst_grad_var")})
        assert not err["ok"], err
        assert err["max_grad_err_rel_to_largest"] > err["limits"]["grad_rel"], err


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    root = tmp_path / "datasets"
    build_synthetic_tree(root)
    monkeypatch.setenv("FST_DATA_ROOT", str(root))
    importlib.reload(ppaths)
    yield root
    monkeypatch.undo()
    importlib.reload(ppaths)


@pytest.mark.parametrize("stage", ["chairs", "semi-sintel_unsup_test-things_unsup"])
def test_the_shards_union_is_the_one_process_batch(tree, stage):
    from flow_supervisor_tpu_torch.data.pipeline import fetch_dataloader

    cfg = TrainCfg(stage=stage, batch_size=4, image_size=(32, 48), unsup_image_size=(32, 48),
                   full_size=(40, 56), loader_workers=0, seed=9)
    loaders = [fetch_dataloader(cfg, shard=s) for s in ((0, 1), (0, 2), (1, 2))]
    try:
        for _ in range(2):
            whole, first, second = (next(ld) for ld in loaders)
            if not isinstance(whole, tuple):
                whole, first, second = (whole,), (first,), (second,)
            for w, a, b in zip(whole, first, second):
                assert w.keys() == a.keys() == b.keys()
                for k in w:
                    assert len(a[k]) == len(b[k]) == 2
                    np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), w[k])
    finally:
        for ld in loaders:
            ld.close()
