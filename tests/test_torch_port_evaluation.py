"""The port's evaluation path against the JAX package's, on the CPU: the
metrics, warm start's forward splat, the ``Evaluator`` (dense with warm
start, sparse with ``pad_bucket`` 64, and a flow-supervisor model's teacher
split), standing validation in ``training.loop.train`` and the submission
writers.

One JAX model, the flow supervisor (teacher head, scanned iterations, the
einsum lookup), is built in a module fixture from a port model's random
weights (``convert_torch_raft``); the port's model takes them back through
``convert.from_flax``, so both hold the same weights. Both evaluate the same
records of ``flow_supervisor_tpu/data/synthetic.py``'s tree, its KITTI flow
rewritten with a sparse valid mask. Limits: EPE within 2e-3 px, the n-px
accuracies and Fl-all within 1e-2 (a pixel whose error sits on a threshold
may fall either side); metrics on the same arrays within 1e-6, absolute or
relative (fp32 means summed in another order).
"""
import importlib
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu import metrics as jmetrics
from flow_supervisor_tpu.convert import convert_torch_raft
from flow_supervisor_tpu.data import datasets as jD
from flow_supervisor_tpu.data import paths as jpaths
from flow_supervisor_tpu.data.synthetic import build_synthetic_tree
from flow_supervisor_tpu.evaluation import Evaluator as JEvaluator
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.utils.warm_start import forward_interpolate as jforward_interpolate
from flow_supervisor_tpu_torch import metrics
from flow_supervisor_tpu_torch.convert import from_flax
from flow_supervisor_tpu_torch.data import datasets as D
from flow_supervisor_tpu_torch.data import io as pio
from flow_supervisor_tpu_torch.data import paths
from flow_supervisor_tpu_torch.evaluation import Evaluator, eval_iters_policy, make_train_validator
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from flow_supervisor_tpu_torch.utils.warm_start import forward_interpolate

ITERS = 2
EPE_LIMIT = 2e-3  # px
SHARE_LIMIT = 1e-2


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The synthetic tree with sparse KITTI labels and a KITTI test split,
    FST_DATA_ROOT pointing at it and both packages' paths reloaded."""
    root = tmp_path_factory.mktemp("evaluation") / "datasets"
    build_synthetic_tree(root)
    rng = np.random.default_rng(0)
    occ = root / "KITTI/data_scene_flow/training/flow_occ"
    for name in sorted(os.listdir(occ)):
        raw = (64.0 * rng.normal(0, 2, (48, 64, 3)) + 2 ** 15).astype(np.uint16)
        raw[..., 2] = rng.random((48, 64)) < 0.4
        cv2.imwrite(str(occ / name), raw[..., ::-1])
    test = root / "KITTI/data_scene_flow/testing/image_2"
    test.mkdir(parents=True)
    for i in range(2):
        for t in (10, 11):
            cv2.imwrite(str(test / f"{i:06d}_{t}.png"),
                        rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FST_DATA_ROOT", str(root))
        importlib.reload(jpaths)
        importlib.reload(paths)
        yield root
    importlib.reload(jpaths)
    importlib.reload(paths)


@pytest.fixture(scope="module")
def models():
    """(JAX semi model, its variables, the port's model) with the same weights."""
    src = RAFT(RAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS),
               generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for m in src.modules():  # non-trivial batch-norm statistics
        if isinstance(m, torch.nn.BatchNorm2d):
            for t in (m.running_mean, m.running_var):
                t.data.uniform_(0.5, 1.5, generator=gen)
    sd = {("grad_" + k[len("teacher_"):] if k.startswith("teacher_update_block.") else k): v
          for k, v in src.state_dict().items()}
    params, stats = convert_torch_raft(sd, teacher=True)
    jmodel = JRAFT(JRAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS, scan_iters=True,
                               lookup_backend="einsum").resolved())
    variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
    port = RAFT(RAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS))
    port.load_state_dict(from_flax(params, stats))
    return jmodel, variables, port


@pytest.fixture(scope="module")
def jax_evaluators(models):
    jmodel, variables, _ = models
    return {"student": JEvaluator(jmodel, variables, iters=ITERS, use_teacher=False),
            "teacher": JEvaluator(jmodel, variables, iters=ITERS)}


def _check_close(got: dict, want: dict):
    metric_keys = [k for k in want if k != "pairs_per_sec"]
    assert sorted(metric_keys) == sorted(k for k in got if not k.endswith(("_per_sec", "_per_pair")))
    for k in metric_keys:
        limit = EPE_LIMIT if k.endswith("_epe") else SHARE_LIMIT
        assert abs(got[k] - want[k]) < limit, (k, got[k], want[k])
    for k in ("pairs_per_sec", "decode_ms_per_pair", "warm_start_ms_per_pair", "forward_ms_per_pair"):
        assert got[k] >= 0.0


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.normal(0, 4, (2, 12, 17, 2)).astype(np.float32)
    gt = (pred + rng.normal(0, 3, pred.shape)).astype(np.float32)
    gt[0, :2] = 0.0  # |gt| = 0: Fl-all's relative test at its 1e-12 floor
    valid = (rng.random((2, 12, 17, 1)) < 0.5).astype(np.float32)
    valid[1, 0, 0] = 0.7  # the mask counts where valid > 0.5
    tp = [torch.from_numpy(a) for a in (pred, gt, valid)]
    jp = [jnp.asarray(a) for a in (pred, gt, valid)]
    for got, want in ((metrics.dense_metrics(*tp[:2]), jmetrics.dense_metrics(*jp[:2])),
                      (metrics.sparse_metrics(*tp), jmetrics.sparse_metrics(*jp))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(metrics.epe_per_image(*tp).numpy(),
                               np.asarray(jmetrics.epe_per_image(*jp)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(metrics.angular_error(*tp[:2]).numpy(),
                               np.asarray(jmetrics.angular_error(*jp[:2])), rtol=1e-6, atol=1e-6)


def test_forward_interpolate_matches_jax():
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 3, (7, 11, 2)).astype(np.float32)
    got = forward_interpolate(flow)
    assert got.dtype == np.float32 and got.shape == flow.shape
    np.testing.assert_array_equal(got, jforward_interpolate(flow))


@pytest.mark.parametrize("kind", ["dense_warm_start", "sparse_pad64", "teacher_split"])
def test_evaluator_matches_jax(root, models, jax_evaluators, kind):
    _, _, port = models
    if kind == "sparse_pad64":
        jev = jax_evaluators["student"]
        jev.pad_bucket = 64
        try:
            want = jev.evaluate(jD.kitti(True), sparse=True)
        finally:
            jev.pad_bucket = 8
        ev = Evaluator(port, iters=ITERS, use_teacher=False, pad_bucket=64)
        port.train()  # the evaluator scores in eval mode and gives the mode back
        got = ev.evaluate(D.kitti(True), sparse=True)
        assert port.training
        port.eval()
        assert 0.0 <= got["student_fl"] <= 1.0
    else:
        teacher = kind == "teacher_split"
        jev = jax_evaluators["teacher" if teacher else "student"]
        assert jev.use_teacher == teacher
        want = jev.evaluate(jD.sintel(True, "clean"), warm_start=True)
        ev = Evaluator(port, iters=ITERS, use_teacher=None if teacher else False)
        assert ev.use_teacher == teacher
        got = ev.evaluate(D.sintel(True, "clean"), warm_start=True)
        assert ("teacher_epe" in got) == teacher and "student_epe" in got
    _check_close(got, want)


def test_submission_writers_match_jax(root, models, jax_evaluators, tmp_path):
    from flow_supervisor_tpu import submission as jsub
    from flow_supervisor_tpu.data import io as jio
    from flow_supervisor_tpu_torch import submission

    ev = Evaluator(models[2], iters=ITERS, use_teacher=False)
    jev = jax_evaluators["student"]
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    submission.create_sintel_submission(ev, str(mine / "sintel"), warm_start=True)
    jsub.create_sintel_submission(jev, str(theirs / "sintel"), warm_start=True)
    submission.create_kitti_submission(ev, str(mine / "kitti"))
    jsub.create_kitti_submission(jev, str(theirs / "kitti"))

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, n), d) for r, _, ns in os.walk(d) for n in ns)

    assert files(mine) == files(theirs)
    assert len(files(mine)) == 6  # 2 passes x 2 pairs of the one test scene, 2 KITTI pairs
    for name in files(mine):
        if name.endswith(".flo"):
            got, want = pio.read_flo(str(mine / name)), jio.read_flo(str(theirs / name))
            assert np.abs(got - want).max() < EPE_LIMIT
        else:  # 16-bit PNG: 1/64 px steps, so values near a step may land one apart
            (got, gv), (want, wv) = pio.read_flow_kitti(str(mine / name)), jio.read_flow_kitti(
                str(theirs / name))
            np.testing.assert_array_equal(gv, wv)
            assert np.abs(got - want).max() <= 1 / 64 and np.abs(got - want).mean() < EPE_LIMIT


def test_standing_validation_sets_and_policy(root, models, tmp_path, monkeypatch):
    from flow_supervisor_tpu_torch.config import ExperimentConfig, TrainCfg

    cfg = ExperimentConfig(train=TrainCfg(stage="sintel"))
    fn = make_train_validator(cfg, models[2])
    assert sorted(fn.evaluators) == ["kitti", "sintel_clean", "sintel_final"]
    assert {n: e.iters for n, e in fn.evaluators.items()} == {
        n: eval_iters_policy(n) for n in fn.evaluators} == {
        "kitti": 24, "sintel_clean": 32, "sintel_final": 32}
    assert {n: e.pad_bucket for n, e in fn.evaluators.items()} == {
        "kitti": 64, "sintel_clean": 8, "sintel_final": 8}
    assert eval_iters_policy("sintel_clean", 5) == 5
    monkeypatch.setenv("FST_DATA_ROOT", str(tmp_path / "empty"))
    importlib.reload(paths)
    try:
        assert make_train_validator(cfg, models[2]) is None
    finally:
        monkeypatch.setenv("FST_DATA_ROOT", str(root))
        importlib.reload(paths)


@pytest.mark.parametrize("skip_at_start", [False, True])
def test_train_writes_val_rows(root, tmp_path, skip_at_start):
    """Two CPU steps of the Baseline step under the default lookup (auto:
    einsum here), validating at step 0 (unless skipped), at val_step 1 and
    at the last step, one iteration, one record per set."""
    from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg
    from flow_supervisor_tpu_torch.training.loop import train

    rng = np.random.default_rng(4)
    batch = {"image1": rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32),
             "image2": rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32),
             "flow": rng.normal(0, 1, (1, 32, 48, 2)).astype(np.float32)}
    cfg = ExperimentConfig(
        ModelCfg(iters=1, compute_dtype="float32"),
        TrainCfg(stage="sintel", log_every=1, val_step=1, val_iters=1, val_max_records=1,
                 val_warm_start=True, skip_validation_at_start=skip_at_start),
        ckpt_dir=str(tmp_path))
    model, state = train(cfg, iter([batch, batch]), max_steps=2, device="cpu")
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    val = [r for r in rows if r["prefix"] == "val"]
    assert [r["step"] for r in val] == ([1, 2] if skip_at_start else [0, 1, 2])
    assert [r["step"] for r in rows if r["prefix"] == "train"] == [1, 2]
    for r in val:
        for k in ("sintel_clean_student_epe", "sintel_final_student_epe", "kitti_student_fl"):
            assert np.isfinite(r[k]), k
    assert state.step == 2
