"""The port's training-data path (data/pipeline.py, data/synthetic.py)
against the JAX package's on one synthetic tree written by the port's
writers: ``stage_records`` for every stage of the JAX registry, and
``fetch_dataloader``'s batches with 0 and 2 loader workers for the chairs,
things, sintel_unsup_test and semi-sintel_unsup_test-things_unsup stages
and for sintel_multiframe (whose batches no train step reads). Both
packages read the same files (the JAX package through cv2, with its native
reader off: it scales .ppm by 1/255 where cv2 divides).

Limits as in tests/test_torch_port_augment.py: images within 1e-5, flows
within 1e-4 px, valid masks and crop offsets exactly. Then the Prefetcher
(errors raised by the consumer's next(), the end of a finite stream, close)
and a refused (progressive) JPEG frame's error through the davis_unsup
loader."""
import importlib
import inspect
import re
import threading
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from flow_supervisor_tpu import config as jconfig  # noqa: E402
from flow_supervisor_tpu.data import paths as jpaths  # noqa: E402
from flow_supervisor_tpu.data import pipeline as jpipeline  # noqa: E402
from flow_supervisor_tpu_torch import config as pconfig  # noqa: E402
from flow_supervisor_tpu_torch.data import paths as ppaths  # noqa: E402
from flow_supervisor_tpu_torch.data import pipeline as ppipeline  # noqa: E402
from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree  # noqa: E402

IMAGE_TOL = 1e-5
FLOW_TOL = 1e-4

# every stage of the JAX registry (checked against its source below)
STAGES = ["chairs", "things", "things_unsup", "sintel_unsup_test", "sintel_unsup_train",
          "kitti_unsup_test", "kitti_unsup", "kitti2015_unsup", "sintel_unsup_labeled_train",
          "sintel_unsup_part1", "sintel_unsup_part2", "sintel_multiframe", "hd1k",
          "chairs_unsup", "ctskh", "davis_unsup"]


def _point_both_at(root, monkeypatch):
    monkeypatch.setenv("FST_DATA_ROOT", str(root))
    monkeypatch.setenv("FST_NATIVE_IO", "0")
    importlib.reload(jpaths)
    importlib.reload(ppaths)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data") / "datasets"
    build_synthetic_tree(root, chairs_pairs=4)
    return root


@pytest.fixture()
def root(tree, monkeypatch):
    _point_both_at(tree, monkeypatch)
    yield tree
    monkeypatch.undo()
    importlib.reload(jpaths)
    importlib.reload(ppaths)


def test_stage_list_is_the_jax_registry():
    src = inspect.getsource(jpipeline.stage_records)
    named = set(re.findall(r'stage == "([a-z0-9_]+)"', src))
    for group in re.findall(r"stage in \(([^)]*)\)", src):
        named |= set(re.findall(r'"([a-z0-9_]+)"', group))
    assert named == set(STAGES)


def _record_tuple(r):
    return (r.images, r.flow, r.sparse, r.extra, r.canonical_size)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_records_match_jax(root, stage):
    got, got_aug = ppipeline.stage_records(stage)
    want, want_aug = jpipeline.stage_records(stage)
    assert [_record_tuple(r) for r in got] == [_record_tuple(r) for r in want]
    assert got_aug == want_aug
    if stage in ("chairs", "things", "sintel_unsup_test", "sintel_multiframe", "ctskh",
                 "davis_unsup", "hd1k", "kitti_unsup_test"):
        assert got, stage  # the tree holds this stage's files


def test_unknown_stage_raises():
    with pytest.raises(NotImplementedError):
        ppipeline.stage_records("no_such_stage")


def _check(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (where, k)
        if "valid" in k or k == "crop_yx":
            assert g.dtype == w.dtype and np.array_equal(g, w), (where, k)
        else:
            tol = FLOW_TOL if "flow" in k else IMAGE_TOL
            assert np.abs(g - w).max() <= tol, (where, k)


# stage -> TrainCfg fields (image sizes fit the tree's 48x64 frames; the semi
# stage's full_size is larger than the frames, so its streams upscale first)
LOADER_CASES = {
    "chairs": dict(image_size=(32, 48), batch_size=2),
    "things": dict(image_size=(32, 40), batch_size=2),
    "sintel_unsup_test": dict(image_size=(24, 40), full_size=(40, 56), batch_size=2),
    "semi-sintel_unsup_test-things_unsup": dict(image_size=(32, 48), unsup_image_size=(24, 40),
                                                full_size=(56, 72), batch_size=1),
    "sintel_multiframe": dict(image_size=(32, 48), batch_size=2),
}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("stage", list(LOADER_CASES))
def test_fetch_dataloader_matches_jax(root, stage, workers):
    fields = dict(LOADER_CASES[stage], stage=stage, loader_workers=workers, seed=5)
    got_it = ppipeline.fetch_dataloader(pconfig.TrainCfg(**fields))
    want_it = jpipeline.fetch_dataloader(jconfig.TrainCfg(**fields))
    try:
        for i in range(3):
            got, want = next(got_it), next(want_it)
            if stage.startswith("semi-"):
                assert isinstance(got, tuple) and len(got) == 2
                _check(got[0], want[0], (stage, i, "sup"))
                _check(got[1], want[1], (stage, i, "unsup"))
                assert got[0]["orig_image1"].shape == (1, 56, 72, 3)
            else:
                _check(got, want, (stage, i))
    finally:
        got_it.close()
        want_it.close()


def test_loader_stream_is_the_same_for_any_worker_count(root):
    """The serial loader and a 3-thread one give the same batches."""
    fields = dict(LOADER_CASES["chairs"], stage="chairs", seed=9)
    its = [ppipeline.fetch_dataloader(pconfig.TrainCfg(**fields, loader_workers=w)) for w in (0, 3)]
    try:
        for _ in range(4):
            a, b = (next(it) for it in its)
            assert sorted(a) == sorted(b)
            assert all(np.array_equal(a[k], b[k]) for k in a)
    finally:
        for it in its:
            it.close()


def test_resolve_full_size_matches_jax():
    assert ppipeline.FULL_SIZE_DEFAULTS == jpipeline.FULL_SIZE_DEFAULTS
    for stage in STAGES + ["unknown"]:
        assert ppipeline.resolve_full_size(stage, None) == jpipeline.resolve_full_size(stage, None)
    assert ppipeline.resolve_full_size("chairs", [432, 1024]) == (432, 1024)


def test_prefetcher_raises_the_iterators_error():
    def items():
        yield 1
        yield 2
        raise KeyError("bad record")

    p = ppipeline.Prefetcher(items())
    assert next(p) == 1 and next(p) == 2
    for _ in range(2):  # the error, and again on a later call
        with pytest.raises(KeyError, match="bad record"):
            next(p)
    p.close()
    assert not p.t.is_alive()


def test_prefetcher_ends_a_finite_stream_and_closes():
    assert list(ppipeline.Prefetcher(iter(range(6)), depth=2)) == list(range(6))

    def forever():
        i = 0
        while True:
            yield i
            i += 1

    p = ppipeline.Prefetcher(forever(), depth=2)
    assert next(p) == 0
    deadline = time.time() + 5
    while not p.q.full() and time.time() < deadline:  # the producer blocks on a full queue
        time.sleep(0.01)
    p.close()
    p.t.join(timeout=5)
    assert not p.t.is_alive()
    assert p.t not in threading.enumerate()


@pytest.mark.parametrize("workers", [0, 2])
def test_jpeg_frame_error_reaches_the_loader(tmp_path, monkeypatch, workers):
    """davis_unsup lists JPEG frames: the record lists equal the JAX
    package's, and with progressive JPEG frames (which the decoder refuses)
    the first next() of the port's loader raises the reader's error (no
    skipped record, no empty batch)."""
    root = tmp_path / "datasets"
    scene = root / "DAVIS/JPEGImages/480p/bear"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(scene / f"{i:05d}.jpg"), rng.integers(0, 256, (48, 64, 3)).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    _point_both_at(root, monkeypatch)
    try:
        got, _ = ppipeline.stage_records("davis_unsup")
        want, _ = jpipeline.stage_records("davis_unsup")
        assert [_record_tuple(r) for r in got] == [_record_tuple(r) for r in want]
        assert len(got) == 4
        loader = ppipeline.fetch_dataloader(pconfig.TrainCfg(
            stage="davis_unsup", image_size=(24, 40), full_size=(40, 56), batch_size=1,
            loader_workers=workers))
        with pytest.raises(ValueError, match="progressive JPEG"):
            next(loader)
        loader.close()
    finally:
        monkeypatch.undo()
        importlib.reload(jpaths)
        importlib.reload(ppaths)
