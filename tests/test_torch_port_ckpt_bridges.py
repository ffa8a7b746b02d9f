"""The port's checkpoint bridges on the CPU: ``tf_bundle`` (the TensorFlow
tensor-bundle reader in numpy) against ``tf.train.load_checkpoint`` on
checkpoints that TensorFlow writes here, ``convert.load_tf_checkpoint``
against the JAX package's ``load_tf_checkpoint`` then ``from_flax``, and
``convert.load_torch_checkpoint`` on reference-style ``.pth`` files.

The TF checkpoints hold the reference's variable paths (the Keras attribute
graph of tests/test_tf_convert.py) for a RAFT with and without the flow
supervisor's teacher head, the values a port model's weights carried over
by the JAX package's ``convert_torch_raft``: about 200 variables, whose
index is one table block, so a checkpoint of 1,600 long names checks the
walk over several data blocks. Everything must agree bit for bit.
"""
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from flow_supervisor_tpu import convert as jconvert  # noqa: E402
from flow_supervisor_tpu_torch import convert, tf_bundle  # noqa: E402
from flow_supervisor_tpu_torch.convert import from_flax  # noqa: E402
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig  # noqa: E402
from test_tf_convert import (  # noqa: E402
    _flax_path, _Node, _set_path, _tf_paths_for_encoder, _tf_paths_for_update_block)
from test_torch_train_jaxstep import port_model  # noqa: E402


def reference_tf_paths(teacher: bool) -> list[str]:
    return (_tf_paths_for_encoder("fnet", batch_norm=False)
            + _tf_paths_for_encoder("cnet", batch_norm=True)
            + _tf_paths_for_update_block("update_block")
            + (_tf_paths_for_update_block("teacher_update_block") if teacher else []))


def write_reference_tf_checkpoint(prefix: str, model: RAFT) -> dict:
    """The port model's weights as a reference TF object-graph checkpoint
    (``tf.train.Checkpoint(model=...)``) at prefix -> {TF path: value}."""
    sd = {("grad_" + k[len("teacher_"):] if k.startswith("teacher_update_block.") else k):
          v.detach().numpy() for k, v in model.state_dict().items()}
    params, stats = jconvert.convert_torch_raft(sd, teacher=model.cfg.teacher)
    tree = {"params": params, "batch_stats": stats}
    root, values = _Node(), {}
    for path in reference_tf_paths(model.cfg.teacher):
        node = tree
        for k in _flax_path(path):
            node = node[k]
        values[path] = np.asarray(node, np.float32)
        _set_path(root, path, values[path])
    tf.train.Checkpoint(model=root).write(prefix)
    return values


@pytest.fixture(scope="module", params=["teacher", "baseline"])
def tf_checkpoint(request, tmp_path_factory):
    teacher = request.param == "teacher"
    model = port_model(teacher=teacher, freeze_bn=True, seed=3)
    prefix = str(tmp_path_factory.mktemp("tf") / "ckpt-100000-weights")
    values = write_reference_tf_checkpoint(prefix, model)
    return prefix, values, model


def _data_blocks(index_path: str) -> int:
    """The number of data blocks the index block of a bundle's index names."""
    import struct

    with open(index_path, "rb") as f:
        data = f.read()
    footer = data[-48:]
    assert struct.unpack_from("<Q", footer, 40)[0] == 0xDB4775248B80FB57
    _, pos = tf_bundle._varint(footer, 0)
    _, pos = tf_bundle._varint(footer, pos)
    off, pos = tf_bundle._varint(footer, pos)
    size, _ = tf_bundle._varint(footer, pos)
    return len(list(tf_bundle._entries(tf_bundle._block(data, off, size, index_path))))


def test_tf_bundle_equals_tensorflows_reader(tf_checkpoint):
    prefix, values, _ = tf_checkpoint
    mine = tf_bundle.BundleReader(prefix)
    theirs = tf.train.load_checkpoint(prefix)
    shapes = theirs.get_variable_to_shape_map()
    dtypes = theirs.get_variable_to_dtype_map()
    assert set(mine.get_variable_to_shape_map()) | set(mine.string_keys) == set(shapes)
    assert mine.string_keys == ["_CHECKPOINTABLE_OBJECT_GRAPH"]
    assert len(mine.entries) >= len(values) >= 150
    print(f"RAFT index: {_data_blocks(prefix + '.index')} data block(s)")
    for name, shape in mine.get_variable_to_shape_map().items():
        got, want = mine.get_tensor(name), theirs.get_tensor(name)
        assert shape == shapes[name] and got.dtype == dtypes[name].as_numpy_dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for path, value in values.items():
        np.testing.assert_array_equal(
            mine.get_tensor(f"model/{path}/.ATTRIBUTES/VARIABLE_VALUE"), value, err_msg=path)


def test_tf_bundle_walks_every_data_block(tmp_path):
    """A whole RAFT's index is one data block (about 47 KB: TensorFlow's
    table blocks are larger); 1,600 variables of 200-character names (keys
    that share little, so prefix compression keeps them long) make
    TensorFlow write several, and the reader reads them all."""
    import hashlib

    root = _Node()
    for i in range(1600):
        name = f"n{i:05d}" + hashlib.sha256(str(i).encode()).hexdigest() * 3
        setattr(root, name, tf.Variable(np.float32(i)))
    many = str(tmp_path / "ckpt-1")
    tf.train.Checkpoint(model=root).write(many)
    blocks = _data_blocks(many + ".index")
    print(f"1,600 long names: {blocks} data blocks")
    assert blocks > 1
    mine, theirs = tf_bundle.BundleReader(many), tf.train.load_checkpoint(many)
    names = set(theirs.get_variable_to_shape_map()) - {"_CHECKPOINTABLE_OBJECT_GRAPH"}
    assert set(mine.get_variable_to_shape_map()) == names and len(names) >= 1600
    for name in names:
        assert mine.get_tensor(name) == theirs.get_tensor(name), name


def test_tf_bundle_reads_each_dtype(tmp_path):
    """float32, float16, int32 and int64 as TensorFlow reads them; another
    dtype raises when read, not when listed."""
    rng = np.random.default_rng(0)
    root = _Node()
    for i, dt in enumerate((np.float32, np.float16, np.int32, np.int64)):
        shape = [(), (3,), (2, 5), (1, 2, 3)][i]
        setattr(root, f"v{i}", tf.Variable(rng.normal(0, 100, shape).astype(dt)))
    root.d = tf.Variable(rng.normal(0, 1, (4, 1)))  # float64
    prefix = str(tmp_path / "ckpt-1")
    tf.train.Checkpoint(model=root).write(prefix)
    mine, theirs = tf_bundle.BundleReader(prefix), tf.train.load_checkpoint(prefix)
    assert set(mine.get_variable_to_shape_map()) == set(
        theirs.get_variable_to_shape_map()) - {"_CHECKPOINTABLE_OBJECT_GRAPH"}
    for name in mine.get_variable_to_shape_map():
        if "model/d/" in name:
            with pytest.raises(ValueError, match="dtype 2"):
                mine.get_tensor(name)
            continue
        got, ref = mine.get_tensor(name), theirs.get_tensor(name)
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="magic"):
        tf_bundle.read_index(prefix + ".data-00000-of-00001")


def test_load_tf_checkpoint_equals_jax_then_from_flax(tf_checkpoint):
    """Bit for bit: the port's state dict of the TF checkpoint equals
    ``from_flax(*flow_supervisor_tpu.convert.load_tf_checkpoint(prefix))``
    and the port model's own weights, and loads strictly into the port's
    RAFT of that kind (the teacher head detected)."""
    prefix, _, model = tf_checkpoint
    got = convert.load_tf_checkpoint(prefix)
    want = from_flax(*jconvert.load_tf_checkpoint(prefix))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    teacher = model.cfg.teacher
    assert any(k.startswith("teacher_update_block.") for k in got) == teacher
    fresh = RAFT(RAFTConfig(teacher=teacher))
    fresh.load_state_dict(got)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k


# ---- reference PyTorch checkpoints -------------------------------------------

_PTH_MODELS = {
    "raft_semi": dict(teacher=True),
    "gma_semi_position_and_content": dict(teacher=True, gma=True, num_heads=2,
                                          position_and_content=True),
    "small_baseline": dict(small=True),
}


def _reference_pth(model: RAFT, path: str, wrap_model_key: bool) -> None:
    """The model's state dict as the reference's PyTorch code saves it:
    DataParallel's ``module.`` prefix, the teacher as ``grad_update_block``."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("teacher_update_block."):
            k = "grad_update_block." + k[len("teacher_update_block."):]
        sd["module." + k] = v.clone()
    torch.save({"model": sd, "step": 7} if wrap_model_key else sd, path)


@pytest.mark.parametrize("wrap_model_key", [False, True], ids=["bare", "model_key"])
@pytest.mark.parametrize("kind", sorted(_PTH_MODELS))
def test_load_torch_checkpoint_round_trips(kind, wrap_model_key, tmp_path):
    model = RAFT(RAFTConfig(**_PTH_MODELS[kind]), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():  # gamma off its initial zero, as a trained GMA's is
        for name, p in model.named_parameters():
            if name.endswith("aggregator.gamma"):
                p.fill_(0.5)
    path = str(tmp_path / "model.pth")
    _reference_pth(model, path, wrap_model_key)
    got = convert.load_torch_checkpoint(path)
    want = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    RAFT(RAFTConfig(**_PTH_MODELS[kind])).load_state_dict(got)


@pytest.mark.parametrize("gma", [False, True], ids=["raft_semi", "gma_semi"])
def test_load_torch_checkpoint_agrees_with_jax_where_jax_maps(gma, tmp_path):
    """On every key the JAX package's ``load_torch_checkpoint`` maps (then
    ``from_flax``), the port's loader gives the same values; the port maps
    every key of the file."""
    model = RAFT(RAFTConfig(teacher=True, gma=gma), generator=torch.Generator().manual_seed(6))
    path = str(tmp_path / "model.pth")
    _reference_pth(model, path, wrap_model_key=True)
    got = convert.load_torch_checkpoint(path)
    want = from_flax(*jconvert.load_torch_checkpoint(path, teacher=True, gma=gma))
    assert set(want) <= set(got) == set(model.state_dict())
    for k in want:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
