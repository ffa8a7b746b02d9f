"""tools/orbax_to_npz.py: a JAX training checkpoint (orbax) into the port.

The JAX package's ``save_checkpoint`` writes a RAFT's variables (seeded
numpy values in the tree its init gives, batch-norm statistics in [0.5,
1.5]) at steps 3 and 5; the script converts a step into the '/'-joined
``.npz`` that ``convert.load_flax_npz`` reads. Every array of the file
equals the saved variable bit for bit (the optimizer state is left out),
``--step`` picks the step and a missing step is refused; the port loads
the file through ``convert.from_flax``, and its forward (einsum lookup, 1
iteration, 32x48, fp32) equals the JAX forward on the saved variables within
the forward parity tests' 2e-3 px (tests/test_torch_port_raft.py).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from flow_supervisor_tpu.models import RAFT as JRAFT
from flow_supervisor_tpu.models import RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.training.checkpoint import save_checkpoint
from flow_supervisor_tpu_torch.convert import from_flax, load_flax_npz
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from test_torch_train_jaxstep import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48
BOUND = 2e-3  # px


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_npz", os.path.join(REPO, "tools", "orbax_to_npz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    jmodel = JRAFT(JRAFTConfig(iters=1, lookup_backend="einsum").resolved())
    variables = {step: random_variables(jmodel, seed=step, hw=(H, W)) for step in (3, 5)}
    ckpt_dir = str(tmp_path_factory.mktemp("orbax") / "run")
    for step, v in variables.items():
        save_checkpoint(ckpt_dir, step, v["params"], v["batch_stats"],
                        opt_state={"count": np.asarray(step)})
    return jmodel, variables, ckpt_dir


@pytest.mark.parametrize("step", [None, 3])
def test_npz_holds_the_saved_variables(saved, tmp_path, step):
    _, variables, ckpt_dir = saved
    out = str(tmp_path / "raft.npz")
    assert _tool().main([ckpt_dir, out] + ([] if step is None else ["--step", str(step)])) == 0
    want = flatten_dict(variables[step or 5], sep="/")
    with np.load(out) as got:
        assert set(got.files) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)
    with pytest.raises(FileNotFoundError, match="no checkpoint at step 4"):
        _tool().convert(ckpt_dir, out, step=4)


def test_port_forward_from_the_npz_matches_jax(saved, tmp_path):
    jmodel, variables, ckpt_dir = saved
    out = str(tmp_path / "raft.npz")
    _tool().convert(ckpt_dir, out)
    model = RAFT(RAFTConfig(iters=1, lookup_backend="einsum"))
    model.load_state_dict(from_flax(*load_flax_npz(out)))
    rng = np.random.default_rng(0)
    i1 = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    i2 = (np.roll(i1, (1, -2), axis=(1, 2)) * 0.9 + 0.05).astype(np.float32)
    jv = jax.tree_util.tree_map(jnp.asarray, variables[5])
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False)["flow_up"])(
        jv, jnp.asarray(i1), jnp.asarray(i2))
    got = model(torch.from_numpy(i1), torch.from_numpy(i2))["flow_up"]
    assert tuple(got.shape) == want.shape == (1, 1, H, W, 2)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    print("max |d flow|", err)
    assert err < BOUND
