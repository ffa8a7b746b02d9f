"""The port's extract_flow CLI on the CPU against the JAX package's forward.

A GMA model (2 heads, position and content; every aggregator's gamma 0.5)
with seeded variables in the JAX model's own tree is carried into a port
checkpoint directory (``args.yaml``, ``ckpt_1.pt`` of ``convert.from_flax``).
Three 48x64 ``.jpg`` frames written by the port's encoder (a smooth image
moving by (1, 2) px a frame) go through ``python -m
flow_supervisor_tpu_torch.extract_flow <dir> --source_dirs ... --eval_iters
2 --device cpu``; the JAX package's ``Evaluator._run_pair`` on the same
variables and frames (decoded by cv2) and its ``visualize_flow`` are what
the root ``extract_flow.py`` writes. Limits: flows within 2e-3 px (the
forward's golden bound), the visualisation within 2/255.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from flow_supervisor_tpu.data import io as jio  # noqa: E402
from flow_supervisor_tpu.evaluation import Evaluator as JEvaluator  # noqa: E402
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig  # noqa: E402
from flow_supervisor_tpu.utils.viz import visualize_flow as jvisualize_flow  # noqa: E402
from flow_supervisor_tpu_torch import extract_flow  # noqa: E402
from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg  # noqa: E402
from flow_supervisor_tpu_torch.convert import from_flax  # noqa: E402
from flow_supervisor_tpu_torch.data import io as pio  # noqa: E402
from flow_supervisor_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from test_torch_train_jaxstep import random_variables  # noqa: E402

ITERS = 2
FLOW_LIMIT = 2e-3  # px
VIS_LIMIT = 2  # of 255
GMA = dict(num_heads=2, position_and_content=True)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    base = tmp_path_factory.mktemp("extract")
    frames = base / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    low = rng.uniform(0, 255, (10, 12, 3)).astype(np.float32)
    big = cv2.resize(low, (80, 60), interpolation=cv2.INTER_CUBIC)
    for i in range(3):
        img = np.clip(big[2 + i: 50 + i, 4 + 2 * i: 68 + 2 * i], 0, 255).astype(np.uint8)
        pio.write_jpeg(str(frames / f"{i:05d}.jpg"), img)
    jmodel = JRAFT(JRAFTConfig(iters=ITERS, gma=True, lookup_backend="einsum", scan_iters=True,
                               **GMA).resolved())
    variables = random_variables(jmodel, seed=5)
    run = str(base / "run")
    cfg = ExperimentConfig(ModelCfg(model_type="gma-baseline", iters=ITERS, **GMA), ckpt_dir=run)
    cfg.save_yaml()
    ckpt.save_checkpoint(run, 1, from_flax(variables["params"], variables["batch_stats"]))
    ev = JEvaluator(jmodel, jax.tree_util.tree_map(jnp.asarray, variables), iters=ITERS)
    names = sorted(os.listdir(frames))
    want = []
    for a, b in zip(names, names[1:]):
        res, _ = ev._run_pair(ev.variables, jio.read_image(str(frames / a)),
                              jio.read_image(str(frames / b)), "sintel", None)
        want.append((a, np.asarray(res["student"])[0]))
    return str(frames), run, want


def test_extract_flow_cli_matches_jax(case, tmp_path):
    frames, run, want = case
    out = str(tmp_path / "out")
    assert extract_flow.main([run, "--source_dirs", frames, "--target_dirs", out,
                              "--eval_iters", str(ITERS), "--device", "cpu"]) == 0
    assert sorted(os.listdir(os.path.join(out, "flo"))) == [n + ".flo" for n, _ in want]
    assert sorted(os.listdir(os.path.join(out, "vis"))) == [n + "_flow.png" for n, _ in want]
    for name, jflow in want:
        flow = pio.read_flo(os.path.join(out, "flo", name + ".flo"))
        assert flow.shape == jflow.shape == (48, 64, 2)
        d = np.abs(flow - jflow).max()
        vis = pio.read_png(os.path.join(out, "vis", name + "_flow.png"))
        jvis = (jvisualize_flow(jflow) * 255).astype(np.uint8)
        dv = np.abs(vis.astype(np.int32) - jvis).max()
        print(f"{name}: flow max |port - JAX| {d:.2e} px (|flow| up to "
              f"{np.abs(jflow).max():.2f}), vis {dv}/255")
        assert d <= FLOW_LIMIT and dv <= VIS_LIMIT
        assert np.abs(jflow).max() > 0.1  # the flow is not trivially zero


def test_extract_flow_cli_with_random_weights_and_two_directories(case, tmp_path):
    """No ckpt_dir: the default config's model with random weights; each
    source directory writes into its own target."""
    frames, _, want = case
    outs = [str(tmp_path / "a"), str(tmp_path / "b")]
    assert extract_flow.main(["--source_dirs", frames, frames, "--target_dirs", *outs,
                              "--eval_iters", "1", "--device", "cpu"]) == 0
    flows = [pio.read_flo(os.path.join(o, "flo", want[0][0] + ".flo")) for o in outs]
    assert np.isfinite(flows[0]).all() and np.array_equal(flows[0], flows[1])
    assert extract_flow.main(["--source_dirs", frames, "--target_dirs", *outs,
                              "--device", "cpu"]) == 2
