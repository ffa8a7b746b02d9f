"""The plain reference held against the port's plain path on the CPU, in
float32 at a small size, so the frozen copy is known faithful: RAFT and GMA
forwards, the Evaluator's padding, warm start and teacher split, and the
semi step's losses, gradients and update."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from flowbench import frames, program, registry, weights
from flowbench.reference.raft import Raft
from flowbench.tests.test_flowbench_faults import bench_cell
from flowbench.reference.warm_start import forward_interpolate


def small_model(config: str, teacher: bool = False):
    cfg = registry.cell(f"{config}.infer.b32").config
    t = {"iters": 3, "dtype": "float32", "lookup_backend": "einsum", "teacher": teacher,
         "teacher_iters": 2}
    model = program.inference_model(cfg, t, "cpu")
    masters = weights.make(model.state_dict(), 11, "cpu", cfg["model"].get("gamma"))
    weights.load(model, masters)
    return model, masters, cfg["model"]


@pytest.mark.parametrize("config", ["raft", "gma"])
def test_the_forward_equals_the_ports(config):
    model, masters, m = small_model(config)
    img1, img2, _ = frames.pairs(frames.generator(3, "cpu"), 2, 64, 96, 3.0, "cpu")
    init = torch.randn(2, 8, 12, 2, generator=torch.Generator().manual_seed(4))
    got = model(img1, img2, flow_init=init, iters=3, final_flow_only=True)["flow_up"][-1]
    want = Raft(masters, gma=m["gma"]).forward(img1, img2, 3, init)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    assert want.abs().mean() > 0.05


@pytest.mark.parametrize("config", ["raft", "gma"])
def test_the_evaluation_split_equals_the_evaluators(config):
    """Pad 60x96 to 64x96 (replicate edges, centred), student, teacher from
    its final state, unpad; the warm start from its low flow."""
    from flowbench.reference.raft import pad_sintel, unpad

    model, masters, m = small_model(config, teacher=True)
    ev = program.evaluator(model, {"iters": 3, "teacher": True, "pad_bucket": 8})
    scene = frames.scene(frames.generator(5, "cpu"), 3, 60, 96, 1.5, "cpu").numpy()
    ref = Raft(masters, gma=m["gma"])
    low = None
    for j in range(2):
        init = None if low is None else program.warm_start()(low)
        results, low = ev.predict(scene[j], scene[j + 1], "sintel", init)
        ref_init = None if j == 0 else forward_interpolate(prev)
        if j:
            assert np.array_equal(ref_init, init)
        x1, spec = pad_sintel(torch.from_numpy(scene[j])[None], 8)
        x2, _ = pad_sintel(torch.from_numpy(scene[j + 1])[None], 8)
        stu, tea, ref_low = ref.teacher_split(
            x1, x2, 3, 2, None if ref_init is None else torch.from_numpy(ref_init)[None])
        np.testing.assert_allclose(results["student"], unpad(stu, spec).numpy(), atol=2e-5)
        np.testing.assert_allclose(results["teacher"], unpad(tea, spec).numpy(), atol=2e-5)
        np.testing.assert_allclose(low, ref_low[0].numpy(), atol=2e-5)
        prev = low


def test_the_semi_step_equals_the_ports():
    """Three set-up steps and two of the window of the port's semi step
    (float32, einsum lookup) against the reference's: each step's losses,
    the first gradient's norm and direction and the parameters' change's
    norm, leaf by leaf."""
    from flowbench.runners import train

    cell = bench_cell("raft.train.semi.b8")
    t = dict(cell.traffic, batch=2, full_hw=[64, 128], sup_hw=[48, 96], unsup_hw=[56, 64],
             iters=2, teacher_iters=2, pool_steps=5, dtype="float32", lookup_backend="einsum")
    run = train.Run(dataclasses.replace(cell, traffic=t), 7, "cpu")
    assert run.window(0.0)["attempted"] == t["window_check_steps"]
    run.release()
    got = run.check()
    assert got["sup_loss_gap_rel"] < 1e-5 and got["unsup_loss_gap_rel"] < 1e-5
    assert got["grad_norm_gap"] < 1e-3 and got["grad_cos_gap"] < 1e-6
    assert got["change_norm_gap"] < 1e-4
