"""The benchmark's FLOP and byte counts: against torch's FlopCounterMode on
the reference at a small size, and against hand counts of one conv and one
lookup."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from flowbench import frames, program, registry, weights
from flowbench.counts import flops, lookup
from flowbench.reference.raft import Raft
from flowbench.tests.test_flowbench_faults import bench_cell


def volume_flops(b, h8, w8, c=256, levels=4):
    """The reference's all-pairs volumes, which the counts leave out."""
    return sum(2 * b * h8 * w8 * h2 * w2 * c for h2, w2 in lookup.level_shapes(h8, w8, levels))


def masters(config: str, teacher: bool):
    cfg = registry.cell(f"{config}.infer.b32").config
    t = {"iters": 1, "dtype": "float32", "lookup_backend": "einsum", "teacher": teacher}
    model = program.inference_model(cfg, t, "cpu")
    return weights.make(model.state_dict(), 1, "cpu", cfg["model"].get("gamma")), cfg["model"]


@pytest.mark.parametrize("config", ["raft", "gma"])
def test_the_forward_count_is_flop_counters(config):
    p, m = masters(config, teacher=True)
    img1, img2, _ = frames.pairs(frames.generator(2, "cpu"), 2, 64, 96, 2.0, "cpu")
    ref = Raft(p, gma=m["gma"])
    with FlopCounterMode(display=False) as fc:
        ref.forward(img1, img2, 3)
    assert fc.get_total_flops() == 2 * flops.forward(64, 96, 3, m["gma"]) + volume_flops(2, 8, 12)
    with FlopCounterMode(display=False) as fc:
        ref.teacher_split(img1, img2, 3, 2)
    assert fc.get_total_flops() == (2 * flops.forward(64, 96, 3, m["gma"], teacher_iters=2)
                                    + volume_flops(2, 8, 12))


def test_the_semi_step_count_is_near_flop_counters():
    """The count takes every backward as twice its forward; torch counts
    the first convs' backward (no input gradient) once, and the volumes'
    products, which the count leaves out."""
    from flowbench.runners import train
    from flowbench.reference.semi import SemiStep

    cell = bench_cell("raft.train.semi.b8")
    t = dict(cell.traffic, batch=2, full_hw=[64, 128], sup_hw=[48, 96], unsup_hw=[56, 64],
             iters=2, teacher_iters=2)
    p, m = masters("raft", teacher=True)
    sup, unsup = train.step_batches(frames.generator(3, "cpu"), t, "cpu")
    step = SemiStep(p, {"iters": 2, "teacher_iters": 2, "gamma": 0.8, "lfl_decay": 1.0}, False)
    with FlopCounterMode(display=False) as fc:
        step.grads(sup, unsup)
    count = flops.semi_step(2, t["sup_hw"], t["unsup_hw"], t["full_hw"], 2, 2, False)
    vols = (3 * volume_flops(2, 6, 12) + volume_flops(2, 8, 16)
            + 2 * (3 * volume_flops(2, 7, 8) + volume_flops(2, 8, 16)))
    assert abs(fc.get_total_flops() - vols - count) / count < 0.05


def test_a_conv_by_hand():
    # fnet's stem at 448x1024: 7x7, 3 -> 64 channels, stride 2 onto 224x512
    assert flops.conv(3, 64, 7, 7, 224, 512) == 2 * 3 * 64 * 49 * 224 * 512
    conv = torch.nn.Conv2d(3, 64, 7, 2, 3, bias=False)
    with FlopCounterMode(display=False) as fc:
        conv(torch.zeros(1, 3, 448, 1024))
    assert fc.get_total_flops() == flops.conv(3, 64, 7, 7, 224, 512)


def test_a_lookup_by_hand():
    """One query at (0, 0) of a 16x16 map, radius 4: 6 x 6 of its 10 x 10
    support taps lie in the map; one in the middle reads all 100."""
    shapes = [(16, 16)]
    assert lookup.support_taps(torch.tensor([[0.0, 0.0]]), shapes, 4) == 36
    assert lookup.support_taps(torch.tensor([[8.5, 7.25]]), shapes, 4) == 100
    assert lookup.support_taps(torch.tensor([[1e9, -3e38]]), shapes, 4) == 0
    nbytes, ops = lookup.work(1, 100, 256, shapes, 4, "bfloat16")
    # f1 row, the map, the coords, 81 outputs; 100 dot products of 256, 81 combines
    assert nbytes == 256 * 2 + 256 * 256 * 2 + 8 + 81 * 2
    assert ops == 2 * 256 * 100 + 7 * 81
    nbytes, ops = lookup.work(1, 100, 256, shapes, 4, "bfloat16", backward=True)
    assert nbytes == 256 * 2 + 256 * 256 * 2 + 8 + 81 * 2 + 256 * 2 + 256 * 256 * 4
    assert ops == 4 * 256 * 100 + 7 * 81
    assert lookup.least_seconds(3.35e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert lookup.least_seconds(0.0, 67e12, "float32") == pytest.approx(1.0)


def test_level_shapes_are_same_pooling():
    assert lookup.level_shapes(55, 128, 4) == [(55, 128), (28, 64), (14, 32), (7, 16)]
    assert lookup.level_shapes(50, 90, 4) == [(50, 90), (25, 45), (13, 23), (7, 12)]
    f = torch.zeros(1, 50, 90, 1)
    from flowbench.reference.raft import same_pool

    assert [tuple(same_pool(f, 2 ** lvl).shape[1:3]) for lvl in range(4)] == \
        lookup.level_shapes(50, 90, 4)
