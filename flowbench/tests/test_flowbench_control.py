"""On the card, at each cell's own size: the numbers the check compares for
sound runs of the program over many seeds (each after a short window at
the cell's load) and for the control, the reference in the precision
below the cell's (float8 for bfloat16, TF32 for float32), over three. The
control has to come out not correct, the program correct. Each reading is
printed as a JSON line, the limits were set from them (PERF.md).

    python -m pytest -s flowbench/tests/test_flowbench_control.py [-k <cell>]

The training cell also reads its faults on the card (the
half batch and the altered loss of test_flowbench_faults.py), each over the
control's seeds: each has to fail one number."""
from __future__ import annotations

import json

import pytest

from flowbench import registry
from flowbench.tests.test_flowbench_faults import altered_loss, bench_cell, half_train_batch

CELLS = ("raft.infer.b32", "gma.infer.b32", "raft.eval.sintel.fp32", "raft.train.semi.b8")
WINDOW_S = 3.0
PROGRAM_SEEDS, CONTROL_SEEDS = 12, 3
FAULTS = {"raft.train.semi.b8": (half_train_batch, altered_loss)}


def readings(cell, seed: int, device, control: bool) -> dict:
    run = registry.runner(cell.traffic["runner"]).Run(cell, seed, device)
    run.window(WINDOW_S)
    run.release()
    return run.check(control=control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(name, cuda_device):
    cell = bench_cell(name)
    kinds = [("control", None, range(CONTROL_SEEDS))]
    kinds += [(f"fault:{f.__name__}", f, range(CONTROL_SEEDS)) for f in FAULTS.get(name, ())]
    kinds += [("program", None, range(PROGRAM_SEEDS))]
    failures = []
    for n, (kind, fault, seeds) in enumerate(kinds):
        for i in seeds:
            seed = 4_000_000_000 + 1000 * CELLS.index(name) + 100 * n + i
            with pytest.MonkeyPatch.context() as mp:
                if fault is not None:
                    fault(mp)
                got = readings(cell, seed, cuda_device, kind == "control")
            print(json.dumps({"cell": name, "kind": kind, "seed": seed, "numbers": got}),
                  flush=True)
            within = all(got[k] <= limit for k, limit in cell.limits.items())
            if within == (kind != "program"):
                failures.append((kind, seed, got))
    assert not failures, failures
