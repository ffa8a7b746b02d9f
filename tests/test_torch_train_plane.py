"""Training through the plane and pallas lookups (their backward is K12's
plain version on the CPU) against the einsum lookup's step on the same
weights and batch: chip_smoke.py's 64x96 Baseline step (B=2, unfrozen batch
norm) and Sintel semi step (3 iterations, fp32). The three backends compute
the same windows, so the steps must agree within chip_smoke's card-vs-CPU
parity limits (``parity_ok``), and each gradient within 1e-4 of its
variable's largest (a conv bias that a normalization by the batch's own
statistics follows, whose gradient is fp32 noise, within 1e-4 of its
weight's largest gradient)."""
import dataclasses
import json

import pytest
import torch

import chip_smoke
from flow_supervisor_tpu_torch.training.loop import frozen_bn

CPU = torch.device("cpu")
GRAD_REL = 1e-4


def _with_backend(cfg, backend):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, lookup_backend=backend))


@pytest.fixture(scope="module", params=["baseline", "semi", "unsup", "smurf"])
def einsum_step(request):
    kind = request.param
    cfg, weights, batch = chip_smoke.step_parity_setup(kind)
    ref = chip_smoke.step_outputs(_with_backend(cfg, "einsum"), weights, batch, CPU)
    return kind, cfg, weights, batch, ref


@pytest.mark.parametrize("backend", ["plane", "pallas"])
def test_step_through_the_plane_lookups_matches_the_einsum_step(einsum_step, backend):
    kind, cfg, weights, batch, ref = einsum_step
    bn_train = not frozen_bn(cfg)
    run = chip_smoke.step_outputs(_with_backend(cfg, backend), weights, batch, CPU)
    err = chip_smoke.parity_errors(run, ref, cfg.train.lr, bn_train)
    grads, want = run[1], ref[1]
    rel = {}
    for k, g in want.items():
        scale = want[k[: -len("bias")] + "weight"] if chip_smoke.noise_bias(k, bn_train) else g
        rel[k] = float((grads[k] - g).abs().max() / scale.abs().max().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    print(json.dumps({"step": kind, "backend": backend, "worst_grad": worst,
                      "grad_rel": rel[worst], **err}))
    assert rel[worst] < GRAD_REL, (worst, rel[worst])
    assert chip_smoke.parity_ok(err, kind), err
    assert run[0].keys() == ref[0].keys()
