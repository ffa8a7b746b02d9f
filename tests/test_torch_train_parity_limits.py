"""The limits of chip_smoke.py's card-vs-CPU train step (phase 5), measured
on the CPU. The fp32 semi step is chaotic at rounding scale, so the limits
must pass the same step from weights scaled by 1 + 2^-24 * N(0, 1) (the
spread the card's other rounding can cause), and must fail a step whose K8
or K9 drops one query's lookup cotangent (the smallest fault the step-level
check is there to catch; the kernel checks of phase 1 hold K8/K9 to the
plain versions far tighter). Run with ``-s`` to print what each case reads."""
import json

import pytest
import torch

import chip_smoke
from flow_supervisor_tpu_torch.kernels import corr_fused

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def parity():
    cfg, weights, batch = chip_smoke.step_parity_setup("semi")
    ref = chip_smoke.step_outputs(cfg, weights, batch, CPU)
    return cfg, weights, batch, ref


@pytest.mark.parametrize("seed", range(4))
def test_limits_pass_rounding_scale_weight_perturbations(parity, seed):
    cfg, weights, batch, ref = parity
    gen = torch.Generator().manual_seed(seed)
    perturbed = {
        k: v * (1 + 2.0**-24 * torch.randn(v.shape, generator=gen))
        if k.endswith((".weight", ".bias")) else v
        for k, v in weights.items()
    }
    err = chip_smoke.parity_errors(
        chip_smoke.step_outputs(cfg, perturbed, batch, CPU), ref, cfg.train.lr)
    print(json.dumps({"perturbation_seed": seed, **err}))
    assert chip_smoke.parity_ok(err), err


@pytest.mark.parametrize("kernel", ["bwd_df1", "bwd_df2"])
def test_limits_fail_a_backward_that_drops_one_query(parity, kernel, monkeypatch):
    cfg, weights, batch, ref = parity
    wrapper = getattr(corr_fused, kernel)

    def dropping(f1, f2s, coords, g, radius=4):
        g = g.clone()
        g[-1] = 0
        return wrapper(f1, f2s, coords, g, radius)

    monkeypatch.setattr(corr_fused, kernel, dropping)
    err = chip_smoke.parity_errors(
        chip_smoke.step_outputs(cfg, weights, batch, CPU), ref, cfg.train.lr)
    print(json.dumps({"fault": f"{kernel} drops the last query", **err}))
    assert err["max_fnet_grad_l2"] > chip_smoke.PARITY_FNET_GRAD_L2, err
    assert not chip_smoke.parity_ok(err)
