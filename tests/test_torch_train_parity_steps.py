"""The limits of chip_smoke.py's card-vs-CPU train steps (phase 5) for the
Unsup step, the semi step with the teacher SMURF loss and the Baseline step
(unfrozen batch norm), measured on the CPU as
tests/test_torch_train_parity_limits.py measures them for the semi step:
the limits must pass the same step from weights scaled by
1 + 2^-24 * N(0, 1) (the spread the card's other rounding can cause), and
must fail a step whose K9 (or K8) drops one query's lookup cotangent, and
for Baseline a step whose batch norm moves its running variance toward the
unbiased batch variance (``nn.BatchNorm2d``'s rule, not flax's) or does not
move its running statistics at all. Run with ``-s`` to print what each case
reads."""
import json

import pytest
import torch

import chip_smoke
from flow_supervisor_tpu_torch.kernels import corr_fused
from flow_supervisor_tpu_torch.models.layers import BatchNorm2d
from flow_supervisor_tpu_torch.training.loop import frozen_bn

CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["unsup", "smurf", "baseline"])
def parity(request):
    kind = request.param
    cfg, weights, batch = chip_smoke.step_parity_setup(kind)
    ref = chip_smoke.step_outputs(cfg, weights, batch, CPU)
    return kind, cfg, weights, batch, ref, not frozen_bn(cfg)


@pytest.mark.parametrize("seed", range(2))
def test_step_limits_pass_rounding_scale_weight_perturbations(parity, seed):
    kind, cfg, weights, batch, ref, bn_train = parity
    gen = torch.Generator().manual_seed(seed)
    perturbed = {
        k: v * (1 + 2.0**-24 * torch.randn(v.shape, generator=gen))
        if k.endswith((".weight", ".bias")) else v
        for k, v in weights.items()
    }
    err = chip_smoke.parity_errors(chip_smoke.step_outputs(cfg, perturbed, batch, CPU), ref,
                                   cfg.train.lr, bn_train)
    print(json.dumps({"step": kind, "perturbation_seed": seed, **err}))
    assert chip_smoke.parity_ok(err, kind), err


@pytest.mark.parametrize("kernel", ["bwd_df1", "bwd_df2"])
def test_step_limits_fail_a_backward_that_drops_one_query(parity, kernel, monkeypatch):
    kind, cfg, weights, batch, ref, bn_train = parity
    wrapper = getattr(corr_fused, kernel)

    def dropping(f1, f2s, coords, g, radius=4):
        g = g.clone()
        g[-1] = 0
        return wrapper(f1, f2s, coords, g, radius)

    monkeypatch.setattr(corr_fused, kernel, dropping)
    err = chip_smoke.parity_errors(chip_smoke.step_outputs(cfg, weights, batch, CPU), ref,
                                   cfg.train.lr, bn_train)
    print(json.dumps({"step": kind, "fault": f"{kernel} drops the last query", **err}))
    assert err["max_fnet_grad_l2"] > chip_smoke.PARITY_FNET_GRAD_L2, err
    assert not chip_smoke.parity_ok(err, kind)


def _unbiased_running_var(self, x):
    if self.training:
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=1)
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return torch.nn.functional.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                                              self.eps)
    return torch.nn.BatchNorm2d.forward(self, x)


def _frozen_running_stats(self, x):
    return torch.nn.functional.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                                          self.eps)


@pytest.mark.parametrize("parity", ["baseline"], indirect=True)
@pytest.mark.parametrize("fault", ["unbiased_running_var", "running_stats_not_updated"])
def test_step_limits_fail_a_batch_norm_running_statistics_fault(parity, fault, monkeypatch):
    kind, cfg, weights, batch, ref, bn_train = parity
    monkeypatch.setattr(BatchNorm2d, "forward", {
        "unbiased_running_var": _unbiased_running_var,
        "running_stats_not_updated": _frozen_running_stats}[fault])
    err = chip_smoke.parity_errors(chip_smoke.step_outputs(cfg, weights, batch, CPU), ref,
                                   cfg.train.lr, bn_train)
    print(json.dumps({"step": kind, "fault": fault, **err}))
    assert err["max_rel_err_running_stats_update"] > chip_smoke.PARITY_STATS_UPDATE_REL, err
    assert not chip_smoke.parity_ok(err, kind)
