"""The port's small RAFT (SmallEncoder, BottleneckBlock, SmallMotionEncoder,
ConvGRU, SmallUpdateBlock; RAFT(small=True)) against the JAX package's, on
the CPU, fp32.

- the modules on the same parameters: ``BottleneckBlock`` with instance,
  batch (running statistics), group and no norm, at stride 1 and 2;
  ``SmallEncoder`` with instance norm (fnet) and none (cnet); ``ConvGRU``;
  ``SmallUpdateBlock``;
- the small RAFT at 32x48, 2 iterations: 4 levels at radius 3, bilinear x8
  upsampling; the forward with and without ``flow_init`` and
  ``final_flow_only`` under every lookup backend of the port,
  ``semi_forward``'s crop path (the full frame upsampled bilinearly, then
  cropped) and ``unsup_forward``;
- the radius rule of ``training.loop.build_model``: the JAX package fixes 4
  levels at radius 4, or 3 for the small model, whatever ModelCfg holds.

Variables are seeded numpy values in the JAX model's own tree
(``fill_variables``); the port takes them through ``convert.from_flax``.
Limits: the forwards 2e-3 px (docs/PARITY.md), the modules 1e-5 relative to
their output's largest element (fp32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu import config as jconfig
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.models import encoders as jenc
from flow_supervisor_tpu.models import update as jupd
from flow_supervisor_tpu.training.loop import build_model as jbuild_model
from flow_supervisor_tpu_torch import config as pconfig
from flow_supervisor_tpu_torch import convert
from flow_supervisor_tpu_torch.models import encoders, update
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from flow_supervisor_tpu_torch.training.loop import build_model
from test_torch_train_jaxstep import FH, FW, H, W, fill_variables, random_variables

ITERS = 2
BOUND = 2e-3  # px
MODULE_TOL = 1e-5


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _variables(module, *args, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return fill_variables(shapes, seed=seed)


def _apply(module, v, *args, **kw):
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(
        jax.tree_util.tree_map(jnp.asarray, v), *args)


def _load(port, sd: dict) -> None:
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})


def _close(got: torch.Tensor, want, tol=MODULE_TOL):
    want = np.asarray(want)
    got = got.detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("norm", ["instance", "batch", "group", "none"])
def test_bottleneck_block_matches_flax(norm, stride):
    """32 -> 32 at stride 1 (the identity skip), 16 -> 32 at stride 2 (the
    downsample)."""
    c_in = 32 if stride == 1 else 16
    x = np.random.default_rng(0).normal(0, 1, (2, 12, 10, c_in)).astype(np.float32)
    mod = jenc.BottleneckBlock(in_planes=c_in, planes=32, norm=norm, stride=stride)
    v = _variables(mod, jnp.asarray(x), seed=1)
    port = encoders.BottleneckBlock(c_in, 32, norm, stride).eval()
    sd = {}
    convert._block(sd, "", v["params"], v.get("batch_stats", {}), 3)
    _load(port, {k[1:]: a for k, a in sd.items()})
    if norm == "group":  # planes // 8 groups in every norm, as the reference's bottleneck
        assert port.norm1.num_groups == port.norm3.num_groups == 4
    _close(port(_nchw(x)), _apply(mod, v, jnp.asarray(x)))


@pytest.mark.parametrize("norm,out", [("instance", 128), ("none", 160)], ids=["fnet", "cnet"])
def test_small_encoder_matches_flax(norm, out):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    mod = jenc.SmallEncoder(output_dim=out, norm=norm)
    v = _variables(mod, jnp.asarray(x), seed=2)
    port = encoders.SmallEncoder(out, norm)
    sd = {}
    convert._encoder(sd, "e", v["params"], None)
    _load(port, {k[2:]: a for k, a in sd.items()})
    _close(port(_nchw(x)), _apply(mod, v, jnp.asarray(x)))


@pytest.fixture(scope="module")
def block_inputs():
    rng = np.random.default_rng(3)
    b, h8, w8 = 2, 4, 6
    return (np.tanh(rng.normal(0, 1, (b, h8, w8, 96))).astype(np.float32),
            np.maximum(rng.normal(0, 1, (b, h8, w8, 64)), 0).astype(np.float32),
            rng.normal(0, 1, (b, h8, w8, 4 * 49)).astype(np.float32),
            rng.normal(0, 2, (b, h8, w8, 2)).astype(np.float32))


def test_conv_gru_matches_flax(block_inputs):
    net, inp = block_inputs[0], np.concatenate(block_inputs[1:3], -1)[..., :146]
    mod = jupd.ConvGRU(hidden_dim=96, input_dim=146)
    v = _variables(mod, jnp.asarray(net), jnp.asarray(inp), seed=4)
    port = update.ConvGRU(96, 146)
    sd = {}
    for i, name in enumerate(("convz", "convr", "convq")):
        convert._conv(sd, name, v["params"][f"UpdateConv_{i}"])
    _load(port, sd)
    _close(port(_nchw(net), _nchw(inp)), _apply(mod, v, jnp.asarray(net), jnp.asarray(inp)))


def test_small_update_block_matches_flax(block_inputs):
    mod = jupd.SmallUpdateBlock(hidden_dim=96, corr_levels=4, corr_radius=3)
    args = [jnp.asarray(a) for a in block_inputs]
    v = _variables(mod, *args, seed=5)
    port = update.SmallUpdateBlock(96, 4, 3)
    sd = {}
    convert._update_block(sd, "b", v["params"])
    _load(port, {k[2:]: a for k, a in sd.items()})
    net, mask, delta = port(*[_nchw(a) for a in block_inputs])
    jnet, jmask, jdelta = _apply(mod, v, *args)
    assert mask is None and jmask is None
    _close(net, jnet)
    _close(delta, jdelta)


# ---- the small RAFT ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_small():
    model = JRAFT(JRAFTConfig(small=True, iters=ITERS, teacher=True, teacher_iters=ITERS,
                              freeze_bn=True, lookup_backend="einsum", scan_iters=True).resolved())
    assert model.cfg.corr_radius == 3 and not model.cfg.convex_upsampling
    v = random_variables(model, seed=6)
    assert "batch_stats" not in v  # instance norm and none: no batch norm
    return model, jax.tree_util.tree_map(jnp.asarray, v)


@pytest.fixture(scope="module")
def port_models(jax_small):
    _, v = jax_small
    state = convert.from_flax(jax.tree_util.tree_map(np.asarray, v["params"]), {})
    models = {}
    for backend in ("plane", "fused", "pallas", "einsum", "zero", "auto"):
        # the fields a caller sets are resolved: radius 3, bilinear upsampling
        m = RAFT(RAFTConfig(small=True, iters=ITERS, teacher=True, teacher_iters=ITERS,
                            freeze_bn=True, lookup_backend=backend))
        assert m.cfg.corr_radius == 3 and not m.cfg.convex_upsampling
        m.load_state_dict(state)  # strict: from_flax mapped every variable
        models[backend] = m
    return models


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    full1 = rng.uniform(0, 1, (1, FH, FW, 3)).astype(np.float32)
    full2 = (np.roll(full1, (2, -3), axis=(1, 2)) * 0.9 + 0.1 * rng.uniform(0, 1, full1.shape))
    return full1, full2.astype(np.float32), rng.normal(0, 2, (1, H // 8, W // 8, 2)).astype(np.float32)


def _np(out):
    return {k: np.asarray(a) for k, a in out.items()}


def _px(got, want):
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.detach().numpy() - want).max())


@pytest.fixture(scope="module")
def jax_forwards(jax_small, frames):
    model, v = jax_small
    full1, full2, flow_init = frames
    img1, img2 = full1[:, 8:8 + H, 8:8 + W], full2[:, 8:8 + H, 8:8 + W]
    fwd = jax.jit(lambda v, a, b, init: model.apply(v, a, b, flow_init=init))
    zero = JRAFT(dataclasses.replace(model.cfg, lookup_backend="zero"))
    return img1, img2, {"all_iters": _np(fwd(v, img1, img2, np.zeros_like(flow_init))),
                        "flow_init": _np(fwd(v, img1, img2, flow_init)),
                        "zero": _np(jax.jit(zero.apply)(v, img1, img2))}


@pytest.mark.parametrize("case", ["all_iters", "final_flow_only", "flow_init"])
def test_small_forward_matches_jax(port_models, jax_forwards, frames, case):
    """Bilinear x8 at radius 3; final_flow_only against the last of JAX's
    upsampled iterations."""
    img1, img2, want = jax_forwards
    want = want["flow_init" if case == "flow_init" else "all_iters"]
    final = case != "all_iters"
    got = port_models["einsum"](
        torch.from_numpy(img1.copy()), torch.from_numpy(img2.copy()),
        flow_init=torch.from_numpy(frames[2]) if case == "flow_init" else None,
        final_flow_only=final)
    assert _px(got["flow_up"], want["flow_up"][-1:] if final else want["flow_up"]) < BOUND
    assert _px(got["flow_low"], want["flow_low"]) < BOUND


@pytest.mark.parametrize("backend", ["plane", "fused", "pallas", "zero", "auto"])
def test_small_forward_per_lookup_backend_matches_jax(port_models, jax_forwards, backend):
    img1, img2, want = jax_forwards
    want = want["zero" if backend == "zero" else "all_iters"]
    got = port_models[backend](torch.from_numpy(img1.copy()), torch.from_numpy(img2.copy()))
    assert _px(got["flow_up"], want["flow_up"]) < BOUND
    assert _px(got["flow_low"], want["flow_low"]) < BOUND


def test_small_semi_crop_path_and_unsup_match_jax(jax_small, port_models, frames):
    """The teacher's flows upsampled bilinearly in the full frame, then cut
    to the crop (JAX raft.py:340-349); crop_yx (8, 16) of 48x64 frames."""
    model, v = jax_small
    full1, full2, _ = frames
    crop = np.asarray([[8, 16]], np.int32)
    img1, img2 = full1[:, 8:8 + H, 16:16 + W], full2[:, 8:8 + H, 16:16 + W]
    port = port_models["fused"]
    for method, args, targs in (
        ("semi_forward", (img1, img2, full1, full2, crop), None),
        ("unsup_forward", (img1, img2), None),
    ):
        want = _np(jax.jit(lambda v, *a: model.apply(v, *a, method=method))(v, *args))
        with torch.no_grad():
            got = getattr(port, method)(*(torch.from_numpy(a.copy()) for a in args))
        assert sorted(got) == sorted(want), method
        for k in want:
            assert _px(got[k], want[k]) < BOUND, (method, k)
    assert got["flow_up"].shape[2:4] == (H, W)


@pytest.mark.parametrize("fields", [
    dict(small=True), dict(corr_radius=3), dict(corr_levels=3, corr_radius=5),
    dict(small=True, corr_radius=4), dict(model_type="gma-semi", corr_radius=2, num_heads=2),
], ids=["small", "radius3", "levels3_radius5", "small_radius4", "gma_radius2"])
def test_build_model_resolves_levels_and_radius_as_jax(fields):
    """ModelCfg's corr_levels / corr_radius are not read: JAX's build_model
    resolves 4 levels at radius 4, or 3 for the small model (a default
    ModelCfg holds radius 4, so a small model built from it would diverge)."""
    want = jbuild_model(jconfig.ExperimentConfig(jconfig.ModelCfg(**fields))).cfg
    got = build_model(pconfig.ExperimentConfig(pconfig.ModelCfg(**fields))).cfg
    assert (got.corr_levels, got.corr_radius) == (want.corr_levels, want.corr_radius)
    assert (got.small, got.gma, got.num_heads, got.convex_upsampling, got.teacher) == (
        want.small, want.gma, want.num_heads, want.convex_upsampling, want.teacher)
    assert (got.hidden_dim, got.context_dim) == (want.hidden_dim, want.context_dim)
