"""The port's GMA (models/gma.py and RAFT(gma=True)) against the JAX
package's, on the CPU, fp32.

- the modules on the same parameters: ``RelPosEmb``; ``Attention`` in its
  three modes (content, position_only, position_and_content) at 1 and 2
  heads; ``Aggregate`` with and without its projection; ``GMAUpdateBlock``;
  every aggregator's ``gamma`` at 0.5, not its initial zero, which would
  leave the attention path out of the result;
- the GMA RAFT (2 heads, position and content) at 32x48, 2 iterations: the
  forward with and without ``flow_init`` and ``final_flow_only`` under every
  lookup backend of the port, ``semi_forward`` on a 32x48 crop of 48x64
  frames, ``unsup_forward``, the ``Evaluator``'s teacher split (one map for
  the student and the teacher), and the weight bridge both ways;
- bf16: the attention map's dtype in the three modes (fp32 in the
  position modes, where JAX's fp32 tables promote the scores; bf16 in the
  content mode) and the update block fed a position mode's fp32 map;
- the divergence pinned: a map taller or wider than the position tables
  (h8 or w8 > 160) is refused by the port, where JAX's gather clamps.

The JAX model's variables are seeded numpy values in its own tree
(``random_variables``); the port takes them through ``convert.from_flax``.
The forwards must agree within 2e-3 px (docs/PARITY.md's golden bound), the
modules within 1e-5 (fp32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.convert import convert_torch_raft
from flow_supervisor_tpu.evaluation import Evaluator as JEvaluator
from flow_supervisor_tpu.models import RAFT as JRAFT, RAFTConfig as JRAFTConfig
from flow_supervisor_tpu.models import gma as jgma
from flow_supervisor_tpu_torch.convert import from_flax
from flow_supervisor_tpu_torch.evaluation import Evaluator
from flow_supervisor_tpu_torch.models import gma
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from test_torch_train_jaxstep import FH, FW, H, W, fill_variables, random_variables

ITERS = 2
BOUND = 2e-3  # px
MODULE_TOL = 1e-5
GMA_KW = dict(gma=True, num_heads=2, position_and_content=True)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _oihw(kernel) -> torch.Tensor:
    return torch.from_numpy(np.asarray(kernel).transpose(3, 2, 0, 1).copy())


def _close(got: torch.Tensor, want, tol=MODULE_TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _init(module, *args):
    """The flax module's variables, seeded (``fill_variables``: every gamma
    0.5) in the tree its init traces (an init run costs a compile)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(jnp.asarray, fill_variables(shapes, seed=9))


def _apply(module, v, *args):
    return jax.jit(module.apply)(v, *args)


def test_relposemb_matches_flax():
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (2, 2, 4, 5, 8)).astype(np.float32)
    mod = jgma.RelPosEmb(max_pos_size=6, dim_head=8)
    v = _init(mod, jnp.asarray(q))
    port = gma.RelPosEmb(6, 8)
    port.rel_height.weight.data = torch.from_numpy(np.array(v["params"]["rel_height"]))
    port.rel_width.weight.data = torch.from_numpy(np.array(v["params"]["rel_width"]))
    _close(port(torch.from_numpy(q)), _apply(mod, v, jnp.asarray(q)))


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("mode", ["content", "position_only", "position_and_content"])
def test_attention_matches_flax(mode, heads):
    rng = np.random.default_rng(1)
    fmap = rng.normal(0, 1, (2, 5, 6, 16)).astype(np.float32)
    flags = dict(position_only=mode == "position_only",
                 position_and_content=mode == "position_and_content")
    mod = jgma.Attention(dim=16, heads=heads, dim_head=8, max_pos_size=8, **flags)
    v = _init(mod, jnp.asarray(fmap))
    port = gma.Attention(16, heads, 8, 8, **flags)
    p = v["params"]
    port.to_qk.weight.data = _oihw(p["Conv_0"]["kernel"])
    if mode != "content":
        port.pos_emb.rel_height.weight.data = torch.from_numpy(np.array(p["RelPosEmb_0"]["rel_height"]))
        port.pos_emb.rel_width.weight.data = torch.from_numpy(np.array(p["RelPosEmb_0"]["rel_width"]))
    else:
        assert not hasattr(port, "pos_emb") and "RelPosEmb_0" not in p
    got = port(_nchw(fmap))
    _close(got, _apply(mod, v, jnp.asarray(fmap)))
    assert torch.allclose(got.sum(-1), torch.ones(()), atol=1e-5)


@pytest.mark.parametrize("heads", [1, 2], ids=["no_project", "project"])
def test_aggregate_matches_flax(heads):
    rng = np.random.default_rng(2)
    fmap = rng.normal(0, 1, (2, 4, 5, 16)).astype(np.float32)
    attn = jax.nn.softmax(jnp.asarray(rng.normal(0, 2, (2, heads, 20, 20)), jnp.float32), -1)
    mod = jgma.Aggregate(dim=16, heads=heads, dim_head=16)
    v = _init(mod, attn, jnp.asarray(fmap))
    port = gma.Aggregate(16, heads, 16)
    assert (port.project is not None) == (heads == 2) == ("Conv_1" in v["params"])
    port.to_v.weight.data = _oihw(v["params"]["Conv_0"]["kernel"])
    if heads == 2:
        port.project.weight.data = _oihw(v["params"]["Conv_1"]["kernel"])
    port.gamma.data = torch.from_numpy(np.array(v["params"]["gamma"]))
    got = port(torch.from_numpy(np.array(attn)), _nchw(fmap))
    want = _apply(mod, v, attn, jnp.asarray(fmap))
    _close(got.permute(0, 2, 3, 1), want)
    assert np.abs(np.asarray(want) - fmap).max() > 0.1  # the aggregated term counts


def test_gma_update_block_matches_flax():
    rng = np.random.default_rng(3)
    b, h8, w8 = 1, 4, 6
    net = np.tanh(rng.normal(0, 1, (b, h8, w8, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(0, 1, (b, h8, w8, 128)), 0).astype(np.float32)
    corr = rng.normal(0, 1, (b, h8, w8, 4 * 81)).astype(np.float32)
    flow = rng.normal(0, 2, (b, h8, w8, 2)).astype(np.float32)
    attn = jax.nn.softmax(jnp.asarray(rng.normal(0, 2, (b, 1, 24, 24)), jnp.float32), -1)
    mod = jgma.GMAUpdateBlock(hidden_dim=128, corr_levels=4, corr_radius=4, heads=1)
    args = [jnp.asarray(a) for a in (net, inp, corr, flow)] + [attn]
    v = _init(mod, *args)
    port = gma.GMAUpdateBlock(128, 4, 4, 1)
    sd = {}
    from flow_supervisor_tpu_torch.convert import _update_block

    _update_block(sd, "b", jax.tree_util.tree_map(np.asarray, v["params"]))
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    got = port(*[_nchw(a) for a in (net, inp, corr, flow)], torch.from_numpy(np.array(attn)))
    want = _apply(mod, v, *args)
    for g, w_ in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w_, 1e-4)


# ---- bf16: the map's dtype in the position modes ---------------------------

BF16_MAP_TOL = 1e-5  # of the map's largest entry (the old bf16 cast was 4e-3 and 6e-3 away)
BF16_BLOCK_TOL = 3e-2  # of each output's largest value: bf16 convs on both sides


def _attention_pair(mode, dtype):
    """A flax Attention (compute ``dtype``) and the port's on the same seeded
    parameters, 1 head of 16 over 5x6 maps of 16 channels."""
    flags = dict(position_only=mode == "position_only",
                 position_and_content=mode == "position_and_content")
    mod = jgma.Attention(dim=16, heads=1, dim_head=16, max_pos_size=8, dtype=dtype, **flags)
    fmap = np.random.default_rng(11).normal(0, 1, (1, 5, 6, 16)).astype(np.float32)
    v = _init(mod, jnp.asarray(fmap))
    port = gma.Attention(16, 1, 16, 8, **flags)
    p = v["params"]
    port.to_qk.weight.data = _oihw(p["Conv_0"]["kernel"])
    if mode != "content":
        for t in ("rel_height", "rel_width"):
            getattr(port.pos_emb, t).weight.data = torch.from_numpy(np.array(p["RelPosEmb_0"][t]))
    return mod, v, port, fmap


@pytest.mark.parametrize("mode", ["content", "position_only", "position_and_content"])
def test_attention_bf16_map_dtype_follows_jax(mode):
    """In bf16 JAX's map takes the dtype of the promoted scores: its fp32
    position tables make it fp32 in the position modes; the content mode's
    stays bf16. The port's follows (it once cast every map to the compute
    dtype), and its values agree within bf16's rounding of q, k and the
    content scores."""
    mod, v, port, fmap = _attention_pair(mode, jnp.bfloat16)
    x = jnp.asarray(fmap, jnp.bfloat16)
    want = _apply(mod, v, x)
    with torch.no_grad():
        got = port(_nchw(fmap).to(torch.bfloat16))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert str(want.dtype) == ("bfloat16" if mode == "content" else "float32")
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    print(f"bf16 {mode}: map {got.dtype}, max |port - JAX| {err:.3e} of max {want.max():.3f}")
    assert err <= BF16_MAP_TOL * want.max(), err


@pytest.mark.parametrize("mode", ["position_only", "position_and_content"])
def test_gma_update_block_bf16_with_a_position_map_matches_flax(mode):
    """The bf16 update block fed the fp32 map of a position mode: the
    aggregation runs against the fp32 map (v promoted), as JAX's einsum
    does, and the three outputs agree with JAX's."""
    amod, av, aport, fmap = _attention_pair(mode, jnp.bfloat16)
    rng = np.random.default_rng(12)
    b, h8, w8 = 1, 5, 6
    net = np.tanh(rng.normal(0, 1, (b, h8, w8, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(0, 1, (b, h8, w8, 128)), 0).astype(np.float32)
    corr = rng.normal(0, 1, (b, h8, w8, 4 * 81)).astype(np.float32)
    flow = rng.normal(0, 2, (b, h8, w8, 2)).astype(np.float32)
    jattn = _apply(amod, av, jnp.asarray(fmap, jnp.bfloat16))
    with torch.no_grad():
        attn = aport(_nchw(fmap).to(torch.bfloat16))
    assert attn.dtype == torch.float32 and str(jattn.dtype) == "float32"
    mod = jgma.GMAUpdateBlock(hidden_dim=128, corr_levels=4, corr_radius=4, heads=1,
                              dtype=jnp.bfloat16)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (net, inp, corr, flow)]
    v = _init(mod, *args, jattn)
    port = gma.GMAUpdateBlock(128, 4, 4, 1)
    sd = {}
    from flow_supervisor_tpu_torch.convert import _update_block

    _update_block(sd, "b", jax.tree_util.tree_map(np.asarray, v["params"]))
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    with torch.no_grad():
        got = port(*[_nchw(a).to(torch.bfloat16) for a in (net, inp, corr, flow)], attn)
    want = _apply(mod, v, *args, jattn)
    for name, g, w_ in zip(("net", "mask", "delta_flow"), got, want):
        w_ = np.asarray(w_.astype(jnp.float32))
        err = np.abs(g.float().permute(0, 2, 3, 1).numpy() - w_).max()
        print(f"bf16 {mode} update block {name}: max |port - JAX| {err:.3e} of {np.abs(w_).max():.3f}")
        assert err <= BF16_BLOCK_TOL * np.abs(w_).max(), (name, err)


# ---- the GMA RAFT ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_gma():
    cfg = JRAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS, freeze_bn=True,
                      lookup_backend="einsum", scan_iters=True, **GMA_KW).resolved()
    model = JRAFT(cfg)
    v = random_variables(model, seed=4)
    return model, v


@pytest.fixture(scope="module")
def port_models(jax_gma):
    _, v = jax_gma
    state = from_flax(v["params"], v["batch_stats"])
    models = {}
    for backend in ("plane", "fused", "pallas", "einsum", "zero", "auto"):
        m = RAFT(RAFTConfig(iters=ITERS, teacher=True, teacher_iters=ITERS, freeze_bn=True,
                            lookup_backend=backend, **GMA_KW))
        m.load_state_dict(state)  # strict: the key sets agree
        models[backend] = m
    return models


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(5)
    full1 = rng.uniform(0, 1, (1, FH, FW, 3)).astype(np.float32)
    full2 = (np.roll(full1, (2, -3), axis=(1, 2)) * 0.9 + 0.1 * rng.uniform(0, 1, full1.shape))
    full2 = full2.astype(np.float32)
    flow_init = rng.normal(0, 2, (1, H // 8, W // 8, 2)).astype(np.float32)
    return full1, full2, flow_init


def _jvars(v):
    return jax.tree_util.tree_map(jnp.asarray, v)


def _np(out):
    return {k: np.asarray(a) for k, a in out.items()}


def _px(got, want):
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.detach().numpy() - want).max())


@pytest.fixture(scope="module")
def jax_forwards(jax_gma, pair):
    model, v = jax_gma
    full1, full2, flow_init = pair
    img1, img2 = full1[:, 8:8 + H, 8:8 + W], full2[:, 8:8 + H, 8:8 + W]
    # one compile: a zero flow_init is no flow_init (coords0 + 0)
    fwd = jax.jit(lambda v, a, b, init: model.apply(v, a, b, flow_init=init))
    out = {"all_iters": _np(fwd(_jvars(v), img1, img2, np.zeros_like(flow_init))),
           "flow_init": _np(fwd(_jvars(v), img1, img2, flow_init))}
    zero = JRAFT(JRAFTConfig(**{**model.cfg.__dict__, "lookup_backend": "zero"}))
    out["zero"] = _np(jax.jit(zero.apply)(_jvars(v), img1, img2))
    return img1, img2, out


@pytest.mark.parametrize("case", ["all_iters", "final_flow_only", "flow_init"])
def test_gma_forward_matches_jax(port_models, jax_forwards, pair, case):
    """final_flow_only against the last of JAX's upsampled iterations."""
    img1, img2, want = jax_forwards
    init = torch.from_numpy(pair[2]) if case == "flow_init" else None
    want = want["flow_init" if case == "flow_init" else "all_iters"]
    final = case != "all_iters"
    got = port_models["einsum"](torch.from_numpy(img1.copy()), torch.from_numpy(img2.copy()),
                                flow_init=init, final_flow_only=final)
    assert _px(got["flow_up"], want["flow_up"][-1:] if final else want["flow_up"]) < BOUND
    assert _px(got["flow_low"], want["flow_low"]) < BOUND


@pytest.mark.parametrize("backend", ["plane", "fused", "pallas", "zero", "auto"])
def test_gma_forward_per_lookup_backend_matches_jax(port_models, jax_forwards, backend):
    img1, img2, want = jax_forwards
    want = want["zero" if backend == "zero" else "all_iters"]
    got = port_models[backend](torch.from_numpy(img1.copy()), torch.from_numpy(img2.copy()))
    assert _px(got["flow_up"], want["flow_up"]) < BOUND
    assert _px(got["flow_low"], want["flow_low"]) < BOUND


def test_gma_semi_and_unsup_forwards_match_jax(jax_gma, port_models, pair):
    model, v = jax_gma
    full1, full2, _ = pair
    crop = np.asarray([[8, 16]], np.int32)
    img1, img2 = full1[:, 8:8 + H, 16:16 + W], full2[:, 8:8 + H, 16:16 + W]
    want = _np(jax.jit(lambda *a: model.apply(*a, method="semi_forward"))(
        _jvars(v), img1, img2, full1, full2, jnp.asarray(crop)))
    port = port_models["fused"]
    with torch.no_grad():
        got = port.semi_forward(*(torch.from_numpy(a.copy()) for a in (img1, img2, full1, full2)),
                                torch.from_numpy(crop))
        assert sorted(got) == sorted(want)
        for k in want:
            assert _px(got[k], want[k]) < BOUND, k
        want = _np(jax.jit(lambda *a: model.apply(*a, method="unsup_forward"))(
            _jvars(v), img1, img2))
        got = port.unsup_forward(torch.from_numpy(img1.copy()), torch.from_numpy(img2.copy()))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _px(got[k], want[k]) < BOUND, k


def test_evaluator_teacher_split_matches_jax(jax_gma, port_models, jax_forwards):
    """The student for ITERS, then the teacher head from its final state,
    both reading the one map of the forward (JAX's evaluation.py:141-151)."""
    model, v = jax_gma
    img1, img2, _ = jax_forwards
    want, want_low = JEvaluator(model, _jvars(v), iters=ITERS)._run_pair(
        _jvars(v), img1[0], img2[0], "sintel", None)
    got, got_low = Evaluator(port_models["einsum"], iters=ITERS).predict(
        img1[0], img2[0], "sintel")
    assert sorted(got) == sorted(want) == ["student", "teacher"]
    for k in want:
        assert np.abs(got[k] - want[k]).max() < BOUND, k
    assert np.abs(got_low - want_low).max() < BOUND
    assert np.abs(got["teacher"] - got["student"]).max() > 1e-3  # the teacher head ran


def test_weight_bridge_round_trips(jax_gma, port_models):
    """from_flax took every variable (the strict loads); the JAX package's
    convert_torch_raft gives the same trees back, but for GMA's position
    tables, which it does not map."""
    _, v = jax_gma
    sd = {("grad_" + k[len("teacher_"):] if k.startswith("teacher_update_block.") else k): t
          for k, t in port_models["einsum"].state_dict().items()}
    params, stats = convert_torch_raft(sd, teacher=True, gma=True)
    want = jax.tree_util.tree_map(np.asarray, v["params"])
    pos = want["att"].pop("RelPosEmb_0")
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(want)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.array_equal, params, want)))
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.array_equal, stats, jax.tree_util.tree_map(np.asarray, v["batch_stats"]))))
    assert np.array_equal(sd["att.pos_emb.rel_height.weight"].numpy(), pos["rel_height"])
    assert "att.pos_emb.rel_height" not in str(jax.tree_util.tree_structure(params))


def test_position_tables_refuse_a_map_beyond_them():
    """Pinned divergence: at h8 (or w8) > max_pos_size the offsets leave the
    tables; JAX's gather clamps them to the last row, the port refuses. The
    content mode has no tables and runs at any size."""
    q = np.ones((1, 1, 5, 3, 4), np.float32)
    mod = jgma.RelPosEmb(max_pos_size=4, dim_head=4)
    v = _init(mod, jnp.asarray(q))
    assert np.isfinite(np.asarray(_apply(mod, v, jnp.asarray(q)))).all()
    with pytest.raises(ValueError, match="max_pos_size 4"):
        gma.RelPosEmb(4, 4)(torch.from_numpy(q))
    img = torch.rand(1, 8 * 161, 8, 3, generator=torch.Generator().manual_seed(0))
    for flags in (dict(position_only=True), dict(position_and_content=True)):
        model = RAFT(RAFTConfig(iters=1, gma=True, lookup_backend="einsum", **flags))
        with pytest.raises(ValueError, match="161x1 feature map exceeds max_pos_size 160"):
            model(img, img)
    out = RAFT(RAFTConfig(iters=1, gma=True, lookup_backend="einsum"))(img, img)
    assert torch.isfinite(out["flow_up"]).all()
