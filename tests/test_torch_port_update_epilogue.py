"""The update block's fused conv epilogues (kernels/update_epilogue.py) and
the blocks' no-grad path (models/update.py, models/gma.py), on the CPU.

- each mode's plain version against the op chain it replaces, in fp32 and
  bf16, writing at a channel offset of a wider NHWC buffer whose other
  channels stay as they were;
- the RAFT, GMA and small update blocks without gradient (the fused path)
  against the same blocks under gradient (the op chain), at small shapes:
  equal within 1e-5 in fp32. In bf16 the op chain rounds after every op and
  the epilogue once, after the last: ``BF16_BLOCK_TOL`` below;
- a RAFT forward twice: the first call's outputs unchanged by the second
  (nothing that leaves ``iterate`` aliases the forward's buffers), the
  fused path counted once an iteration, no kernel launched on the CPU;
- the wrappers' refusals.

No JAX here; the forwards' JAX parity tests run the fused path's plain
version too, since ``RAFT.forward`` runs without gradient.
"""
import pytest
import torch

from flow_supervisor_tpu_torch.kernels import update_epilogue as epilogue
from flow_supervisor_tpu_torch.models import gma, update
from flow_supervisor_tpu_torch.models.layers import init_weights_
from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

DTYPES = [torch.float32, torch.bfloat16]
# bf16: the op chain rounds every intermediate to bf16 (8 bits), the fused
# path only its outputs; through a block's 15 convs and the GRU's gating the
# two part by a few bf16 ulps of the largest output (2^-8 relative each).
BF16_BLOCK_TOL = 2.0 ** -5
FP32_BLOCK_TOL = 1e-5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _wide(b, h, w, c, off, width, dtype, gen):
    """A [b, h, w, width] NHWC buffer of noise and its channel slice [off, off + c)."""
    buf = torch.randn(b, h, w, width, generator=gen).to(dtype)
    return buf, buf[..., off:off + c]


def _check(got, want, dtype, roundings):
    """fp32: the same ops, to fp32's rounding. bf16: the chain rounds each of
    its ``roundings`` intermediates to bf16, each by at most 2^-9 of its
    size, and sigmoid, tanh and the gating's convex combination carry that on
    no larger; the plain version rounds once: 2^-8 of the largest output
    for each."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= roundings * 2.0 ** -8 * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu,scale,c,off,width", [
    (True, 1.0, 192, 0, 256),  # convc2 into [cor | flo]
    (True, 1.0, 64, 192, 256),  # convf2 into [cor | flo]
    (True, 1.0, 126, 256, 384),  # the motion conv into the GRU's x: a masked tail
    (False, 1.0, 2, 0, 2),  # the flow head's last conv, in place
    (False, 0.25, 576, 0, 576),  # the mask head's last conv, in place
])
def test_bias_act_plain_matches_the_op_chain(dtype, relu, scale, c, off, width):
    gen = _gen(c + off)
    x = torch.randn(2, 3, 5, c, generator=gen).to(dtype)
    bias = torch.randn(c, generator=gen).to(dtype)
    want = x + bias  # the conv's bias add, then the activation, each in dtype
    want = torch.relu(want) if relu else want
    want = scale * want
    if width == c:  # in place over the conv's output
        got = epilogue.bias_act(x.clone(), bias, relu=relu, scale=scale)
        assert torch.equal(got, want)
        return
    buf, slot = _wide(2, 3, 5, c, off, width, dtype, gen)
    before = buf.clone()
    got = epilogue.bias_act(x, bias, slot, relu=relu, scale=scale)
    assert got.data_ptr() == slot.data_ptr()
    # one rounding of an exact sum: the same bits as the add's, relu and 0.25 exact
    assert torch.equal(buf[..., off:off + c], want)
    rest = torch.ones(width, dtype=torch.bool)
    rest[off:off + c] = False
    assert torch.equal(buf[..., rest], before[..., rest])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,width", [(128, 384), (128, 512), (96, 242)])
def test_gru_modes_plain_match_the_op_chain(dtype, c, width):
    """The gate and the update against ``SepConvGRU._step``'s chain: z and r
    through sigmoid, r * h into the [h | x] buffer's h slot, then (1 - z) * h
    + z * tanh(q) into the state and the slot; the x channels untouched.
    fp32: the same ops; bf16: ``_check``."""
    gen = _gen(c + width)
    z, r, q = (torch.randn(2, 3, 5, c, generator=gen).to(dtype) for _ in range(3))
    bz, br, bq = (torch.randn(c, generator=gen).to(dtype) for _ in range(3))
    h = torch.tanh(torch.randn(2, 3, 5, c, generator=gen)).to(dtype)
    hx, slot = _wide(2, 3, 5, c, 0, width, dtype, gen)
    x_before = hx[..., c:].clone()
    zs_want = torch.sigmoid(z + bz)
    rh_want = torch.sigmoid(r + br) * h
    h_want = (1.0 - zs_want) * h + zs_want * torch.tanh(q + bq)

    zs = epilogue.gru_gate(z, r, bz, br, h, slot)
    assert zs.data_ptr() == z.data_ptr()
    _check(zs, zs_want, dtype, 2)  # the chain rounds z + bz and sigmoid
    _check(slot, rh_want, dtype, 3)  # r + br, sigmoid, r * h
    state = h.clone()  # the update in place over h, as from a block's second pass on
    got = epilogue.gru_update(q, bq, zs, state, state, slot)
    assert got.data_ptr() == state.data_ptr() and torch.equal(slot, state)
    _check(state, h_want, dtype, 6)  # q + bq, tanh, 1 - z, (1 - z) * h, z * q, the sum
    assert torch.equal(hx[..., c:], x_before)


def _blocks():
    """(name, block, its extra inputs, hidden, context, correlation channels)."""
    g = _gen(5)
    raft = update.BasicUpdateBlock(128, 4, 4)
    gm = gma.GMAUpdateBlock(128, 4, 4, 1)
    small = update.SmallUpdateBlock(96, 4, 3)
    for m in (raft, gm, small):
        init_weights_(m, "update", g)
    with torch.no_grad():
        gm.aggregator.gamma.fill_(0.5)  # its initial zero leaves the aggregation out
    attn = torch.softmax(torch.randn(2, 1, 35, 35, generator=g), -1)
    return [("raft", raft, (), 128, 128, 324), ("gma", gm, (attn,), 128, 128, 324),
            ("small", small, (), 96, 64, 196)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["raft", "gma", "small"])
def test_the_fused_block_matches_the_op_chain(which, dtype):
    """Two calls in one set of buffers, as ``iterate`` makes them, against two
    calls of the op chain under gradient; the fused path is counted."""
    _, block, extra, hd, cd, cc = next(b for b in _blocks() if b[0] == which)
    block = block.to(dtype=dtype, memory_format=torch.channels_last)
    g = _gen(6)

    def cl(t):
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    net = cl(torch.tanh(torch.randn(2, hd, 5, 7, generator=g)))
    inp = cl(torch.relu(torch.randn(2, cd, 5, 7, generator=g)))
    steps = [(cl(torch.randn(2, cc, 5, 7, generator=g)),
              cl(2 * torch.randn(2, 2, 5, 7, generator=g))) for _ in range(2)]
    extra = tuple(t.to(dtype) for t in extra)
    want, h = [], net
    for corr, flow in steps:
        out = block(h, inp, corr, flow, *extra)
        want.append([None if t is None else t.detach() for t in out])
        h = out[0].detach()
    passes = epilogue.fused_passes
    with torch.no_grad():
        buffers = block.buffers(net, inp)
        got, h = [], net
        for corr, flow in steps:
            out = block(h, inp, corr, flow, *extra, buffers=buffers)
            got.append([None if t is None else t.clone() for t in out])
            h = out[0]
    assert epilogue.fused_passes == passes + 2 and epilogue.launches == 0
    tol = FP32_BLOCK_TOL if dtype == torch.float32 else BF16_BLOCK_TOL
    for g_out, w_out in zip(got, want):
        for name, a, b in zip(("net", "mask", "delta"), g_out, w_out):
            assert (a is None) == (b is None), name
            if a is None:
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, name
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * b.float().abs().max().item(), (name, err)


def test_a_forward_leaves_nothing_aliased():
    """Two no-grad RAFT forwards: the second leaves the first's flows and the
    net ``iterate`` returns as they were; each forward counts one fused pass
    an iteration and launches nothing on the CPU; a forward under gradient
    takes the op chain (no pass counted) and gives the same flows."""
    cfg = RAFTConfig(iters=3, lookup_backend="einsum")
    model = RAFT(cfg, generator=_gen(7))
    g = _gen(8)
    pairs = [(torch.rand(1, 32, 48, 3, generator=g), torch.rand(1, 32, 48, 3, generator=g))
             for _ in range(2)]
    passes, launches = epilogue.fused_passes, epilogue.launches
    first = model(*pairs[0])
    kept = {k: v.clone() for k, v in first.items()}
    with torch.no_grad():
        net, inp = model.context(pairs[0][0])
        pyramid = model.build_corr(*model.features(*pairs[0]))
        from flow_supervisor_tpu_torch.ops.coords import coords_grid

        c0 = coords_grid(1, 4, 6)
        net_out, coords1, _, _ = model.iterate(net, inp, pyramid, c0, c0, (32, 48), 2)
    net_kept = net_out.clone()
    second = model(*pairs[1])
    assert epilogue.fused_passes == passes + 3 + 2 + 3
    assert epilogue.launches == launches
    for k, v in kept.items():
        assert torch.equal(first[k], v), k
        assert not torch.equal(second[k], v), k
    assert torch.equal(net_out, net_kept)
    with torch.enable_grad():
        graded = model._flow(*pairs[0])
    assert epilogue.fused_passes == passes + 8
    torch.testing.assert_close(graded["flow_up"].detach(), kept["flow_up"], rtol=1e-5,
                               atol=1e-5)


def test_the_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.randn(2, 3, 5, 16)
    bias = torch.randn(16)
    with pytest.raises(ValueError, match="channels innermost"):
        epilogue.bias_act(x.permute(0, 2, 1, 3), bias)  # pixels not evenly spaced
    with pytest.raises(ValueError, match="channels innermost"):
        epilogue.bias_act(x[..., ::2], bias[::2].contiguous())  # channels strided
    with pytest.raises(ValueError, match="bias"):
        epilogue.bias_act(x, torch.randn(8))
    with pytest.raises(ValueError, match="bias"):  # fp32 or the tensors' dtype
        epilogue.bias_act(x, bias.bfloat16())
    with pytest.raises(ValueError, match="bias"):  # one dtype for both biases
        epilogue.gru_gate(x, x, bias, bias.bfloat16(), x, x.clone())
    with pytest.raises(ValueError, match="beside"):
        epilogue.bias_act(x, bias, torch.empty(2, 3, 5, 16, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        epilogue.bias_act(x.double(), bias.double())
    with pytest.raises(ValueError, match="C <= 2048"):
        epilogue.bias_act(torch.randn(1, 1, 1, 4096), torch.randn(4096))
