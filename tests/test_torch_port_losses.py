"""The port's unsupervised-loss modules against the JAX package's, on the CPU
at fp32, eagerly (no jit), at 16x24 on the same seeded numpy inputs: each
value, and its gradient with respect to the flow (and the resampler's with
respect to its data) for a seeded cotangent, to 1e-5 of the reference's
largest element. Covered: the resampler with out-of-bounds taps,
``flow_to_warp`` / ``warp_image``, ``mask_invalid`` with per-sample pads,
the range map with corners out of bounds, brox and wang occlusion, census,
both smoothness orders (exponential edges, at a high and a low image
contrast), self-supervision, and ``unsupervised_sequence_loss``
with the full-size warping branch (wang, and brox with every pixel of the
chosen flows at least 1e-3 away from its hard threshold)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_supervisor_tpu.losses import occlusion as jocc
from flow_supervisor_tpu.losses import photometric as jphoto
from flow_supervisor_tpu.losses import selfsup as jselfsup
from flow_supervisor_tpu.losses import smoothness as jsmooth
from flow_supervisor_tpu.losses import unsupervised as junsup
import flow_supervisor_tpu.ops.pad as jpad
import flow_supervisor_tpu.ops.warp as jwarp
from flow_supervisor_tpu.ops.resampler import resampler as jresampler
from flow_supervisor_tpu_torch.losses import occlusion as occ
from flow_supervisor_tpu_torch.losses import photometric as photo
from flow_supervisor_tpu_torch.losses import selfsup
from flow_supervisor_tpu_torch.losses import smoothness as smooth
from flow_supervisor_tpu_torch.losses import unsupervised as unsup
from flow_supervisor_tpu_torch.ops import pad
from flow_supervisor_tpu_torch.ops import resampler as res
from flow_supervisor_tpu_torch.ops import warp

B, H, W = 2, 16, 24
FH, FW = 24, 40
CROP = np.asarray([[0, 8], [8, 16]], np.int32)


def _flow(rng, scale=3.0, shape=(B, H, W)):
    """Smooth random flow [*, h, w, 2] with vectors reaching out of the frame."""
    low = rng.normal(0, scale, (shape[0], 3, 4, 2))
    y = np.linspace(0, 2, shape[1])[:, None]
    x = np.linspace(0, 3, shape[2])[None, :]
    y0, x0 = np.floor(y).astype(int).clip(0, 1), np.floor(x).astype(int).clip(0, 2)
    fy, fx = (y - y0)[..., None], (x - x0)[..., None]
    f = ((1 - fy) * (1 - fx) * low[:, y0, x0] + (1 - fy) * fx * low[:, y0, x0 + 1]
         + fy * (1 - fx) * low[:, y0 + 1, x0] + fy * fx * low[:, y0 + 1, x0 + 1])
    return (f + rng.normal(0, 0.3, f.shape)).astype(np.float32)


def _compare(jfn, tfn, args, grad_of, seed=0):
    """Value of jfn / tfn on args (numpy), and the VJP with respect to the
    args named by index in ``grad_of`` for a seeded cotangent, to 1e-5."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(a, requires_grad=i in grad_of) if a.dtype.kind == "f"
             else torch.tensor(a) for i, a in enumerate(args)]
    jout, vjp = jax.vjp(lambda *g: jfn(*[g[grad_of.index(i)] if i in grad_of else a
                                         for i, a in enumerate(jargs)]),
                        *[jargs[i] for i in grad_of])
    tout = tfn(*targs)
    jv, tv = np.asarray(jout), tout.detach().numpy()
    assert jv.shape == tv.shape
    scale = max(np.abs(jv).max(), 1e-30)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5 * scale)
    cot = np.random.default_rng(seed).normal(size=jv.shape).astype(np.float32)
    jg = vjp(jnp.asarray(cot))
    tg = (torch.autograd.grad(tout, [targs[i] for i in grad_of], torch.from_numpy(cot),
                              allow_unused=True)
          if tout.requires_grad else [None] * len(grad_of))  # a hard threshold: zero
    for i, a, b in zip(grad_of, jg, tg):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * max(np.abs(a).max(), 1e-30),
                                   err_msg=f"gradient of argument {i}")
    return jv


def test_resampler_with_out_of_bounds_taps():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    warp_ = np.stack([rng.uniform(-3, W + 2, (B, 7, 9)), rng.uniform(-3, H + 2, (B, 7, 9))], -1)
    warp_[0, 0, :4] = [[-0.5, 3.2], [W - 0.5, 4.1], [2.3, -0.7], [5.5, H - 0.2]]
    out = _compare(jresampler, res.resampler, [data, warp_.astype(np.float32)], [0, 1])
    assert out.shape == (B, 7, 9, 3)


@pytest.mark.parametrize("mode", ["zero", "input"])
def test_flow_to_warp_and_warp_image(mode):
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    _compare(jwarp.flow_to_warp, warp.flow_to_warp, [_flow(rng)], [0])
    _compare(lambda i, f: jwarp.warp_image(i, f, mode), lambda i, f: warp.warp_image(i, f, mode),
             [img, _flow(rng)], [0, 1])


def test_mask_invalid_with_per_sample_pads_and_outgoing_mask():
    rng = np.random.default_rng(2)
    coords = np.stack([rng.integers(-2, W + 2, (B, H, W)), rng.integers(-2, H + 2, (B, H, W))],
                      -1).astype(np.float32)
    coords[..., 0] += rng.choice([0.0, 0.5], coords.shape[:3])  # on and between the bounds
    px, py = np.asarray([0, 3], np.int32), np.asarray([2, 0], np.int32)
    want = np.asarray(jocc.mask_invalid(jnp.asarray(coords), jnp.asarray(px), jnp.asarray(py)))
    got = occ.mask_invalid(torch.from_numpy(coords), torch.from_numpy(px), torch.from_numpy(py))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1 and (coords[..., 0] == W - 1).any()
    flow = _flow(rng)
    np.testing.assert_array_equal(pad.create_outgoing_mask(torch.from_numpy(flow)).numpy(),
                                  np.asarray(jpad.create_outgoing_mask(jnp.asarray(flow))))
    x = rng.normal(size=(B, 11, 13, 2)).astype(np.float32)
    np.testing.assert_array_equal(pad.central_pad(torch.from_numpy(x), (16, 20)).numpy(),
                                  np.asarray(jpad.central_pad(jnp.asarray(x), (16, 20))))
    np.testing.assert_array_equal(pad.central_crop(torch.from_numpy(x), (6, 7)).numpy(),
                                  np.asarray(jpad.central_crop(jnp.asarray(x), (6, 7))))


def test_range_map_with_corners_out_of_bounds():
    flow = _flow(np.random.default_rng(3), scale=4.0)
    warp_ = flow + np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)[None]
    assert ((warp_ < 0) | (warp_[..., :1] > W - 1)).any()  # some corners fall outside
    out = _compare(jocc.compute_range_map, occ.compute_range_map, [flow], [0])
    assert out.min() == 0.0 and out.max() > 1.0


def test_wang_occlusion():
    rng = np.random.default_rng(4)
    _compare(lambda f, b: jocc.compute_occlusions(f, b, "wang"),
             lambda f, b: occ.compute_occlusions(f, b, "wang"), [_flow(rng), _flow(rng)], [1])


def test_no_occlusion():
    rng = np.random.default_rng(4)
    fw, bw = _flow(rng), _flow(rng)
    want = np.asarray(jocc.compute_occlusions(jnp.asarray(fw), jnp.asarray(bw), "none"))
    got = occ.compute_occlusions(torch.from_numpy(fw), torch.from_numpy(bw), "none")
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.shape == (B, H, W, 1) and (want == 1.0).all()


def _brox_margin(fw, bw):
    """min over pixels of |fb_sq_diff - (0.01 fb_sum_sq + 0.5)|, the distance
    of each pixel from brox's hard threshold."""
    fw, bw = torch.from_numpy(np.asarray(fw)), torch.from_numpy(np.asarray(bw))
    bwd = res.resampler(bw, warp.flow_to_warp(fw))
    d = ((fw + bwd) ** 2).sum(-1) - (0.01 * (fw**2 + bwd**2).sum(-1) + 0.5)
    return float(d.abs().min())


def _consistent_pair(rng, shape=(B, H, W)):
    """A forward flow and a backward flow that undoes it where the flow stays
    in the frame, with noise: brox marks some pixels occluded, not all."""
    fw = _flow(rng, shape=shape)
    bw = -fw + rng.normal(0, 0.6, fw.shape).astype(np.float32)
    return fw, bw.astype(np.float32)


def _brox_safe(make, seed):
    """make(rng) -> (list of (fw, bw) pairs, payload) from the first seed at or
    after ``seed`` whose pairs all keep every pixel more than 1e-3 from
    brox's threshold, in both directions: the inputs are fixed, and the hard
    threshold cannot flip on a rounding difference."""
    for s in range(seed, seed + 200):
        pairs, payload = make(np.random.default_rng(s))
        if all(_brox_margin(f, b) > 1e-3 and _brox_margin(b, f) > 1e-3 for f, b in pairs):
            return payload
    raise AssertionError("no seed gave flows clear of the brox threshold")


def test_brox_occlusion():
    fw, bw = _brox_safe(lambda rng: ((p := _consistent_pair(rng)),) and ([p], p), 5)
    assert _brox_margin(fw, bw) > 1e-3
    out = _compare(lambda f, b: jocc.compute_occlusions(f, b, "brox"),
                   lambda f, b: occ.compute_occlusions(f, b, "brox"), [fw, bw], [0, 1])
    assert 0 < out.mean() < 1


def test_census_loss():
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(size=(B, H, W, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(B, H, W, 1)) > 0.3).astype(np.float32)
    _compare(jphoto.census_transform, photo.census_transform, [a], [0])
    _compare(jphoto.census_loss, photo.census_loss, [a, b, mask], [0, 1])


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("contrast", [0.05, 0.005])  # edge weights about e^-3 and e^-0.3
def test_smoothness(order, contrast):
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    jf = jsmooth.first_order_smoothness_loss if order == 1 else jsmooth.second_order_smoothness_loss
    tf = smooth.first_order_smoothness_loss if order == 1 else smooth.second_order_smoothness_loss
    jedge = jsmooth.edge_weighting_fn("exponential", 150.0)
    _compare(lambda i, f: jf(i, f, jedge), tf, [img * contrast, _flow(rng)], [1])


def test_self_supervision_loss():
    rng = np.random.default_rng(8)
    t_fw, t_bw = _consistent_pair(rng, (B, FH, FW))
    s_fw, s_bw = _flow(rng), _flow(rng)
    crop = CROP

    def jfn(tf, sf, tb, sb):
        return jselfsup.self_supervision_loss(tf, sf, tb, sb, jnp.asarray(crop))

    def tfn(tf, sf, tb, sb):
        return selfsup.self_supervision_loss(tf, sf, tb, sb, torch.from_numpy(crop))

    _compare(jfn, tfn, [t_fw, s_fw, t_bw, s_bw], [1, 3])


def _sequence_inputs(rng, iters=2):
    full = rng.uniform(size=(B, 2, FH, FW, 3)).astype(np.float32)
    images = np.stack([full[i, :, y : y + H, x : x + W] for i, (y, x) in enumerate(CROP)])
    fws, bws = zip(*[_consistent_pair(rng) for _ in range(iters)])
    t_fw, t_bw = _consistent_pair(rng, (B, FH, FW))
    return images, np.stack(fws), np.stack(bws), t_fw, t_bw, full


@pytest.mark.parametrize("occlusion,seed", [("wang", 9), ("brox", 10)])
def test_unsupervised_sequence_loss_with_full_size_branch(occlusion, seed):
    if occlusion == "brox":
        inputs = _brox_safe(lambda rng: (list(zip(*(x := _sequence_inputs(rng))[1:3])), x), seed)
        for f, b in zip(*inputs[1:3]):
            assert _brox_margin(f, b) > 1e-3 and _brox_margin(b, f) > 1e-3
    else:
        inputs = _sequence_inputs(np.random.default_rng(seed))
    images, fws, bws, t_fw, t_bw, full = inputs
    kw = dict(census=1.0, smooth1=2.5, smooth2=2.0, selfsup=0.3, occlusion=occlusion)
    jcfg, tcfg = junsup.UnsupLossConfig(**kw), unsup.UnsupLossConfig(**kw)

    def jfn(fw, bw):
        total, terms = junsup.unsupervised_sequence_loss(
            jnp.asarray(images), fw, bw, jcfg, teacher_flow_fw=jnp.asarray(t_fw),
            teacher_flow_bw=jnp.asarray(t_bw), full_size_images=jnp.asarray(full),
            crop_yx=jnp.asarray(CROP))
        return jnp.stack([total] + [terms[k] for k in sorted(terms)])

    def tfn(fw, bw):
        total, terms = unsup.unsupervised_sequence_loss(
            torch.from_numpy(images), fw, bw, tcfg, teacher_flow_fw=torch.from_numpy(t_fw),
            teacher_flow_bw=torch.from_numpy(t_bw), full_size_images=torch.from_numpy(full),
            crop_yx=torch.from_numpy(CROP))
        return torch.stack([total] + [terms[k] for k in sorted(terms)])

    out = _compare(jfn, tfn, [fws, bws], [0, 1])
    assert (out > 0).all()
