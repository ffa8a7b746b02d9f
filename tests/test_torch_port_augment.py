"""The port's augmentors (flow_supervisor_tpu_torch/data/augment.py) against
cv2 and the JAX package's augmentors on the same numpy inputs and seeds.

Limits: cv2's resize and warp within 1e-5 of values in [0, 1] (both take
cv2's two paths by channel count: 2 channels at float32 or 1/32-pixel
positions, the rest at exact ones; within a path they differ by rounding);
the nearest resize exactly; the HSV pair within 1e-6 for S and V, 1e-3
degrees for H. Augmentor outputs: images within 1e-5, flows within 1e-4 px,
valid masks and crop offsets exactly, and the generator's state after the
call equal to the JAX augmentor's, so every later draw agrees.

A rotated label's flow is renormalised by the rotated mask (fm / mm); where
mm < 0.999 the pixel is not a label (valid 0) and the quotient amplifies
the 4e-6 by which the two warps' mm differ, so flows of rotated sparse
labels are held where they are valid (a dense label has no mask: held
everywhere)."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from flow_supervisor_tpu.data import augment as J  # noqa: E402
from flow_supervisor_tpu_torch.data import augment as P  # noqa: E402

IMAGE_TOL = 1e-5
FLOW_TOL = 1e-4


def _images(rng, h, w, n=2):
    """Smooth random frames in [0, 1] (bilinear upsampling of coarse noise)
    with fine noise on top, float32."""
    out = []
    for _ in range(n):
        coarse = rng.uniform(0, 1, (h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
        img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR)
        out.append(np.clip(img + rng.normal(0, 0.05, (h, w, 3)), 0, 1).astype(np.float32))
    return out


def _flow(rng, h, w, sparse=False):
    flow = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    valid = (rng.uniform(0, 1, (h, w, 1)) > (0.3 if sparse else -1)).astype(np.float32)
    return flow, valid


def _cv2_resize(x, h, w, nearest):
    out = cv2.resize(x, (w, h), interpolation=cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR)
    return out[:, :, None] if out.ndim == 2 else out


@pytest.mark.parametrize("nearest", [False, True], ids=["linear", "nearest"])
@pytest.mark.parametrize("size", [(60, 80, 97, 133), (436, 1024, 576, 1024), (540, 960, 368, 496),
                                  (37, 53, 20, 21)], ids=["up", "upscale_things", "down", "odd"])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_resize_matches_cv2(nearest, size, channels):
    rng = np.random.default_rng(channels)
    h_src, w_src, h, w = size
    x = rng.uniform(0, 1, (h_src, w_src, channels)).astype(np.float32)
    got = P._resize(x, h, w, nearest=nearest)
    want = _cv2_resize(x, h, w, nearest)
    assert got.shape == want.shape == (h, w, channels)
    if nearest:
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= IMAGE_TOL
    if channels == 1:  # a 2-D input comes back [h, w, 1], as the JAX _resize returns it
        assert np.array_equal(P._resize(x[:, :, 0], h, w, nearest=nearest), got)


@pytest.mark.parametrize("angle", [-9.7, 0.0, 3.3, 45.0])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_rotation_warp_matches_cv2(angle, channels):
    rng = np.random.default_rng(7)
    h, w = 48, 70
    x = rng.uniform(0, 1, (h, w, channels)).astype(np.float32)
    center = (w / 2 - 0.5, h / 2 - 0.5)
    m = P._rotation_matrix(center, angle)
    np.testing.assert_allclose(m, cv2.getRotationMatrix2D(center, angle, 1.0), rtol=0, atol=1e-12)
    want = cv2.warpAffine(x, m, (w, h), flags=cv2.INTER_LINEAR)
    want = want[:, :, None] if want.ndim == 2 else want
    got = P._warp_affine(x, m)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= IMAGE_TOL


def test_hsv_pair_matches_cv2():
    rng = np.random.default_rng(3)
    rgb = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    # grey pixels, pure primaries and ties between channels
    rgb[0, :8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                  [0.7, 0.7, 0.2], [0.2, 0.7, 0.7]]
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    got = P._rgb_to_hsv(rgb)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0, atol=1e-6)
    dh = np.abs(got[..., 0] - want[..., 0])
    assert np.minimum(dh, 360.0 - dh).max() <= 1e-3
    hsv = want.copy()
    hsv[..., 1] = rng.uniform(0, 1, hsv.shape[:2]).astype(np.float32)
    hsv[..., 0] = rng.uniform(0, 360, hsv.shape[:2]).astype(np.float32) % 360.0
    back = P._hsv_to_rgb(hsv)
    assert back.dtype == np.float32
    np.testing.assert_allclose(back, cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), rtol=0, atol=1e-6)


def _same_state(a: np.random.Generator, b: np.random.Generator) -> bool:
    return a.bit_generator.state == b.bit_generator.state


def _check_arrays(got, want, name, valid=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if "valid" in name or name == "crop_yx":
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    elif "flow" in name:
        err = np.abs(got - want)
        if valid is not None:
            err = err * (valid > 0.5)
        assert err.max() <= FLOW_TOL, name
    else:
        assert np.abs(got - want).max() <= IMAGE_TOL, name


def _run_both(make, args, seed):
    """(port output, JAX output), each from a generator seeded with `seed`;
    the two generators must end in the same state."""
    r_p, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    got = make(P)(*[a.copy() for a in args], r_p)
    want = make(J)(*[a.copy() for a in args], r_j)
    assert _same_state(r_p, r_j)
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_color_jitter_and_eraser_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    img1, img2 = _images(rng, 120, 160)
    got, want = _run_both(lambda m: m.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14),
                          [np.concatenate([img1, img2])], seed)
    _check_arrays(got, want, "image")
    got, want = _run_both(lambda m: (lambda im, r: m._eraser(im, r, 0.5)), [img2], seed)
    _check_arrays(got, want, "image")


# (name, augmentor builder taking the module, frame h, w, sparse label)
_CASES = {
    "dense": (lambda m: m.FlowAugmentor((48, 64), -0.2, 0.5, True), 72, 96, False),
    "dense_min_scale": (lambda m: m.FlowAugmentor((88, 112), -0.5, -0.4, True), 72, 96, False),
    "dense_rotation": (lambda m: m.FlowAugmentor((40, 56), 0.0, 0.4, True, do_rotation=True),
                       72, 96, False),
    "sparse": (lambda m: m.SparseFlowAugmentor((48, 64), -0.2, 0.4, True), 72, 96, True),
    "sparse_rotation": (lambda m: m.SparseFlowAugmentor((40, 56), -0.2, 0.4, False,
                                                        do_rotation=True), 72, 96, True),
    "unsup": (lambda m: m.UnsupAugmentor((40, 64), -0.5, 0.6, True, full_size=(64, 96)),
              70, 100, False),
    # a Things frame under the Sintel recipe's --full_size 432 1024: the source
    # is narrower than full_size, so it is upscaled by 1024 / 960 first
    "unsup_upscale": (lambda m: m.UnsupAugmentor((400, 720), 0.0, 0.8, True,
                                                 full_size=(432, 1024)), 540, 960, False),
    "unsup_no_full_size": (lambda m: m.UnsupAugmentor((32, 48), -0.2, 0.6, True), 61, 83, True),
}


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("seed", [0, 5])
def test_augmentor_matches_jax(case, seed):
    make, h, w, sparse = _CASES[case]
    rng = np.random.default_rng(seed + 11)
    img1, img2 = _images(rng, h, w)
    flow, valid = _flow(rng, h, w, sparse)
    aug = make(P)
    if type(aug) is P.FlowAugmentor:
        got, want = _run_both(make, [img1, img2, flow], seed)
        names = ["image1", "image2", "flow"]
        got, want = dict(zip(names, got)), dict(zip(names, want))
    else:
        got, want = _run_both(make, [img1, img2, flow, valid], seed)
        if isinstance(got, tuple):
            names = ["image1", "image2", "flow", "valid"]
            got, want = dict(zip(names, got)), dict(zip(names, want))
    assert sorted(got) == sorted(want)
    rotated = make(P).do_rotation
    for k in want:
        valid = want.get(k.replace("flow", "valid")) if rotated and "flow" in k else None
        _check_arrays(got[k], want[k], k, valid)
    if case == "unsup_upscale":
        assert got["orig_image1"].shape == (432, 1024, 3)
        assert got["image1"].shape == (400, 720, 3)


@pytest.mark.parametrize("seed", [0, 4])
def test_multiframe_augmentor_matches_jax(seed):
    rng = np.random.default_rng(seed + 20)
    imgs = _images(rng, 72, 96, n=3)
    flow1, valid1 = _flow(rng, 72, 96, sparse=True)
    flow2, valid2 = _flow(rng, 72, 96)
    got, want = _run_both(lambda m: m.MultiFrameAugmentor((40, 56), -0.1, 1.0, True),
                          [*imgs, flow1, valid1, flow2, valid2], seed)
    assert sorted(got) == sorted(want)
    for k in want:
        _check_arrays(got[k], want[k], k)


def test_random_rotation_matches_jax():
    rng = np.random.default_rng(9)
    imgs = _images(rng, 50, 70)
    flow, valid = _flow(rng, 50, 70, sparse=True)
    r_p, r_j = np.random.default_rng(2), np.random.default_rng(2)
    got = P.random_rotation(imgs, flow, valid, 10.0, r_p)
    want = J.random_rotation(imgs, flow, valid, 10.0, r_j)
    assert _same_state(r_p, r_j)
    for g, w_ in zip(got[0], want[0]):
        _check_arrays(g, w_, "image")
    _check_arrays(got[2], want[2], "valid")
    _check_arrays(got[1], want[1], "flow", want[2])
    assert want[2].mean() > 0.15  # the check reads labels, not an empty mask
