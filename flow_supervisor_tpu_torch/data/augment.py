"""Host-side augmentors (counterpart of flow_supervisor_tpu/data/augment.py),
on numpy and the ``np.random.Generator`` passed in: no cv2.

The JAX package calls cv2 in four places; each has a numpy counterpart here
with cv2's float32 meaning:

- ``_resize`` (``cv2.resize``): linear is half-pixel-centre bilinear with the
  source index clamped at the edges, horizontal pass first. cv2 takes two
  paths: for 1, 3 and 4 channels exact source positions, for 2 channels (a
  flow) positions rounded to float32, which moves a weight by up to 3e-5 at
  a width of 1,024; ``_resize`` takes the same two. Nearest takes source
  index ``min(floor(i * src / dst), src - 1)``.
- ``_rgb_to_hsv`` / ``_hsv_to_rgb`` (``cv2.cvtColor`` RGB <-> HSV on float32):
  H in degrees [0, 360), S and V in [0, 1], cv2's formulas and epsilons.
- ``_rotation_matrix`` / ``_warp_affine`` (``cv2.getRotationMatrix2D`` and
  ``cv2.warpAffine`` with INTER_LINEAR): bilinear sampling of the inverse map
  with zeros outside the source; for 2 channels at cv2's 1/32-pixel fixed
  point positions.

Every draw from ``rng`` happens in the JAX package's order and count, so one
seed gives the same crops, flips and jitter in both packages:

- ``FlowAugmentor`` (dense): colour (asymmetric with prob 0.2), eraser on
  img2 (prob 0.5, 1-2 rectangles of 50-100 px filled with img2's mean
  colour), then spatial: the scales are drawn before the spatial prob check,
  scale 2^U(min, max) with stretch prob 0.8 (+-0.2 exponents), floored to
  (crop + 8) / size; h-flip 0.5, v-flip 0.1; a random crop.
- ``SparseFlowAugmentor``: symmetric colour only, nearest flow / valid resize.
- ``MultiFrameAugmentor``: colour over three frames before the spatial draws.
- ``UnsupAugmentor``: spatial draws (full-size frame, then an 8-aligned crop)
  before colour and eraser, which touch only the crop. Sources smaller than
  ``full_size`` are upscaled first, so every example has the same frame size.
"""
from __future__ import annotations

import numpy as np

_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def _linear_taps(n_src: int, n_dst: int, float32_positions: bool):
    """(i0, i1, f): the two source indices and the weight of i1 of each
    output index, half-pixel centres, indices clamped to the source."""
    x = (np.arange(n_dst) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5
    if float32_positions:
        x = x.astype(np.float32)
    x0 = np.floor(x)
    f = (x - x0).astype(np.float32)
    x0 = x0.astype(np.int64)
    return np.clip(x0, 0, n_src - 1), np.clip(x0 + 1, 0, n_src - 1), f


def _nearest_index(n_src: int, n_dst: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(n_dst) * (1.0 / (n_dst / n_src))).astype(np.int64),
                      n_src - 1)


def _resize(img: np.ndarray, h: int, w: int, nearest: bool = False) -> np.ndarray:
    """[H, W] or [H, W, C] -> [h, w, C] (C = 1 for a 2-D input)."""
    if img.ndim == 2:
        img = img[:, :, None]
    if nearest:
        return np.take(np.take(img, _nearest_index(img.shape[0], h), axis=0),
                       _nearest_index(img.shape[1], w), axis=1)
    f32 = img.shape[2] == 2
    i0x, i1x, fx = _linear_taps(img.shape[1], w, f32)
    i0y, i1y, fy = _linear_taps(img.shape[0], h, f32)
    fx = fx[None, :, None]
    hx = np.take(img, i0x, axis=1) * (1.0 - fx)
    hx += np.take(img, i1x, axis=1) * fx
    fy = fy[:, None, None]
    out = np.take(hx, i0y, axis=0) * (1.0 - fy)
    out += np.take(hx, i1y, axis=0) * fy
    return out


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """float32 RGB in [0, 1] -> HSV, H in degrees [0, 360), S and V in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    k = np.float32(60.0) / (diff + _FLT_EPSILON)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120.0), (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


# cv2's sector table: which of (v, p, q, t) each of R, G, B takes in a sector
_HSV_SECTORS = np.asarray([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0], [0, 1, 2]])


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """The inverse of ``_rgb_to_hsv`` (H in degrees, wrapped into [0, 360))."""
    h, s, v = hsv[..., 0] * np.float32(6.0 / 360.0), hsv[..., 1], hsv[..., 2]
    h = h - np.float32(6.0) * np.floor(h / np.float32(6.0))
    sector = np.floor(h).astype(np.intp)
    bad = (sector < 0) | (sector >= 6)
    if bad.any():
        h = np.where(bad, np.float32(0.0), h)
        sector = np.where(bad, 0, sector)
    h = h - sector
    one = np.float32(1.0)
    tab = (v, v * (one - s), v * (one - s * h), v * (one - s * (one - h)))
    out = np.empty(hsv.shape, np.float32)
    for c in range(3):
        out[..., c] = np.choose(np.take(_HSV_SECTORS[:, c], sector), tab)
    return out


class ColorJitter:
    def __init__(self, brightness, contrast, saturation, hue):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, im: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        b = rng.uniform(max(0.0, 1.0 - self.brightness), 1.0 + self.brightness)
        c = rng.uniform(max(0.0, 1.0 - self.contrast), 1.0 + self.contrast)
        # brightness then contrast about the mean, in one pass:
        # ((im*b) - mean(im*b))*c + mean(im*b) == im*(b*c) + b*mean(im)*(1-c)
        mean = im.reshape(-1, im.shape[-1]).mean(axis=0)
        im = im * np.float32(b * c) + (mean * (b * (1.0 - c))).astype(np.float32)
        s = rng.uniform(max(0.0, 1.0 - self.saturation), 1.0 + self.saturation)
        d = rng.uniform(-self.hue, self.hue)
        hsv = _rgb_to_hsv(np.clip(im, 0.0, 1.0).astype(np.float32))
        hsv[..., 1] = np.clip(hsv[..., 1] * s, 0.0, 1.0)
        hsv[..., 0] = (hsv[..., 0] + d * 360.0) % 360.0
        return _hsv_to_rgb(hsv)


def _eraser(img2: np.ndarray, rng: np.random.Generator, prob: float, bounds=(50, 100)):
    ht, wd = img2.shape[:2]
    if rng.uniform() < prob:
        mean_color = img2.reshape(-1, 3).mean(axis=0)
        for _ in range(rng.integers(1, 3)):
            x0 = int(rng.integers(0, wd))
            y0 = int(rng.integers(0, ht))
            dx = int(rng.integers(min(bounds[0], wd - x0), min(bounds[1], wd - x0 + 1)))
            dy = int(rng.integers(min(bounds[0], ht - y0), min(bounds[1], ht - y0 + 1)))
            img2 = img2.copy()
            img2[y0 : y0 + dy, x0 : x0 + dx] = mean_color
    return img2


class FlowAugmentor:
    """Dense augmentor."""

    sparse = False

    def __init__(
        self,
        crop_size,
        min_scale=-0.2,
        max_scale=0.5,
        do_flip=True,
        eraser_aug_prob=0.5,
        do_rotation=False,
        max_rotation=10.0,
    ):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_rotation = do_rotation
        self.max_rotation = max_rotation
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = eraser_aug_prob
        self.photo_aug = ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)

    def color_transform(self, img1, img2, rng):
        if rng.uniform() < self.asymmetric_color_aug_prob:
            img1 = self.photo_aug(img1, rng)
            img2 = self.photo_aug(img2, rng)
        else:
            stack = self.photo_aug(np.concatenate([img1, img2], axis=0), rng)
            img1, img2 = np.split(stack, 2, axis=0)
        return np.clip(img1, 0.0, 1.0), np.clip(img2, 0.0, 1.0)

    def _sample_scales(self, rng, base_h, base_w):
        min_scale = max(
            (self.crop_size[0] + 8.0) / base_h, (self.crop_size[1] + 8.0) / base_w
        )
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.uniform() < self.stretch_prob:
            sx *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        return max(sx, min_scale), max(sy, min_scale), min_scale

    def spatial_transform(self, img1, img2, flow, rng):
        if self.do_rotation:
            (img1, img2), flow, _ = random_rotation(
                [img1, img2], flow, np.ones_like(flow[..., :1]),
                self.max_rotation, rng,
            )
        ht, wd = img1.shape[:2]
        sx, sy, min_scale = self._sample_scales(rng, ht, wd)
        if rng.uniform() < self.spatial_aug_prob:
            t_h, t_w = int(round(ht * sy)), int(round(wd * sx))
            sy, sx = t_h / ht, t_w / wd
            img1 = _resize(img1, t_h, t_w)
            img2 = _resize(img2, t_h, t_w)
            flow = _resize(flow, t_h, t_w) * np.asarray([sx, sy], np.float32)
        elif min_scale > 1.0:
            t_h, t_w = int(round(ht * min_scale)), int(round(wd * min_scale))
            s2y, s2x = t_h / ht, t_w / wd
            img1 = _resize(img1, t_h, t_w)
            img2 = _resize(img2, t_h, t_w)
            flow = _resize(flow, t_h, t_w) * np.asarray([s2x, s2y], np.float32)

        if self.do_flip:
            if rng.uniform() < self.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * np.asarray([-1.0, 1.0], np.float32)
            if rng.uniform() < self.v_flip_prob:
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * np.asarray([1.0, -1.0], np.float32)

        ht, wd = img1.shape[:2]
        y0 = int(rng.integers(0, ht - self.crop_size[0]))
        x0 = int(rng.integers(0, wd - self.crop_size[1]))
        sl = np.s_[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return (
            np.ascontiguousarray(img1[sl]),
            np.ascontiguousarray(img2[sl]),
            np.ascontiguousarray(flow[sl]),
        )

    def __call__(self, img1, img2, flow, rng):
        img1, img2 = self.color_transform(img1, img2, rng)
        img2 = _eraser(img2, rng, self.eraser_aug_prob)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng)
        return img1, img2, flow


class SparseFlowAugmentor(FlowAugmentor):
    """Sparse (KITTI) augmentor: symmetric colour only, nearest flow resize."""

    sparse = True

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 eraser_aug_prob=0.5, do_rotation=False, max_rotation=10.0):
        super().__init__(crop_size, min_scale, max_scale, do_flip,
                         eraser_aug_prob, do_rotation, max_rotation)
        self.photo_aug = ColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14)

    def color_transform(self, img1, img2, rng):
        stack = self.photo_aug(np.concatenate([img1, img2], axis=0), rng)
        img1, img2 = np.split(stack, 2, axis=0)
        return np.clip(img1, 0.0, 1.0), np.clip(img2, 0.0, 1.0)

    def spatial_transform(self, img1, img2, flow, valid, rng):
        if self.do_rotation:
            (img1, img2), flow, valid = random_rotation(
                [img1, img2], flow, valid, self.max_rotation, rng
            )
        ht, wd = img1.shape[:2]
        sx, sy, _ = self._sample_scales(rng, ht, wd)
        if rng.uniform() < self.spatial_aug_prob:
            t_h, t_w = int(round(ht * sy)), int(round(wd * sx))
            sy, sx = t_h / ht, t_w / wd
            img1 = _resize(img1, t_h, t_w)
            img2 = _resize(img2, t_h, t_w)
            flow = _resize(flow, t_h, t_w, nearest=True) * np.asarray(
                [sx, sy], np.float32
            )
            valid = _resize(valid, t_h, t_w, nearest=True)

        if self.do_flip:
            if rng.uniform() < self.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * np.asarray([-1.0, 1.0], np.float32)
                valid = valid[:, ::-1]
            if rng.uniform() < self.v_flip_prob:
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * np.asarray([1.0, -1.0], np.float32)
                valid = valid[::-1]

        ht, wd = img1.shape[:2]
        y0 = int(rng.integers(0, ht - self.crop_size[0]))
        x0 = int(rng.integers(0, wd - self.crop_size[1]))
        sl = np.s_[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return tuple(np.ascontiguousarray(a[sl]) for a in (img1, img2, flow, valid))

    def __call__(self, img1, img2, flow, valid, rng):
        img1, img2 = self.color_transform(img1, img2, rng)
        img2 = _eraser(img2, rng, self.eraser_aug_prob)
        return self.spatial_transform(img1, img2, flow, valid, rng)


def floor_multiple(x: int, m: int = 8) -> int:
    return (x // m) * m


def _rotation_matrix(center, angle_deg: float) -> np.ndarray:
    """[2, 3] float64 affine map of a rotation by angle_deg (counter-clockwise
    on the screen) about center (x, y), at scale 1."""
    a = np.deg2rad(angle_deg)
    alpha, beta = np.cos(a), np.sin(a)
    cx, cy = center
    return np.asarray([[alpha, beta, (1.0 - alpha) * cx - beta * cy],
                       [-beta, alpha, beta * cx + (1.0 - alpha) * cy]])


def _warp_affine(x: np.ndarray, m: np.ndarray) -> np.ndarray:
    """[H, W, C] warped by the forward map m onto the same [H, W] grid: each
    output pixel is the bilinear sample of x at m's inverse, zero outside.
    As cv2 does, 1, 3 and 4 channels sample at exact positions and 2
    channels at positions in 10-bit fixed point rounded to 1/32 pixel."""
    h, w, c = x.shape
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * det, m[0, 0] * det, -m[0, 1] * det, -m[1, 0] * det
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    if c == 2:
        def fixed(step, row, start):  # 1/32-pixel positions, cv2's WarpAffineInvoker
            pos = (np.rint((row * ys + start) * 1024).astype(np.int64)[:, None] + 16
                   + np.rint(step * xs * 1024).astype(np.int64)[None, :]) >> 5
            return pos >> 5, ((pos & 31) * np.float32(1.0 / 32)).astype(np.float32)

        x0, fx = fixed(a11, a12, b1)
        y0, fy = fixed(a21, a22, b2)
    else:
        sx = a11 * xs[None, :] + a12 * ys[:, None] + b1
        sy = a21 * xs[None, :] + a22 * ys[:, None] + b2
        x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
        fx, fy = (sx - x0).astype(np.float32), (sy - y0).astype(np.float32)
    out = np.zeros((h, w, c), np.float32)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yi, xi = y0 + dy, x0 + dx
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            tap = x[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            out += np.where(inside[..., None], tap, 0.0) * (wy * wx)[..., None]
    return out


def random_rotation(
    images: list[np.ndarray],
    flow: np.ndarray,
    mask: np.ndarray,
    max_rotation: float,
    rng: np.random.Generator,
):
    """Flow-aware random rotation (reference ``uflow/uflow_augmentation.py:211-265``,
    used by the augmentors when do_rotation is enabled): rotates images, the
    flow FIELD, the flow VECTORS, and renormalizes by the rotated mask so border
    fill doesn't bleed into valid flow."""
    angle_deg = rng.uniform(-max_rotation, max_rotation)
    a = np.deg2rad(angle_deg)
    h, w = images[0].shape[:2]
    m = _rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle_deg)

    def rot(x):
        return _warp_affine(x if x.ndim == 3 else x[:, :, None], m)

    images = [rot(im) for im in images]
    # mask-weighted flow rotation: rotate flow*mask and mask, renormalize
    fm = rot(flow * mask)
    mm = rot(mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        flow = np.where(mm > 0, fm / np.maximum(mm, 1e-12), 0.0)
    mask = (mm > 0.999).astype(np.float32)
    # rotate the flow vectors themselves
    cos, sin = np.cos(a), np.sin(a)
    fx = cos * flow[..., 0] + sin * flow[..., 1]
    fy = -sin * flow[..., 0] + cos * flow[..., 1]
    flow = np.stack([fx, fy], axis=-1).astype(np.float32)
    return images, flow, mask


class MultiFrameAugmentor(SparseFlowAugmentor):
    """Triplet augmentor (reference augmentor.py:338-499): shared color jitter
    over 3 frames (asymmetric prob 0.2), eraser on frames 1 and 3, one spatial
    transform applied to both flows, keeps the pre-crop full frames + offsets."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 eraser_aug_prob=0.5):
        super().__init__(crop_size, min_scale, max_scale, do_flip, eraser_aug_prob)
        self.asymmetric_color_aug_prob = 0.2

    def __call__(self, img1, img2, img3, flow1, valid1, flow2, valid2, rng):
        if rng.uniform() < self.asymmetric_color_aug_prob:
            img1 = self.photo_aug(img1, rng)
            img2 = self.photo_aug(img2, rng)
            img3 = self.photo_aug(img3, rng)
        else:
            stack = self.photo_aug(np.concatenate([img1, img2, img3], axis=0), rng)
            img1, img2, img3 = np.split(stack, 3, axis=0)
        img1, img2, img3 = (np.clip(x, 0.0, 1.0) for x in (img1, img2, img3))
        img1 = _eraser(img1, rng, self.eraser_aug_prob)
        img3 = _eraser(img3, rng, self.eraser_aug_prob)

        ht, wd = img1.shape[:2]
        sx, sy, _ = self._sample_scales(rng, ht, wd)
        f_imgs = [img1, img2, img3]
        f_flows, f_valids = [flow1, flow2], [valid1, valid2]
        if rng.uniform() < self.spatial_aug_prob:
            t_h, t_w = int(round(ht * sy)), int(round(wd * sx))
            sy, sx = t_h / ht, t_w / wd
            imgs = [_resize(x, t_h, t_w) for x in (img1, img2, img3)]
            flows = [
                _resize(f, t_h, t_w, nearest=True) * np.asarray([sx, sy], np.float32)
                for f in (flow1, flow2)
            ]
            valids = [_resize(v, t_h, t_w, nearest=True) for v in (valid1, valid2)]
            y0 = int(rng.integers(0, t_h - ht))
            x0 = int(rng.integers(0, t_w - wd))
            sl = np.s_[y0 : y0 + ht, x0 : x0 + wd]
            f_imgs = [x[sl] for x in imgs]
            f_flows = [f[sl] for f in flows]
            f_valids = [v[sl] for v in valids]
        if self.do_flip:
            if rng.uniform() < self.h_flip_prob:
                f_imgs = [x[:, ::-1] for x in f_imgs]
                f_flows = [f[:, ::-1] * np.asarray([-1.0, 1.0], np.float32) for f in f_flows]
                f_valids = [v[:, ::-1] for v in f_valids]
            if rng.uniform() < self.v_flip_prob:
                f_imgs = [x[::-1] for x in f_imgs]
                f_flows = [f[::-1] * np.asarray([1.0, -1.0], np.float32) for f in f_flows]
                f_valids = [v[::-1] for v in f_valids]

        ht, wd = f_imgs[0].shape[:2]
        y0 = int(rng.integers(0, ht - self.crop_size[0]))
        x0 = int(rng.integers(0, wd - self.crop_size[1]))
        sl = np.s_[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        crops = [np.ascontiguousarray(x[sl]).astype(np.float32) for x in f_imgs]
        flows = [np.ascontiguousarray(f[sl]).astype(np.float32) for f in f_flows]
        valids = [np.ascontiguousarray(v[sl]).astype(np.float32) for v in f_valids]
        return {
            "image1": crops[0], "image2": crops[1], "image3": crops[2],
            "flow1": flows[0], "valid1": valids[0],
            "flow2": flows[1], "valid2": valids[1],
            "orig_image1": np.ascontiguousarray(f_imgs[0]).astype(np.float32),
            "orig_image2": np.ascontiguousarray(f_imgs[1]).astype(np.float32),
            "orig_image3": np.ascontiguousarray(f_imgs[2]).astype(np.float32),
            "crop_yx": np.asarray([y0, x0], np.int32),
        }


class UnsupAugmentor(SparseFlowAugmentor):
    """Full-size frame + 8-aligned crop augmentor for unsup/semi training."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True,
                 eraser_aug_prob=0.5, full_size=None, do_rotation=False,
                 max_rotation=10.0):
        super().__init__(crop_size, min_scale, max_scale, do_flip,
                         eraser_aug_prob, do_rotation, max_rotation)
        self.full_size = tuple(full_size) if full_size is not None else None
        self.asymmetric_color_aug_prob = 0.2
        self.photo_aug = ColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14)

    def color_transform(self, img1, img2, rng):
        return FlowAugmentor.color_transform(self, img1, img2, rng)

    def _full_size_for(self, ht, wd):
        inst = (floor_multiple(ht), floor_multiple(wd))
        if self.full_size is None:
            return inst
        return (min(inst[0], self.full_size[0]), min(inst[1], self.full_size[1]))

    def spatial_transform(self, img1, img2, flow, valid, rng):
        if self.do_rotation:
            (img1, img2), flow, valid = random_rotation(
                [img1, img2], flow, valid, self.max_rotation, rng
            )
        ht, wd = img1.shape[:2]
        if self.full_size is not None and (ht < self.full_size[0] or wd < self.full_size[1]):
            # every example has the frame size: upscale sources smaller than full_size
            s = max(self.full_size[0] / ht, self.full_size[1] / wd)
            t_h, t_w = int(np.ceil(ht * s)), int(np.ceil(wd * s))
            img1 = _resize(img1, t_h, t_w)
            img2 = _resize(img2, t_h, t_w)
            flow = _resize(flow, t_h, t_w, nearest=True) * np.asarray(
                [t_w / wd, t_h / ht], np.float32
            )
            valid = _resize(valid, t_h, t_w, nearest=True)
            ht, wd = t_h, t_w
        full_size = self._full_size_for(ht, wd)

        min_scale = max(
            (self.crop_size[0] + 8.0) / full_size[0],
            (self.crop_size[1] + 8.0) / full_size[1],
        )
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.uniform() < self.stretch_prob:
            sx *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        sx, sy = max(sx, min_scale), max(sy, min_scale)

        if rng.uniform() < self.spatial_aug_prob:
            t_h, t_w = int(round(ht * sy)), int(round(wd * sx))
            t_h, t_w = max(t_h, full_size[0]), max(t_w, full_size[1])
            sy, sx = t_h / ht, t_w / wd
            img1 = _resize(img1, t_h, t_w)
            img2 = _resize(img2, t_h, t_w)
            flow = _resize(flow, t_h, t_w, nearest=True) * np.asarray(
                [sx, sy], np.float32
            )
            valid = _resize(valid, t_h, t_w, nearest=True)
            ht, wd = t_h, t_w

        y0 = int(rng.integers(0, ht - full_size[0] + 1))
        x0 = int(rng.integers(0, wd - full_size[1] + 1))
        sl = np.s_[y0 : y0 + full_size[0], x0 : x0 + full_size[1]]
        f_img1, f_img2 = img1[sl], img2[sl]
        f_flow, f_valid = flow[sl], valid[sl]

        if self.do_flip:
            if rng.uniform() < self.h_flip_prob:
                f_img1, f_img2 = f_img1[:, ::-1], f_img2[:, ::-1]
                f_flow = f_flow[:, ::-1] * np.asarray([-1.0, 1.0], np.float32)
                f_valid = f_valid[:, ::-1]
            if rng.uniform() < self.v_flip_prob:
                f_img1, f_img2 = f_img1[::-1], f_img2[::-1]
                f_flow = f_flow[::-1] * np.asarray([1.0, -1.0], np.float32)
                f_valid = f_valid[::-1]

        fh, fw = f_img1.shape[:2]
        y0 = int(rng.integers(0, (fh - self.crop_size[0]) // 8 + 1)) * 8
        x0 = int(rng.integers(0, (fw - self.crop_size[1]) // 8 + 1)) * 8
        sl = np.s_[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return (
            np.ascontiguousarray(f_img1[sl]),
            np.ascontiguousarray(f_img2[sl]),
            np.ascontiguousarray(f_flow[sl]),
            np.ascontiguousarray(f_valid[sl]),
            np.ascontiguousarray(f_img1),
            np.ascontiguousarray(f_img2),
            np.ascontiguousarray(f_flow),
            np.ascontiguousarray(f_valid),
            x0,
            y0,
        )

    def __call__(self, img1, img2, flow, valid, rng):
        (c1, c2, cf, cv, f1, f2, ff, fv, x0, y0) = self.spatial_transform(
            img1, img2, flow, valid, rng
        )
        c1, c2 = self.color_transform(c1, c2, rng)
        c2 = _eraser(c2, rng, self.eraser_aug_prob)
        return {
            "image1": np.clip(c1, 0.0, 1.0).astype(np.float32),
            "image2": np.clip(c2, 0.0, 1.0).astype(np.float32),
            "flow": cf.astype(np.float32),
            "valid": cv.astype(np.float32),
            "orig_image1": f1.astype(np.float32),
            "orig_image2": f2.astype(np.float32),
            "orig_flow": ff.astype(np.float32),
            "orig_valid": fv.astype(np.float32),
            "crop_yx": np.asarray([y0, x0], np.int32),
        }
