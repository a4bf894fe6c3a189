"""Photometric and spatial augmentation for dense and sparse flow, port of
``raft_tpu/data/augmentor.py`` in numpy, without cv2.

The card's machine has neither cv2 nor PIL, so each cv2 call of the JAX
augmentor is an explicit function here with cv2's semantics for uint8:

- :func:`resize_linear` is ``cv2.resize(..., fx, fy, INTER_LINEAR)``: output
  size ``round(w·fx) x round(h·fy)``, half-pixel centres, edge clamping,
  and for uint8 cv2's fixed-point arithmetic (11-bit weights, the
  horizontal pass in integers, the vertical pass as its vector code does
  it: ``((S0>>4)·b0 >> 16) + ((S1>>4)·b1 >> 16) + 2 >> 2``), and a copy
  when the rounded size equals the input's. For uint8 and float32 alike it
  equals cv2 bitwise on the tests' inputs.
- :func:`grayscale` is ``COLOR_RGB2GRAY`` (15-bit fixed point, bitwise).
- :func:`rgb_to_hsv` is ``COLOR_RGB2HSV`` for uint8, H in [0, 180)
  (cv2's 12-bit division tables, bitwise); :func:`hsv_to_rgb` is
  ``COLOR_HSV2RGB`` by its float formula, truncated to uint8. cv2's own
  build may round elsewhere: it is held within one level of cv2.
- ``cv2.LUT`` is a table index, ``cv2.mean`` an exact float64 mean,
  ``cv2.addWeighted`` a float32 blend rounded to nearest and saturated.

All randomness goes through an ``np.random.RandomState`` in the JAX
augmentor's order (scale, stretch, flip, crop and eraser draws), so the same
seed gives the same geometry in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# cv2.resize's INTER_RESIZE_COEF_SCALE: 11-bit fixed-point weights
_COEF_SCALE = 2048


def _resize_taps(n_in: int, n_out: int, scale_inv: float, clamp: bool):
    """Source taps and fractions of one axis (cv2's ``resizeGeneric_``
    setup): float32 fraction of ``(d+0.5)/scale_inv - 0.5``; the columns'
    out-of-range taps clamp their fraction to 0, the rows' only their
    index."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / scale_inv) - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp:
        lo, hi = s < 0, s >= n_in - 1
        f[lo | hi] = 0
        s[lo] = 0
        s[hi] = n_in - 1
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), f


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=fx, fy=fy, interpolation=INTER_LINEAR)``
    for (H, W, C) uint8 or float32."""
    h, w = img.shape[:2]
    W, H = int(np.rint(w * fx)), int(np.rint(h * fy))
    if (H, W) == (h, w):
        return img.copy()      # cv2 copies when the size does not change
    x0, x1, a = _resize_taps(w, W, fx, True)
    y0, y1, b = _resize_taps(h, H, fy, False)
    one = np.float32(1)
    if img.dtype == np.uint8:
        ia0 = np.rint((one - a) * _COEF_SCALE).astype(np.int32)
        ia1 = np.rint(a * _COEF_SCALE).astype(np.int32)
        ib0 = np.rint((one - b) * _COEF_SCALE).astype(np.int32)
        ib1 = np.rint(b * _COEF_SCALE).astype(np.int32)
        x = img.astype(np.int32)
        d = x[:, x0] * ia0[None, :, None] + x[:, x1] * ia1[None, :, None]
        d >>= 4
        out = (((d[y0] * ib0[:, None, None]) >> 16)
               + ((d[y1] * ib1[:, None, None]) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    if img.dtype != np.float32:
        raise ValueError(f"resize_linear takes uint8 or float32, got "
                         f"{img.dtype}")
    d = img[:, x0] * (one - a)[None, :, None] + img[:, x1] * a[None, :, None]
    return (d[y0] * (one - b)[:, None, None]
            + d[y1] * b[:, None, None]).astype(np.float32)


def grayscale(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2GRAY)``: ITU-R 601 luma, uint8."""
    x = img.astype(np.int32)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735
             + (1 << 14)) >> 15).astype(np.uint8)


_HSV_SHIFT = 12
_I = np.arange(256)
_SDIV = np.where(_I == 0, 0, np.rint(
    (255 << _HSV_SHIFT) / np.maximum(_I, 1))).astype(np.int32)
_HDIV = np.where(_I == 0, 0, np.rint(
    (180 << _HSV_SHIFT) / (6.0 * np.maximum(_I, 1)))).astype(np.int32)


def _hue_weights() -> np.ndarray:
    """(180, 3) float32: for each uint8 hue, the weight w of each of R, G,
    B in ``v·(1 - s·w)``. cv2 picks each channel from (v, v(1-s), v(1-sf),
    v(1-s(1-f))) by the hue's sector, i.e. w in (0, 1, f, 1-f), f the
    hue's fraction in its sector, computed in float32 as cv2 does."""
    h = np.arange(180, dtype=np.float32) * np.float32(6.0 / 180.0)
    sector = np.floor(h)
    f = h - sector
    one = np.float32(1)
    w = np.stack([np.zeros_like(f), np.ones_like(f), f, one - f], -1)
    # (b, g, r) pick from the four per sector, as cv2's sector table
    picks = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                      [2, 1, 0]])[sector.astype(np.int64) % 6]
    return np.take_along_axis(w, picks, -1)[:, ::-1].copy()


_HUE_W = _hue_weights()


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` for uint8: H in [0, 180)."""
    r, g, b = (img[..., k].astype(np.int32) for k in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` for uint8 (H in [0, 180)):
    cv2's float formula ``v·(1 - s·w)`` (see :func:`_hue_weights`),
    truncated to uint8."""
    s = hsv[..., 1:2].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2:3].astype(np.float32)
    out = v * (np.float32(1) - s * _HUE_W[hsv[..., 0]])
    return np.clip(np.floor(out), 0, 255).astype(np.uint8)


def _blend_scalar(a: np.ndarray, b: float, factor: float) -> np.ndarray:
    """``factor·a + (1-factor)·b`` as the JAX augmentor's 256-entry table."""
    lut = np.clip(factor * np.arange(256, dtype=np.float32)
                  + (1.0 - factor) * np.float32(b), 0, 255).astype(np.uint8)
    return lut[a]


def adjust_brightness(img, factor):
    return _blend_scalar(img, 0.0, factor)


def adjust_contrast(img, factor):
    mean = float(grayscale(img).mean(dtype=np.float64))
    return _blend_scalar(img, mean, factor)


def adjust_saturation(img, factor):
    """``cv2.addWeighted(img, f, gray3, 1-f, 0)``."""
    gray = grayscale(img).astype(np.float32)[..., None]
    out = (img.astype(np.float32) * np.float32(factor)
           + gray * np.float32(1.0 - factor) + np.float32(0.0))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def adjust_hue(img, factor):
    """factor in [-0.5, 0.5]: a fraction of the hue circle (PIL semantics),
    added to H mod 180."""
    hsv = rgb_to_hsv(img)
    shift = int(factor * 180.0) % 180
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + shift) % 180
    return hsv_to_rgb(hsv)


def _channel_mean(img: np.ndarray) -> np.ndarray:
    """``cv2.mean(img)[:3]``: exact float64 means of the uint8 channels."""
    return img.reshape(-1, img.shape[-1]).mean(0, dtype=np.float64)[:3]


class ColorJitter:
    """torchvision-style jitter: random factors, random op order."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img: np.ndarray,
                 rng: np.random.RandomState) -> np.ndarray:
        ops = []
        if self.brightness > 0:
            f = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda x, f=f: adjust_brightness(x, f))
        if self.contrast > 0:
            f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda x, f=f: adjust_contrast(x, f))
        if self.saturation > 0:
            f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda x, f=f: adjust_saturation(x, f))
        if self.hue > 0:
            f = rng.uniform(-self.hue, self.hue)
            ops.append(lambda x, f=f: adjust_hue(x, f))
        for i in rng.permutation(len(ops)):
            img = ops[i](img)
        return img


class FlowAugmentor:
    """Dense-GT augmentation (augmentor.py:15-120)."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = True,
                 rng: Optional[np.random.RandomState] = None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2

        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1

        self.photo_aug = ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

        self.rng = rng if rng is not None else np.random.RandomState()

    def reseed(self, seed: int):
        self.rng = np.random.RandomState(seed)

    def color_transform(self, img1, img2):
        if self.rng.rand() < self.asymmetric_color_aug_prob:
            img1 = self.photo_aug(img1, self.rng)
            img2 = self.photo_aug(img2, self.rng)
        else:
            stack = np.concatenate([img1, img2], axis=0)
            stack = self.photo_aug(stack, self.rng)
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        """Occlusion: rectangles of img2 -> mean color (augmentor.py:52-65)."""
        ht, wd = img1.shape[:2]
        if self.rng.rand() < self.eraser_aug_prob:
            mean_color = _channel_mean(img2)
            for _ in range(self.rng.randint(1, 3)):
                x0 = self.rng.randint(0, wd)
                y0 = self.rng.randint(0, ht)
                dx = self.rng.randint(bounds[0], bounds[1])
                dy = self.rng.randint(bounds[0], bounds[1])
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    def spatial_transform(self, img1, img2, flow):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 8) / float(ht),
            (self.crop_size[1] + 8) / float(wd))

        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if self.rng.rand() < self.stretch_prob:
            scale_x *= 2 ** self.rng.uniform(-self.max_stretch,
                                             self.max_stretch)
            scale_y *= 2 ** self.rng.uniform(-self.max_stretch,
                                             self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        # flow's scalar multiplies (resize rescale, flip signs) come after
        # the crop, in the JAX augmentor's order
        flow_scales = []
        if self.rng.rand() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow = resize_linear(flow, scale_x, scale_y)
            flow_scales.append(np.array([scale_x, scale_y], np.float32))

        if self.do_flip:
            if self.rng.rand() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1]
                flow_scales.append(np.array([-1.0, 1.0], np.float32))
            if self.rng.rand() < self.v_flip_prob:
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :]
                flow_scales.append(np.array([1.0, -1.0], np.float32))

        y0 = self.rng.randint(0, img1.shape[0] - self.crop_size[0])
        x0 = self.rng.randint(0, img1.shape[1] - self.crop_size[1])

        img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        img2 = img2[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        for s in flow_scales:
            flow = flow * s
        return img1, img2, flow

    def __call__(self, img1, img2, flow):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow = self.spatial_transform(img1, img2, flow)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


class SparseFlowAugmentor:
    """Sparse-GT augmentation for KITTI/HD1K (augmentor.py:122-246)."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8

        self.do_flip = do_flip

        self.photo_aug = ColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14)
        self.eraser_aug_prob = 0.5

        self.rng = rng if rng is not None else np.random.RandomState()

    def reseed(self, seed: int):
        self.rng = np.random.RandomState(seed)

    def color_transform(self, img1, img2):
        # the sparse path is always symmetric (augmentor.py:142-146)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo_aug(stack, self.rng)
        img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2):
        ht, wd = img1.shape[:2]
        if self.rng.rand() < self.eraser_aug_prob:
            mean_color = _channel_mean(img2)
            for _ in range(self.rng.randint(1, 3)):
                x0 = self.rng.randint(0, wd)
                y0 = self.rng.randint(0, ht)
                dx = self.rng.randint(50, 100)
                dy = self.rng.randint(50, 100)
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    def resize_sparse_flow_map(self, flow, valid, fx=1.0, fy=1.0):
        """Nearest-point scatter rescale of sparse flow (augmentor.py:161-193)."""
        ht, wd = flow.shape[:2]
        coords = np.meshgrid(np.arange(wd), np.arange(ht))
        coords = np.stack(coords, axis=-1).reshape(-1, 2).astype(np.float32)

        flow = flow.reshape(-1, 2).astype(np.float32)
        valid = valid.reshape(-1).astype(np.float32)

        coords0 = coords[valid >= 1]
        flow0 = flow[valid >= 1]

        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))

        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]

        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)

        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        xx, yy, flow1 = xx[v], yy[v], flow1[v]

        flow_img = np.zeros([ht1, wd1, 2], dtype=np.float32)
        valid_img = np.zeros([ht1, wd1], dtype=np.int32)
        flow_img[yy, xx] = flow1
        valid_img[yy, xx] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 1) / float(ht),
            (self.crop_size[1] + 1) / float(wd))

        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)

        if self.rng.rand() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow, valid = self.resize_sparse_flow_map(flow, valid,
                                                      fx=scale_x, fy=scale_y)

        if self.do_flip:
            if self.rng.rand() < 0.5:  # h-flip only (augmentor.py:213-218)
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
                valid = valid[:, ::-1]

        margin_y, margin_x = 20, 50
        y0 = self.rng.randint(0, img1.shape[0] - self.crop_size[0] + margin_y)
        x0 = self.rng.randint(-margin_x,
                              img1.shape[1] - self.crop_size[1] + margin_x)
        y0 = np.clip(y0, 0, img1.shape[0] - self.crop_size[0])
        x0 = np.clip(x0, 0, img1.shape[1] - self.crop_size[1])

        img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        img2 = img2[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        valid = valid[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1, img2, flow, valid

    def __call__(self, img1, img2, flow, valid):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow,
                                                         valid)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))
