"""The port's numpy augmentors against ``raft_tpu``'s cv2 ones.

- cv2's pieces, one by one: ``resize_linear`` equals ``cv2.resize(...,
  INTER_LINEAR)`` bitwise for uint8 and float32 at up- and down-scales,
  ``grayscale`` and ``rgb_to_hsv`` equal cv2's conversions bitwise, and
  brightness, contrast and saturation equal the JAX functions bitwise.
  ``hsv_to_rgb`` follows cv2's float formula; cv2's own build rounds
  elsewhere on some pixels, so it is held within one level, as is the hue
  adjustment.
- The whole augmentors, dense (chairs stage) and sparse (KITTI stage), from
  the same ``RandomState`` seed on crops of the demo frames: the draws are
  the same (the RNG ends in the same state), flow within 1e-4 px (the
  geometry: scale, stretch, flip, crop), sparse ``valid`` masks equal, and
  images within 3 uint8 levels: one level from the hue step, which a
  later contrast, saturation and brightness factor (each up to 1.4) can
  carry to 1.4³ < 3. Under 10% of a sample's pixels differ, and the mean
  absolute difference is under 0.1 level (seen over 40 seeds: 3 levels,
  2.6% of a sample's pixels and 0.026 level at most). An eraser rectangle
  or crop in another place would break these by far.
"""

import glob
import os.path as osp

import numpy as np
import pytest

import cv2
from raft_tpu.data import augmentor as jaug
from raft_tpu_torch.data import augmentor as aug
from raft_tpu_torch.data.png import read_png

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FRAMES = sorted(glob.glob(osp.join(REPO, "demo-frames", "*.png")))
IMAGE_LEVELS = 3
IMAGE_SHARE = 0.10
IMAGE_MEAN = 0.1
FLOW_TOL = 1e-4


@pytest.fixture(scope="module")
def frames():
    return [read_png(f) for f in FRAMES[:4]]


def _rand(seed, shape, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return (10 * rng.randn(*shape)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("fx,fy", [(1.37, 1.21), (0.83, 1.9), (2.0, 2.0),
                                   (0.71, 0.64), (1.0, 1.0022)])
def test_resize_linear_equals_cv2(dtype, fx, fy):
    img = _rand(3, (47, 61, 3 if dtype == np.uint8 else 2), dtype)
    want = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    got = aug.resize_linear(img, fx, fy)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_color_conversions_against_cv2(frames):
    img = np.concatenate([frames[0][:64, :96], _rand(4, (64, 96, 3))])
    np.testing.assert_array_equal(aug.grayscale(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(aug.rgb_to_hsv(img), hsv)
    d = np.abs(aug.hsv_to_rgb(hsv).astype(int)
               - cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    assert d.max() <= 1


@pytest.mark.parametrize("factor", [0.6, 1.0, 1.4])
def test_photometric_ops_match_jax(frames, factor):
    img = frames[1][100:164, 200:296]
    for name in ("brightness", "contrast", "saturation"):
        np.testing.assert_array_equal(
            getattr(aug, f"adjust_{name}")(img, factor),
            getattr(jaug, f"adjust_{name}")(img, factor), err_msg=name)
    hue = (factor - 1.0) * 0.4
    d = np.abs(aug.adjust_hue(img, hue).astype(int)
               - jaug.adjust_hue(img, hue))
    assert d.max() <= 1


def _hold_images(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        d = np.abs(g.astype(int) - w)
        assert d.max() <= IMAGE_LEVELS
        assert (d > 0).mean() < IMAGE_SHARE and d.mean() < IMAGE_MEAN


def _pair(frames, seed):
    y, x = 50 + 3 * seed, 100 + 7 * seed
    i = seed % 3
    img1 = frames[i][y:y + 160, x:x + 224].copy()
    img2 = frames[i + 1][y:y + 160, x:x + 224].copy()
    rng = np.random.RandomState(100 + seed)
    flow = (5 * rng.randn(160, 224, 2)).astype(np.float32)
    valid = (rng.rand(160, 224) > 0.4).astype(np.float32)
    return img1, img2, flow, valid


@pytest.mark.parametrize("seed", range(8))
def test_flow_augmentor_matches_jax(frames, seed):
    img1, img2, flow, _ = _pair(frames, seed)
    kw = dict(crop_size=(96, 128), min_scale=-0.1, max_scale=1.0,
              do_flip=True)
    ja = jaug.FlowAugmentor(**kw, rng=np.random.RandomState(seed))
    pa = aug.FlowAugmentor(**kw, rng=np.random.RandomState(seed))
    want = ja(img1.copy(), img2.copy(), flow.copy())
    got = pa(img1.copy(), img2.copy(), flow.copy())
    assert ja.rng.randint(2 ** 30) == pa.rng.randint(2 ** 30)
    assert got[2].shape == (96, 128, 2)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=FLOW_TOL)
    _hold_images(got[:2], want[:2])


@pytest.mark.parametrize("seed", range(8))
def test_sparse_flow_augmentor_matches_jax(frames, seed):
    img1, img2, flow, valid = _pair(frames, seed)
    kw = dict(crop_size=(96, 128), min_scale=-0.2, max_scale=0.4,
              do_flip=True)
    ja = jaug.SparseFlowAugmentor(**kw, rng=np.random.RandomState(seed))
    pa = aug.SparseFlowAugmentor(**kw, rng=np.random.RandomState(seed))
    want = ja(img1.copy(), img2.copy(), flow.copy(), valid.copy())
    got = pa(img1.copy(), img2.copy(), flow.copy(), valid.copy())
    assert ja.rng.randint(2 ** 30) == pa.rng.randint(2 ** 30)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=FLOW_TOL)
    _hold_images(got[:2], want[:2])


def test_reseed_replays_the_augmentation(frames):
    img1, img2, flow, _ = _pair(frames, 0)
    pa = aug.FlowAugmentor((96, 128), -0.1, 1.0, True)
    out = []
    for _ in range(2):
        pa.reseed(7)
        out.append(pa(img1.copy(), img2.copy(), flow.copy()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
