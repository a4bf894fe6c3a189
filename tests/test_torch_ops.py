"""The port's ops against the JAX package's, on the same numpy inputs.

Sampling, pooling and padding are exact or within 1e-6; the upsamplers
within 1e-5 (their fp32 sums run in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.ops import flow_ops as jflow
from raft_tpu.ops import padding as jpad
from raft_tpu.ops import pooling as jpool
from raft_tpu.ops import sampling as jsamp
from raft_tpu_torch.ops import flow_ops, padding, pooling, sampling


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Run the port's CPU ops on one thread: the suite runs in parallel
    workers, and torch's default of one thread per core oversubscribes the
    host for tests that are timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_coords_grid_and_initialize_flow():
    want = np.asarray(jsamp.coords_grid(2, 5, 7))
    np.testing.assert_array_equal(sampling.coords_grid(2, 5, 7).numpy(), want)
    c0, c1 = flow_ops.initialize_flow(2, 5, 7)
    j0, j1 = jflow.initialize_flow(2, 5, 7)
    np.testing.assert_array_equal(c0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(j1))


@pytest.mark.parametrize("spread", [1.0, 6.0])
def test_bilinear_sampler_matches_jax(spread):
    """Includes points far outside the image (zeros padding)."""
    rng = np.random.RandomState(int(spread))
    img = rng.randn(2, 9, 13, 5).astype(np.float32)
    coords = (rng.rand(2, 4, 6, 2) * [13, 9] + spread * rng.randn(2, 4, 6, 2))
    coords = coords.astype(np.float32)
    want = np.asarray(jsamp.bilinear_sampler(jnp.asarray(img),
                                             jnp.asarray(coords)))
    got = sampling.bilinear_sampler(_t(img), _t(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(8, 12), (55, 128), (7, 9)])
def test_avg_pool2x2_matches_jax(hw):
    rng = np.random.RandomState(sum(hw))
    x = rng.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jpool.avg_pool2x2(jnp.asarray(x)))
    got = pooling.avg_pool2x2(_t(x)).numpy()
    assert got.shape == want.shape == (2, hw[0] // 2, hw[1] // 2, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw", [(436, 1024), (375, 1242), (64, 64)])
def test_input_padder_matches_jax(mode, hw):
    rng = np.random.RandomState(0)
    x = rng.rand(1, *hw, 3).astype(np.float32)
    jp = jpad.InputPadder(x.shape, mode=mode)
    tp = padding.InputPadder(x.shape, mode=mode)
    assert tp._pad == jp._pad
    want = np.asarray(jp.pad(jnp.asarray(x)))
    got = tp.pad(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] % 8 == 0 and got.shape[2] % 8 == 0
    np.testing.assert_array_equal(tp.unpad(_t(got)).numpy(), x)


def test_upflow8_matches_jax():
    rng = np.random.RandomState(1)
    flow = (4 * rng.randn(2, 6, 9, 2)).astype(np.float32)
    want = np.asarray(jflow.upflow8(jnp.asarray(flow)))
    got = flow_ops.upflow8(_t(flow)).numpy()
    assert got.shape == (2, 48, 72, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resize_bilinear_align_corners_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(1, 5, 7, 3).astype(np.float32)
    for out_hw in [(9, 13), (1, 4), (5, 7)]:
        want = np.asarray(jflow.resize_bilinear_align_corners(
            jnp.asarray(x), out_hw))
        got = flow_ops.resize_bilinear_align_corners(_t(x), out_hw).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_convex_upsample_matches_jax():
    rng = np.random.RandomState(3)
    flow = (4 * rng.randn(2, 5, 7, 2)).astype(np.float32)
    mask = (2 * rng.randn(2, 5, 7, 576)).astype(np.float32)
    want = np.asarray(jflow.convex_upsample(jnp.asarray(flow),
                                            jnp.asarray(mask)))
    got = flow_ops.convex_upsample(_t(flow), _t(mask)).numpy()
    assert got.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
