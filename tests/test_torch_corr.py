"""The port's correlation volume and plain lookup against the JAX package.

The plain lookup (``models.corr.corr_lookup_gather``) is held within 1e-5
of both JAX lookups — the Pallas kernel (``corr_lookup_pallas``, interpret
mode) and the gather formulation (``corr_lookup``) — at r=3 and r=4, on a
non-square grid, with coords far outside the volume, for fp32 and bf16
volumes. On the CPU the kernel wrapper and every ``corr_impl`` run that
plain version and launch nothing.

The backward of ``CorrLookup`` (on the CPU, ``corr_lookup_bwd_plain``, the
VJP of the plain lookup) is held against the VJP of ``corr_lookup_pallas``
(``_scatter_kernel``, interpret mode): within 1e-5 for fp32 volumes, and
for bf16 volumes within one bf16 ulp (both round an fp32 sum, taken in
another order, once to bf16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.kernels import corr_pallas
from raft_tpu.models import corr as jcorr
from raft_tpu_torch import kernels
from raft_tpu_torch.kernels.corr_lookup import corr_lookup_cuda
from raft_tpu_torch.models import corr

H, W, C = 8, 12, 32          # 1/8 grid; levels 8x12, 4x6, 2x3, 1x1


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Run the port's CPU ops on one thread: the suite runs in parallel
    workers, and torch's default of one thread per core oversubscribes the
    host for tests that are timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(corr_pallas, "_INTERPRET", True)


def _fmaps(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, H, W, C).astype(np.float32) for _ in range(2)]


def _coords(seed=1):
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    c = np.stack([xs, ys], -1)[None] + 3.0 * rng.randn(1, H, W, 2)
    far = rng.rand(1, H, W, 1) < 0.15
    c = np.where(far, c + 40.0 * np.sign(rng.randn(1, H, W, 2)), c)
    return c.astype(np.float32)


def test_all_pairs_correlation_and_pyramid_match_jax():
    f1, f2 = _fmaps()
    want = [np.asarray(v) for v in jcorr.build_corr_pyramid(
        jnp.asarray(f1), jnp.asarray(f2), 4)]
    got = [v.numpy() for v in corr.build_corr_pyramid(
        torch.from_numpy(f1), torch.from_numpy(f2), 4)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].shape == (1, H * W, H, W) and got[3].shape[2:] == (1, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("radius,dtype", [(4, "float32"), (3, "float32"),
                                          (4, "bfloat16"), (3, "bfloat16")])
def test_plain_lookup_matches_jax(radius, dtype):
    f1, f2 = _fmaps()
    coords = _coords()
    jpyr = [v.astype(dtype) for v in jcorr.build_corr_pyramid(
        jnp.asarray(f1), jnp.asarray(f2), 4)]
    # the same stored values on both sides: the JAX pyramid, rounded once
    pyr = [torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for v in jpyr]
    got = corr.corr_lookup_gather(pyr, torch.from_numpy(coords), radius)
    assert got.dtype == torch.float32
    assert got.shape == (1, H, W, 4 * (2 * radius + 1) ** 2)
    for jfn in (corr_pallas.corr_lookup_pallas, jcorr.corr_lookup):
        want = np.asarray(jfn(jpyr, jnp.asarray(coords), radius))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=jfn.__name__)


@pytest.mark.parametrize("corr_impl", ["gather", "onehot", "onehot_t",
                                       "softsel", "softsel_t", "pallas"])
def test_cpu_lookup_is_plain_and_launches_nothing(corr_impl):
    f1, f2 = _fmaps(2)
    pyr = corr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    coords = torch.from_numpy(_coords(3))
    before = kernels.launch_counts()
    got = corr.corr_lookup(pyr, coords, 4, corr_impl)
    assert kernels.launch_counts() == before
    torch.testing.assert_close(got, corr.corr_lookup_gather(pyr, coords, 4),
                               rtol=0, atol=0)
    torch.testing.assert_close(corr_lookup_cuda(pyr, coords, 4), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("radius", [4, 3])
def test_empty_levels_read_as_zeros_like_jax(radius):
    """A 3x5 grid: levels 3x5, 1x2, 0x1 and 0x0. Both packages pool to the
    same empty levels, and both lookups read them as zeros."""
    rng = np.random.RandomState(4)
    f1, f2 = [rng.randn(1, 3, 5, C).astype(np.float32) for _ in range(2)]
    coords = (rng.rand(1, 3, 5, 2) * 8 - 2).astype(np.float32)
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    pyr = corr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    assert [tuple(v.shape) for v in pyr] == [v.shape for v in jpyr]
    assert [v.shape[2:] for v in pyr][2:] == [(0, 1), (0, 0)]
    got = corr.corr_lookup(pyr, torch.from_numpy(coords), radius, "pallas")
    KK = (2 * radius + 1) ** 2
    assert got.shape == (1, 3, 5, 4 * KK)
    assert not got[..., 2 * KK:].any() and got[..., :KK].abs().max() > 0
    for jfn in (corr_pallas.corr_lookup_pallas, jcorr.corr_lookup):
        want = np.asarray(jfn(jpyr, jnp.asarray(coords), radius))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=jfn.__name__)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius", [4, 3])
@pytest.mark.parametrize("grid", [(8, 12), (3, 5)])
def test_lookup_backward_matches_jax_pallas_vjp(grid, radius, dtype):
    """A non-square 8x12 grid and a 3x5 grid whose last two levels are
    empty; a tenth of the queries 60 px out of range."""
    h, w = grid
    rng = np.random.RandomState(h * w + radius)
    f1, f2 = [rng.randn(1, h, w, C).astype(np.float32) for _ in range(2)]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c = np.stack([xs, ys], -1)[None] + 3.0 * rng.randn(1, h, w, 2)
    far = rng.rand(1, h, w, 1) < 0.1
    coords = np.where(far, c + 60.0 * np.sign(rng.randn(1, h, w, 2)),
                      c).astype(np.float32)
    K2 = (2 * radius + 1) ** 2
    g = rng.randn(1, h, w, 4 * K2).astype(np.float32)
    jpyr = [v.astype(dtype) for v in jcorr.build_corr_pyramid(
        jnp.asarray(f1), jnp.asarray(f2), 4)]
    _, vjp = jax.vjp(lambda p: corr_pallas.corr_lookup_pallas(
        p, jnp.asarray(coords), radius), jpyr)
    want = [np.asarray(d.astype(jnp.float32)) for d in vjp(jnp.asarray(g))[0]]

    pyr = [torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_() for v in jpyr]
    before = kernels.launch_counts()
    out = corr_lookup_cuda(pyr, torch.from_numpy(coords), radius)
    out.backward(torch.from_numpy(g))
    assert kernels.launch_counts() == before
    assert sum(float(np.abs(x).sum()) for x in want) > 0
    for v, wnt in zip(pyr, want):
        assert v.grad.dtype == v.dtype and v.grad.shape == v.shape
        got = v.grad.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, wnt, atol=1e-5, rtol=0)
        else:
            assert (np.abs(got - wnt) <= 2 ** -7 * np.abs(wnt) + 1e-6).all()


def test_coords_get_no_gradient_and_plain_bwd_is_the_gather_vjp():
    """Coords get no gradient, as ``_lookup_bwd`` returns None for them;
    ``corr_scatter_cuda`` on the CPU is the VJP of the plain lookup."""
    from raft_tpu_torch.kernels.corr_lookup import corr_scatter_cuda

    f1, f2 = _fmaps(5)
    pyr = [v.requires_grad_() for v in corr.build_corr_pyramid(
        torch.from_numpy(f1), torch.from_numpy(f2))]
    coords = torch.from_numpy(_coords(6)).requires_grad_()
    g = torch.randn(1, H, W, 4 * 81, generator=torch.Generator().manual_seed(0))
    corr_lookup_cuda(pyr, coords, 4).backward(g)
    assert coords.grad is None
    want = torch.autograd.grad(
        corr.corr_lookup_gather(pyr, coords.detach(), 4), pyr, g)
    got = corr_scatter_cuda(g, pyr, coords.detach(), 4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
