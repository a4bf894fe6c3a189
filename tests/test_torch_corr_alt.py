"""The port's alternate correlation path against the JAX package on the CPU.

- The plain on-the-fly lookup (``models.corr.alt_corr_lookup``, the plain
  version of K5) within 1e-5 of JAX's XLA ``alt_corr_lookup`` and of
  ``alt_corr_lookup_pallas`` in interpret mode, on the setup of
  ``tests/test_corr_alt_pallas.py`` (B=2, 8x12, C=16, far-out-of-range and
  edge-straddling queries) at r = 2, 3 and 4, and on a 4x4 grid whose last
  level is empty. Its VJP in fmap1, every level and the coords (through
  ``AltCorrLookup``, whose CPU forward is the plain version) within 1e-4
  of JAX's. The two formulations sum the same products in another order
  (and JAX's XLA form rounds each tap's fraction on its own), hence 1e-5.
- ``RAFT(alternate_corr=True)`` against JAX's: the trained small fixture
  within 5e-4 px at iters 12 and 20, the basic model at random init within
  5e-3 px at iters=2 on 64x64 and on a 32x32 image (an empty level); the
  port's alternate path against its own materialized path; one train step
  of the small fixture with ``alternate_corr`` against JAX's
  ``make_train_step``.
"""

import glob
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.evaluation.evaluate import make_forward as jax_make_forward
from raft_tpu.kernels import corr_alt_pallas, gru_pallas
from raft_tpu.models import RAFT as JaxRAFT
from raft_tpu.models.corr import alt_corr_lookup as jax_alt_lookup
from raft_tpu.ops.pooling import avg_pool2x2 as jax_pool
from raft_tpu.tools.convert import load_pth as jax_load_pth
from raft_tpu_torch import kernels
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.evaluation.evaluate import make_forward
from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.models.corr import AlternateCorrBlock, alt_corr_lookup
from raft_tpu_torch.ops.pooling import avg_pool2x2
from raft_tpu_torch.tools.convert import load_pth, state_dict_from_flax

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
FRAMES = sorted(glob.glob(osp.join(REPO, "demo-frames", "*.png")))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Run the port's CPU ops on one thread: the suite runs in parallel
    workers, and torch's default of one thread per core oversubscribes the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(corr_alt_pallas, "_INTERPRET", True)
    monkeypatch.setattr(gru_pallas, "_INTERPRET", True)


def _setup(H=8, W=12, levels=3, seed=11):
    """``tests/test_corr_alt_pallas.py``'s inputs: fmaps (B=2, C=16), the
    fmap2 pyramid pooled by JAX, coords with far-out and edge queries."""
    rng = np.random.RandomState(seed)
    B, C = 2, 16
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    pyr = [jnp.asarray(f2)]
    for _ in range(levels - 1):
        pyr.append(jax_pool(pyr[-1]))
    base = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
    coords = base[None].astype(np.float32) + rng.randn(B, H, W, 2).astype(
        np.float32) * 2.5
    coords[0, 0, 0] = [0.0, 0.0]
    coords[0, 0, 1] = [-50.0, 3.0]          # far out -> zeros
    coords[0, 1, 0] = [W + 40.0, H + 40.0]  # far out -> zeros
    coords[1, 0, 0] = [-0.5, H - 0.5]       # edge-straddling window
    return f1, f2, [np.asarray(v) for v in pyr], coords


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("radius", [2, 3, 4])
@pytest.mark.parametrize("grid", [(8, 12, 3), (4, 4, 4)])
def test_plain_lookup_matches_jax(grid, radius):
    """The 4x4 grid pools to 4x4, 2x2, 1x1 and an empty 0x0 level."""
    H, W, levels = grid
    f1, f2, pyr, coords = _setup(H, W, levels)
    port_pyr = AlternateCorrBlock(*_t(f1, f2), levels, radius).fmap2_pyramid
    assert [tuple(v.shape) for v in port_pyr] == [v.shape for v in pyr]
    for got_level, want_level in zip(port_pyr, pyr):
        np.testing.assert_allclose(got_level.numpy(), want_level, atol=1e-6,
                                   rtol=0)
    got = alt_corr_lookup(*_t(f1), _t(*pyr), *_t(coords), radius).numpy()
    K2 = (2 * radius + 1) ** 2
    assert got.shape == (2, H, W, levels * K2)
    assert not got[0, 0, 1].any() and not got[0, 1, 0].any()
    if H == 4:
        assert not got[..., 3 * K2:].any() and got[..., :K2].any()
    jargs = (jnp.asarray(f1), [jnp.asarray(v) for v in pyr],
             jnp.asarray(coords), radius)
    jfns = [jax_alt_lookup]
    if H == 8 or radius == 4:   # interpret mode takes ~5 s a call
        jfns.append(corr_alt_pallas.alt_corr_lookup_pallas)
    for jfn in jfns:
        want = np.asarray(jfn(*jargs))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                   err_msg=jfn.__name__)


def test_avg_pool_under_two_pixels_is_empty_like_jax():
    x = np.random.RandomState(0).randn(2, 1, 5, 3).astype(np.float32)
    got = avg_pool2x2(torch.from_numpy(x))
    assert tuple(got.shape) == jax_pool(jnp.asarray(x)).shape == (2, 0, 2, 3)


@pytest.mark.parametrize("grid", [(8, 12, 3), (4, 4, 4)])
def test_vjp_matches_jax(grid):
    """Through ``AltCorrLookup`` (CPU: the plain forward, the plain VJP),
    for fmap1, every level and the coords: within 1e-4 of JAX's."""
    H, W, levels = grid
    f1, _, pyr, coords = _setup(H, W, levels)
    radius = 2
    g = np.random.RandomState(1).randn(
        2, H, W, levels * (2 * radius + 1) ** 2).astype(np.float32)
    _, vjp = jax.vjp(lambda a, p, c: jax_alt_lookup(a, p, c, radius),
                     jnp.asarray(f1), [jnp.asarray(v) for v in pyr],
                     jnp.asarray(coords))
    jf1, jpyr, jc = vjp(jnp.asarray(g))
    want = [jf1, *jpyr, jc]

    tf1, tc, *tpyr = _t(f1, coords, *pyr, grad=True)
    before = kernels.launch_counts()
    alt_corr_lookup_cuda(tf1, tpyr, tc, radius).backward(torch.from_numpy(g))
    assert kernels.launch_counts() == before
    got = [tf1.grad, *[v.grad for v in tpyr], tc.grad]
    assert np.abs(np.asarray(jc)).max() > 0    # coords really get gradient
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_cpu_wrapper_is_the_plain_version():
    f1, f2, pyr, coords = _setup()
    args = (*_t(f1), _t(*pyr), *_t(coords), 3)
    torch.testing.assert_close(alt_corr_lookup_cuda(*args),
                               alt_corr_lookup(*args), rtol=0, atol=0)
    # chunking over queries does not change the values
    torch.testing.assert_close(alt_corr_lookup(*args, chunk=7),
                               alt_corr_lookup(*args), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _crop(path, top=186, left=448, h=64, w=128):
    from raft_tpu_torch.data.png import read_png

    return read_png(path)[top:top + h, left:left + w].astype(np.float32)


@pytest.fixture(scope="module")
def small_models():
    return (jax_load_pth(FIXTURE, JaxConfig(small=True, alternate_corr=True)),
            load_pth(FIXTURE, RAFTConfig(small=True, alternate_corr=True)))


@pytest.mark.parametrize("iters", [12, 20])
def test_small_trained_fixture_matches_jax(small_models, iters):
    variables, model = small_models
    im1, im2 = _crop(FRAMES[0])[None], _crop(FRAMES[1])[None]
    jfwd, _ = jax_make_forward(JaxConfig(small=True, alternate_corr=True),
                               iters)
    want = [np.asarray(a) for a in jfwd(variables, im1, im2)]
    fwd, _ = make_forward(RAFTConfig(small=True, alternate_corr=True), iters,
                          device="cpu")
    got = [a.numpy() for a in fwd(model, im1, im2)]
    assert np.abs(want[1]).max() > 0.5   # trained weights see real motion
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=0)
    # and the port's materialized path on the same weights
    cfg = RAFTConfig(small=True)
    mat = RAFT(cfg)
    mat.load_state_dict(model.state_dict())
    fwd_m, _ = make_forward(cfg, iters, device="cpu")
    for g, m in zip(got, (a.numpy() for a in fwd_m(mat, im1, im2))):
        np.testing.assert_allclose(g, m, atol=5e-4, rtol=0)


KERNELS = dict(alternate_corr=True, corr_impl="pallas", gru_impl="fused")


@pytest.mark.parametrize("size,iters,jax_corr", [(64, 2, "gather"),
                                                (32, 3, "pallas")])
def test_basic_random_init_matches_jax(size, iters, jax_corr):
    """64x64 at iters=2, and 32x32 at iters=3, whose last level is empty.
    The port runs its kernel configuration (on the CPU, the plain versions);
    JAX its fused GRU in interpret mode (random weights amplify fp32 order
    noise, and the GRU's order is what 5e-3 px needs) with its XLA lookup
    at 64x64 and, at 32x32, its Pallas lookup, which takes each query's
    fractions once as the port does (JAX's XLA lookup lands 5.9e-3 px away
    there, CPU)."""
    rng = np.random.RandomState(0)
    im1 = (rng.rand(1, size, size, 3) * 255).astype(np.float32)
    im2 = np.roll(im1, (2, 3), axis=(1, 2))
    variables = jax.tree_util.tree_map(np.asarray, JaxRAFT(JaxConfig()).init(
        jax.random.PRNGKey(0), jnp.asarray(im1), jnp.asarray(im1), iters=1))
    jfwd, _ = jax_make_forward(
        JaxConfig(alternate_corr=True, corr_impl=jax_corr, gru_impl="fused"),
        iters)
    want = [np.asarray(a) for a in jfwd(variables, im1, im2)]
    port = RAFT(RAFTConfig(**KERNELS))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    fwd, _ = make_forward(RAFTConfig(**KERNELS), iters, device="cpu")
    before = kernels.launch_counts()
    got = [a.numpy() for a in fwd(port, im1, im2)]
    assert kernels.launch_counts() == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-3, rtol=0)


def test_train_step_matches_jax():
    """One train step of the small fixture with ``alternate_corr`` (64x64
    crops, iters=4) against JAX's: loss within 1e-5 relative, gradients as
    ``tests/test_torch_train_step.py`` holds the trained fixture (2e-2 of
    each parameter's largest, median 1e-3)."""
    from raft_tpu.config import TrainConfig as JaxTrainConfig
    from raft_tpu.tools.convert import convert_state_dict
    from raft_tpu.training.train_step import create_train_state as jax_state
    from raft_tpu.training.train_step import make_train_step as jax_step
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    rng = np.random.RandomState(0)
    crops = [(186, 448), (120, 300)]
    batch = {"image1": np.stack([_crop(FRAMES[0], t, l, 64, 64) for t, l in crops]),
             "image2": np.stack([_crop(FRAMES[1], t, l, 64, 64) for t, l in crops]),
             "flow": (3 * rng.randn(2, 64, 64, 2)).astype(np.float32),
             "valid": (rng.rand(2, 64, 64) > 0.2).astype(np.float32)}
    cfg_kw = dict(small=True, alternate_corr=True)
    train_kw = dict(stage="chairs", batch_size=2, image_size=(64, 64),
                    iters=4, lr=4e-4, add_noise=False)
    model = load_pth(FIXTURE, RAFTConfig(**cfg_kw))

    jcfg = JaxConfig(**cfg_kw)
    img = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: JaxRAFT(jcfg).init(
        jax.random.PRNGKey(0), img, img, iters=1))
    jtc = JaxTrainConfig(**train_kw)
    state = jax_state(jcfg, jtc, jax.random.PRNGKey(0),
                      init_variables=convert_state_dict(model.state_dict(),
                                                        shapes))
    new, jmetrics = jax.jit(jax_step(jcfg, jtc))(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))
    def _find_mu(opt_state):
        if hasattr(opt_state, "mu"):
            return opt_state.mu
        for s in (opt_state if isinstance(opt_state, (tuple, list)) else ()):
            mu = _find_mu(s)
            if mu is not None:
                return mu
        return None

    # Adam's first moment after one update is (1 - 0.9)·g
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _find_mu(new.opt_state))})

    metrics = make_train_step(RAFTConfig(**cfg_kw), TrainConfig(**train_kw))(
        create_train_state(model, TrainConfig(**train_kw)), batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    params = dict(model.named_parameters())
    assert float(params["fnet.conv1.weight"].grad.abs().max()) > 0
    gmax = max(float(np.abs(want[k].numpy()).max()) for k in params)
    rel = []
    for k, p in params.items():
        w = want[k].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        scale = float(np.abs(w).max())
        assert err <= 2e-2 * scale + 1e-6 * gmax, (k, err, scale)
        if scale > 1e-4 * gmax:
            rel.append(err / scale)
    assert np.median(rel) <= 1e-3
