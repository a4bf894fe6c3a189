"""The port's ragged serving path against the JAX package on the CPU.

``raft_tpu_torch.serving.ragged`` against ``raft_tpu.kernels.
corr_ragged_pallas`` on the same numpy inputs: the descriptor's fields and
its validation exactly, ``mask_features`` bitwise, the masked pyramid
within 1e-6 (one fp32 matmul each, summed in another order), the lookup
over it within the 1e-5 of the lookup tests (the port takes each query's
bilinear fractions once, JAX per tap). ``RAFT.forward_ragged`` against the
JAX model's: the small trained fixture within 5e-4 px (the ROADMAP's
end-to-end bound), the basic model at random init after one step within
5e-3 px (``test_torch_raft``'s bound). And the port against itself: a
full-extent row is bitwise the bucketed forward, and a masked row's
level-0 lookup is its own volume's within 1e-6.
"""

import functools
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.kernels import corr_pallas, gru_pallas
from raft_tpu.kernels import corr_ragged_pallas as jr
from raft_tpu.models import RAFT as JaxRAFT
from raft_tpu.tools.convert import load_pth as jax_load_pth
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.models.corr import build_corr_pyramid, corr_lookup
from raft_tpu_torch.serving import ragged
from raft_tpu_torch.tools.convert import load_pth, state_dict_from_flax

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(corr_pallas, "_INTERPRET", True)
    monkeypatch.setattr(gru_pallas, "_INTERPRET", True)


@pytest.mark.parametrize("shapes8,cap,batch", [
    ([(4, 6), (2, 3)], (4, 6), 3), ([(1, 1)], (5, 7), 1),
    ([], (3, 3), 2), ([(3, 3), (3, 2), (1, 3)], (3, 3), 4)])
def test_descriptor_fields_match_jax(shapes8, cap, batch):
    want = jr.make_descriptor(shapes8, cap, batch)
    got = ragged.make_descriptor(shapes8, cap, batch, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shapes8,cap,batch", [
    ([(4, 6), (2, 3)], (4, 6), 1), ([(5, 6)], (4, 6), 2),
    ([(4, 7)], (4, 6), 1)])
def test_descriptor_validation_matches_jax(shapes8, cap, batch):
    with pytest.raises(ValueError) as want:
        jr.make_descriptor(shapes8, cap, batch)
    with pytest.raises(ValueError) as got:
        ragged.make_descriptor(shapes8, cap, batch)
    assert str(got.value) == str(want.value)


def _fmaps(seed, B=3, H=6, W=8, C=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            rng.randn(B, H, W, C).astype(np.float32))


EXTENTS = (np.array([6, 3, 0], np.int32), np.array([8, 5, 0], np.int32))


def test_mask_features_bitwise_jax():
    f1, _ = _fmaps(0)
    vh, vw = EXTENTS
    want = np.asarray(jr.mask_features(jnp.asarray(f1), jnp.asarray(vh),
                                       jnp.asarray(vw)))
    got = ragged.mask_features(torch.from_numpy(f1), torch.from_numpy(vh),
                               torch.from_numpy(vw)).numpy()
    np.testing.assert_array_equal(got, want)
    # the full-extent row is the identity, the fill row all zeros
    np.testing.assert_array_equal(got[0], f1[0])
    assert not got[2].any() and not got[1, 3:].any() and got[1, :3, :5].all()


def _pyramids(seed):
    f1, f2 = _fmaps(seed)
    vh, vw = EXTENTS
    want = jr.build_corr_pyramid_ragged(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(vh), jnp.asarray(vw),
        num_levels=3)
    got = ragged.build_corr_pyramid_ragged(
        torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(vh),
        torch.from_numpy(vw), num_levels=3)
    return got, [np.asarray(w) for w in want]


def test_ragged_pyramid_matches_jax():
    got, want = _pyramids(1)
    # JAX keeps the volume lane-major, (B, H·W, Hl, Wl) both
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    # tail targets contribute exact zeros to every query's volume
    assert not got[0][1].reshape(6, 8, 6, 8)[:, :, 3:].any()


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_ragged_lookup_matches_jax(impl):
    got_pyr, want_pyr = _pyramids(2)
    rng = np.random.RandomState(3)
    ys, xs = np.meshgrid(np.arange(6), np.arange(8), indexing="ij")
    coords = (np.stack([xs, ys], -1)[None] + 3 * rng.randn(3, 6, 8, 2)
              ).astype(np.float32)
    want = np.asarray(jr.corr_lookup_ragged(
        [jnp.asarray(w) for w in want_pyr], jnp.asarray(coords), 2,
        impl=impl))
    got = ragged.corr_lookup_ragged(got_pyr, torch.from_numpy(coords), 2,
                                    impl=impl).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_masked_lookup_matches_own_volume():
    """Self-masking: at level 0 a masked row's windows read what the row's
    own smaller volume gives, zeros past its extent included."""
    f1, f2 = _fmaps(4)
    vh, vw = EXTENTS
    pyr = ragged.build_corr_pyramid_ragged(
        torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(vh),
        torch.from_numpy(vw), num_levels=1)
    h, w = int(vh[1]), int(vw[1])
    own = build_corr_pyramid(torch.from_numpy(f1[1:2, :h, :w]),
                             torch.from_numpy(f2[1:2, :h, :w]), 1)
    rng = np.random.RandomState(5)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c = (np.stack([xs, ys], -1)[None] + 2.5 * rng.randn(1, h, w, 2)
         ).astype(np.float32)
    box = np.zeros((3, 6, 8, 2), np.float32)
    box[1, :h, :w] = c[0]
    got = corr_lookup(pyr, torch.from_numpy(box), 3, "gather")[1, :h, :w]
    want = corr_lookup(own, torch.from_numpy(c), 3, "gather")[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


# -- forward_ragged ---------------------------------------------------------

def _box(seed, B, H, W, rows):
    """(B, H, W, 3) frames and extents: row i holds a ``rows[i]`` = (h, w)
    frame pair (÷8) edge-free random texture, zeros past it."""
    rng = np.random.RandomState(seed)
    i1 = np.zeros((B, H, W, 3), np.float32)
    i2 = np.zeros_like(i1)
    vh = np.zeros(B, np.int32)
    vw = np.zeros(B, np.int32)
    for i, (h, w) in enumerate(rows):
        a = (rng.rand(h, w, 3) * 255).astype(np.float32)
        i1[i, :h, :w] = a
        i2[i, :h, :w] = np.roll(a, (1, 2), axis=(0, 1))
        vh[i], vw[i] = h // 8, w // 8
    return i1, i2, vh, vw


def _jax_ragged(cfg, variables, i1, i2, vh, vw, iters, flow_init=None):
    fn = jax.jit(functools.partial(JaxRAFT(cfg).apply, iters=iters,
                                   method="forward_ragged"))
    return [np.asarray(a) for a in fn(variables, jnp.asarray(i1),
                                      jnp.asarray(i2), jnp.asarray(vh),
                                      jnp.asarray(vw), flow_init)]


def _port_ragged(model, i1, i2, vh, vw, iters, flow_init=None):
    with torch.no_grad():
        out = model.forward_ragged(
            torch.from_numpy(i1), torch.from_numpy(i2), torch.from_numpy(vh),
            torch.from_numpy(vw),
            None if flow_init is None else torch.from_numpy(flow_init),
            iters=iters)
    return [a.numpy() for a in out]


@pytest.fixture(scope="module")
def small():
    return (jax_load_pth(FIXTURE, JaxConfig(small=True)),
            load_pth(FIXTURE, RAFTConfig(small=True)).eval())


def test_forward_ragged_small_fixture_matches_jax(small):
    variables, model = small
    i1, i2, vh, vw = _box(0, 2, 64, 96, [(64, 96), (40, 56)])
    rng = np.random.RandomState(1)
    finit = rng.randn(2, 8, 12, 2).astype(np.float32)
    want = _jax_ragged(JaxConfig(small=True), variables, i1, i2, vh, vw, 2,
                       jnp.asarray(finit))
    got = _port_ragged(model, i1, i2, vh, vw, 2, finit)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=0)


def test_forward_ragged_basic_random_init_matches_jax():
    i1, i2, vh, vw = _box(2, 2, 32, 48, [(32, 48), (24, 32)])
    variables = jax.tree_util.tree_map(np.asarray, JaxRAFT(JaxConfig()).init(
        jax.random.PRNGKey(0), jnp.asarray(i1), jnp.asarray(i1), iters=1))
    # the JAX package's XLA formulations (its Pallas kernels compute the
    # same function); the port's kernel configuration, whose plain
    # versions run on the CPU
    want = _jax_ragged(JaxConfig(), variables, i1, i2, vh, vw, 1)
    model = RAFT(RAFTConfig(corr_impl="pallas", gru_impl="fused")).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    got = _port_ragged(model, i1, i2, vh, vw, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-3, rtol=0)


def test_full_extent_row_is_bitwise_the_bucketed_forward(small):
    _, model = small
    i1, i2, vh, vw = _box(3, 2, 32, 48, [(32, 48), (32, 48)])
    got = _port_ragged(model, i1, i2, vh, vw, 2)
    with torch.no_grad():
        want = model(torch.from_numpy(i1), torch.from_numpy(i2), iters=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
