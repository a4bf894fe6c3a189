"""The port's serving engine and cached forward against the JAX package on
the CPU, and the engine's own contracts.

``RAFT.forward_cached`` against the JAX model's (``method=
"forward_cached"``): the small trained fixture within 5e-4 px (the
ROADMAP's end-to-end bound; features too), the basic model at random init
after one step within 5e-3 px (``test_torch_raft``'s bound). The engine's
routing answers equal the JAX engine's built with ``precompile=False``
(which compiles nothing), and its ``infer_batch`` the JAX engine's within
5e-4 px on the small fixture. On ``device="cpu"`` the port's programs run
the eager forward; the contracts held here (bitwise where the arithmetic
is the same: the u8 wire, the warm-start round trip, a re-built program,
the hot swap, two pending dispatches) are the ones ``chip_smoke.py`` holds
the captured graphs to on the card.
"""

import functools
import os.path as osp
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.kernels import corr_pallas, gru_pallas
from raft_tpu.models import RAFT as JaxRAFT
from raft_tpu.serving.engine import RAFTEngine as JaxEngine
from raft_tpu.tools.convert import load_pth as jax_load_pth
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.serving import RAFTEngine, StaleFeatureError
from raft_tpu_torch.testing import faults
from raft_tpu_torch.tools.convert import load_pth, state_dict_from_flax

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
SMALL = RAFTConfig(small=True)


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


@pytest.fixture(scope="module")
def small():
    return (jax_load_pth(FIXTURE, JaxConfig(small=True)),
            load_pth(FIXTURE, SMALL).eval())


def _frames(seed, n, h=30, w=44):
    """``n`` integer-valued float32 frames of a random texture, each moved
    (1, 2) px from the last."""
    rng = np.random.RandomState(seed)
    base = np.floor(rng.rand(h + 2 * n, w + 2 * n, 3) * 256).astype(
        np.float32)
    return [base[k:k + h, 2 * k:2 * k + w] for k in range(n)]


def _engine(model, **kw):
    kw.setdefault("iters", 2)
    return RAFTEngine(model, model.config, device="cpu", **kw)


# -- forward_cached against JAX ---------------------------------------------

def _cached_inputs(seed, H, W, fdim, cdim):
    rng = np.random.RandomState(seed)
    return ((rng.rand(1, H, W, 3) * 255).astype(np.float32),
            rng.randn(1, H // 8, W // 8, fdim).astype(np.float32),
            rng.randn(1, H // 8, W // 8, cdim).astype(np.float32),
            rng.randn(1, H // 8, W // 8, 2).astype(np.float32))


def _jax_cached(cfg, variables, args, iters):
    fn = jax.jit(functools.partial(JaxRAFT(cfg).apply, iters=iters,
                                   method="forward_cached"))
    return [np.asarray(a) for a in fn(variables,
                                      *[jnp.asarray(a) for a in args])]


def _port_cached(model, args, iters):
    with torch.no_grad():
        out = model.forward_cached(*[torch.from_numpy(a) for a in args],
                                   iters=iters)
    return [a.numpy() for a in out]


def test_forward_cached_small_fixture_matches_jax(small):
    variables, model = small
    args = _cached_inputs(0, 32, 48, 128, 160)
    want = _jax_cached(JaxConfig(small=True), variables, args, 2)
    got = _port_cached(model, args, 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=0)


def test_forward_cached_basic_random_init_matches_jax():
    args = _cached_inputs(1, 32, 32, 256, 256)
    variables = jax.tree_util.tree_map(np.asarray, JaxRAFT(JaxConfig()).init(
        jax.random.PRNGKey(0), jnp.asarray(args[0]), jnp.asarray(args[0]),
        iters=1))
    want = _jax_cached(JaxConfig(), variables, args, 1)
    model = RAFT(RAFTConfig(corr_impl="pallas", gru_impl="fused")).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    got = _port_cached(model, args, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-3, rtol=0)


def test_cached_warm_pair_matches_uncached_warm_start(small):
    """Prime on frame 0, then the warm pair (0, 1) through the cached
    program against the plain warm-start program with the same
    ``flow_init``: the features differ only in the encoder's batch (1
    against 2), within 1e-4 px."""
    _, model = small
    f0, f1, f2 = _frames(2, 3)
    eng = _engine(model, warm_start=True, feature_cache=True)
    _, low0, fmap, cnet = eng.infer_cached(f0[None], [None])
    flow, low, fmap, cnet = eng.infer_cached(
        f1[None], [(fmap[0, :4, :6], cnet[0, :4, :6], None)])
    want, want_low = eng.infer_batch(f0[None], f1[None], return_low=True)
    np.testing.assert_allclose(flow, want, atol=1e-4, rtol=0)
    # the next pair starts from this one's flow, on both paths
    flow2, _, _, _ = eng.infer_cached(
        f2[None], [(fmap[0, :4, :6], cnet[0, :4, :6], low[0, :4, :6])])
    want2 = eng.infer_batch(f1[None], f2[None], flow_init=want_low)
    np.testing.assert_allclose(flow2, want2, atol=1e-4, rtol=0)
    assert eng.capture_count == 2 and flow.shape == (1, 30, 44, 2)


# -- routing against the JAX engine -----------------------------------------

ENVELOPE = [(1, 64, 64), (4, 128, 128), (2, 64, 96)]
CLASSES = [(4, 128, 128), (2, 64, 64)]
REQUESTS = [(1, 60, 60), (1, 64, 64), (2, 60, 90), (3, 64, 64),
            (4, 100, 120), (5, 64, 64), (1, 130, 60), (2, 200, 300),
            (1, 436, 1024)]


@pytest.mark.parametrize("kw", [
    {}, {"exact_shapes": True}, {"warm_start": True, "wire": "u8"},
    {"ragged": True, "capacity_classes": CLASSES},
    {"ragged": True, "capacity_classes": CLASSES, "ragged_grain": 32},
    {"ragged": True}])
def test_routing_matches_jax_engine(small, kw):
    variables, model = small
    want = JaxEngine(variables, JaxConfig(small=True), envelope=ENVELOPE,
                     precompile=False, **kw)
    got = RAFTEngine(model, SMALL, envelope=ENVELOPE, precompile=False,
                     device="cpu", **kw)
    assert got.bucket_shapes() == want.bucket_shapes()
    assert got.executable_count() == want.executable_count()
    for b, h, w in REQUESTS:
        assert got.route_bucket(b, h, w) == want.route_bucket(b, h, w)
        assert got.bucket_capacity(h, w) == want.bucket_capacity(h, w)
        if kw.get("ragged"):
            assert (got.route_bucket(b, h, w, kind="ragged")
                    == want.route_ragged(b, h, w))
            assert (got.bucket_capacity(h, w, kind="ragged")
                    == want.ragged_capacity(h, w))
            assert got.ragged_class_for(h, w) == want.ragged_class_for(h, w)
    assert got.ragged_classes() == (want.ragged_classes() if kw.get("ragged")
                                    else [])
    assert got.capture_count == got.compile_count == 0
    assert got.aot_stats() == {"enabled": 0, "aot_hits": 0,
                               "aot_misses": 0, "compiles": 0,
                               "compiles_avoided": 0, "captures": 0}


@pytest.mark.parametrize("kw", [
    {"wire": "fp16"}, {"ragged": True, "feature_cache": True},
    {"feature_cache": True}, {"ragged": True, "ragged_grain": 12},
    {"ragged": True, "ragged_grain": 0}, {"capacity_classes": [(1, 64, 64)]},
    {"ragged": True, "capacity_classes": [(1, 60, 64)]},
    {"feature_cache": True, "warm_start": True, "mesh": object()},
    {"ragged": True, "mesh": object()}])
def test_constructor_rejections_match_jax(small, kw):
    variables, model = small
    with pytest.raises(ValueError) as want:
        JaxEngine(variables, JaxConfig(small=True), precompile=False, **kw)
    with pytest.raises(ValueError) as got:
        RAFTEngine(model, SMALL, precompile=False, device="cpu", **kw)
    assert str(got.value) == str(want.value)


# -- inference --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engine(small):
    variables, _ = small
    return JaxEngine(variables, JaxConfig(small=True), iters=2,
                     envelope=[(1, 32, 48)])


def test_infer_batch_matches_jax_engine(small, jax_engine):
    _, model = small
    f0, f1 = _frames(3, 2)
    want = jax_engine.infer_batch(f0[None], f1[None])
    eng = _engine(model, envelope=[(1, 32, 48)])
    got = eng.infer_batch(f0[None], f1[None])
    assert got.shape == want.shape == (1, 30, 44, 2)
    assert np.abs(want).max() > 0.5      # trained weights see the motion
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_u8_wire_is_bitwise_f32_with_a_quarter_of_the_bytes(small):
    _, model = small
    frames = _frames(4, 3)
    i1, i2 = np.stack(frames[:2]), np.stack(frames[1:])
    f32 = _engine(model, envelope=[(2, 32, 48)])
    u8 = _engine(model, envelope=[(2, 32, 48)], wire="u8")
    a = f32.infer_batch_async(i1, i2)
    b = u8.infer_batch_async(i1, i2)
    assert b.h2d_bytes * 4 == a.h2d_bytes == 2 * 2 * 32 * 48 * 3 * 4
    np.testing.assert_array_equal(a.fetch(), b.fetch())


def test_warm_start_flow_low_round_trip(small):
    """``flow_low`` of one pair, fed back as the next pair's ``flow_init``
    (host array or tensor), gives bitwise the model's warm-start forward
    at the padded bucket."""
    _, model = small
    f0, f1, f2 = _frames(5, 3)
    eng = _engine(model, warm_start=True, wire="u8")
    flow, low = eng.infer_batch(f0[None], f1[None], return_low=True)
    assert low.shape == (1, 4, 6, 2) and isinstance(low, np.ndarray)
    warm = eng.infer_batch(f1[None], f2[None], flow_init=low)
    on_device = eng.infer_batch_async(f1[None], f2[None],
                                      flow_init=torch.from_numpy(low),
                                      return_low=True, low_device=True)
    assert on_device.h2d_bytes == 2 * 32 * 48 * 3
    dflow, dlow = on_device.fetch()
    assert isinstance(dlow, torch.Tensor)
    np.testing.assert_array_equal(dflow, warm)
    pad = ((0, 0), (1, 1), (2, 2), (0, 0))
    with torch.no_grad():
        _, want = model(*[torch.from_numpy(np.pad(f[None], pad, mode="edge"))
                          for f in (f1, f2)], iters=2,
                        flow_init=torch.from_numpy(low))
    np.testing.assert_array_equal(warm, want[:, 1:31, 2:46].numpy())
    assert eng.capture_count == 1


def test_sliding_window_tail_reuses_one_bucket(small):
    _, model = small
    frames = _frames(6, 6)
    eng = _engine(model, iters=1)
    flows = eng.infer(frames, batch_size=4)
    assert len(flows) == 5 and all(f.shape == (30, 44, 2) for f in flows)
    assert eng.bucket_shapes() == [(4, 32, 48)] and eng.capture_count == 1
    alone = eng.infer_batch(frames[4][None], frames[5][None])[0]
    np.testing.assert_allclose(flows[4], alone, atol=1e-4, rtol=0)


def test_drop_bucket_then_lazy_recapture(small):
    _, model = small
    f0, f1 = _frames(7, 2)
    eng = _engine(model, envelope=[(1, 32, 48)])
    first = eng.infer_batch(f0[None], f1[None])
    assert eng.capture_count == 1 and eng.executable_count() == 1
    assert eng.drop_bucket((1, 32, 48)) and not eng.drop_bucket((1, 32, 48))
    assert eng.executable_count() == 0
    np.testing.assert_array_equal(eng.infer_batch(f0[None], f1[None]), first)
    assert eng.capture_count == 2 and eng.bucket_shapes() == [(1, 32, 48)]
    assert eng.ensure_bucket(1, 30, 44) == (1, 32, 48)
    assert eng.capture_count == 2


def test_stale_features_are_refused(small):
    _, model = small
    f0, f1 = _frames(8, 2)
    eng = _engine(model, warm_start=True, feature_cache=True, iters=1)
    _, _, fmap, cnet = eng.infer_cached(f0[None], [None], expect_version=0)
    slot = (fmap[0, :4, :6], cnet[0, :4, :6], None)
    eng.update_weights(model.state_dict())
    assert eng.weights_version == 1
    with pytest.raises(StaleFeatureError, match="weights_version=0"):
        eng.infer_cached(f1[None], [slot], expect_version=0)
    eng.infer_cached(f1[None], [slot], expect_version=1)
    with pytest.raises(ValueError, match="cache row shape"):
        eng.infer_cached(f1[None], [(fmap[0, :3], cnet[0, :3], None)])


def test_two_pending_dispatches_fetch_their_own_flows(small):
    _, model = small
    frames = _frames(9, 4)
    eng = _engine(model, envelope=[(1, 32, 48)], iters=1)
    alone = [eng.infer_batch(frames[i][None], frames[i + 1][None])
             for i in (0, 2)]
    first = eng.infer_batch_async(frames[0][None], frames[1][None])
    second = eng.infer_batch_async(frames[2][None], frames[3][None])
    np.testing.assert_array_equal(second.fetch(), alone[1])
    np.testing.assert_array_equal(first.fetch(), alone[0])
    assert not np.array_equal(alone[0], alone[1])
    with pytest.raises(RuntimeError, match="already consumed"):
        first.fetch()


def test_hot_swap_never_mixes_a_dispatch(small):
    """One thread dispatches while another swaps between two checkpoints:
    every output is bitwise one of the two checkpoints' own outputs, and no
    program is built again."""
    _, model = small
    a = model.state_dict()
    b = {k: (v * 1.05 if v.is_floating_point() else v) for k, v in a.items()}
    f0, f1 = _frames(10, 2)
    eng = _engine(model, envelope=[(1, 32, 48)], iters=1)
    want = {"a": eng.infer_batch(f0[None], f1[None])}
    eng.update_weights(b)
    want["b"] = eng.infer_batch(f0[None], f1[None])
    assert not np.array_equal(want["a"], want["b"])
    captures = eng.capture_count
    outs, errors = [], []

    def dispatch():
        try:
            for _ in range(20):
                outs.append(eng.infer_batch(f0[None], f1[None]))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def swap():
        for i in range(20):
            eng.update_weights(a if i % 2 == 0 else b)

    threads = [threading.Thread(target=dispatch),
               threading.Thread(target=swap)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(outs) == 20
    for out in outs:
        assert any(np.array_equal(out, w) for w in want.values())
    assert eng.capture_count == captures and eng.weights_version == 21
    assert not eng.compatible_weights(RAFT(RAFTConfig()).state_dict())
    with pytest.raises(ValueError, match="structure mismatch"):
        eng.update_weights(RAFT(RAFTConfig()).state_dict())


@pytest.mark.parametrize("site", ["engine.compile", "serve.fetch"])
def test_fault_sites_fire(small, site):
    _, model = small
    f0, f1 = _frames(11, 2)
    faults.arm([{"site": site, "kind": "raise"}])
    try:
        if site == "engine.compile":
            with pytest.raises(faults.FaultInjected, match=site):
                _engine(model, envelope=[(1, 32, 48)], iters=1)
        else:
            eng = _engine(model, envelope=[(1, 32, 48)], iters=1)
            pending = eng.infer_batch_async(f0[None], f1[None])
            with pytest.raises(faults.FaultInjected, match=site):
                pending.fetch()
            # the plan's one fire is spent: the dispatch is still there
            assert pending.fetch().shape == (1, 30, 44, 2)
    finally:
        faults.disarm()


def test_ragged_class_serves_mixed_shapes_in_one_program(small):
    _, model = small
    rng = np.random.RandomState(12)
    shapes = [(32, 48), (20, 30), (17, 40)]
    pairs = [tuple(np.floor(rng.rand(h, w, 3) * 256).astype(np.float32)
                   for _ in range(2)) for h, w in shapes]
    eng = _engine(model, ragged=True, warm_start=True,
                  capacity_classes=[(4, 32, 48)], iters=1)
    pending = eng.infer_ragged_async(pairs, return_low=True)
    assert pending.bucket == (4, 32, 48)
    assert pending.real_px == sum(h * w for h, w in shapes)
    flows, lows = pending.fetch()
    assert [f.shape for f in flows] == [s + (2,) for s in shapes]
    assert [lo.shape for lo in lows] == [(4, 6, 2), (3, 4, 2), (3, 5, 2)]
    assert eng.capture_count == 1
    # a full-extent row is bitwise the bucketed program at the same box
    plain = _engine(model, envelope=[(4, 32, 48)], warm_start=True, iters=1)
    want = plain.infer_batch(pairs[0][0][None], pairs[0][1][None])
    np.testing.assert_array_equal(flows[0], want[0])
    eng.infer_ragged(pairs[1:], flow_inits=[lows[1], None])
    assert eng.capture_count == 1
