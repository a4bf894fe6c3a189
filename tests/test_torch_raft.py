"""The port's whole slice against the JAX package on the CPU.

Same inputs (numpy, from seeds or the bundled demo frames) and the same
weights go through ``raft_tpu`` and ``raft_tpu_torch`` (``device="cpu"``);
the Pallas kernels run in interpret mode as the JAX package's own tests run
them. Bounds: the small model's trained fixture within 5e-4 px (the
ROADMAP's end-to-end bound, the one ``test_reference_parity`` holds
``raft_tpu`` to); the basic model at random init within 5e-3 px at iters=2
on 64x64 and at iters=3 on 32x32 (the geometry of the JAX package's own
fused-GRU model test, whose pyramid has an empty last level). Random
weights do not contract the recurrence, so fp32 accumulation-order noise
(conv sums taken in another order by XLA and by PyTorch) grows several
times per refinement step: at iters=3 on 64x64 the JAX package's own two
formulations (``gru_impl`` xla vs fused) differ by about 1e-2 px and one
ulp of input moves it by about 3e-2 px, and the port is held to that
spread there.
The per-module tests hold each block to 1e-4.
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
from raft_tpu.kernels import corr_pallas, gru_pallas
from raft_tpu.models import RAFT as JaxRAFT
from raft_tpu.tools.convert import load_pth as jax_load_pth
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.evaluation.evaluate import make_forward
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.tools.convert import load_pth, state_dict_from_flax

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
FRAMES = sorted(glob.glob(osp.join(REPO, "demo-frames", "*.png")))


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
    monkeypatch.setattr(gru_pallas, "_INTERPRET", True)


def _crop(path, top=186, left=448, h=64, w=128):
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
    return img[top:top + h, left:left + w]


@pytest.fixture(scope="module")
def small_models():
    return (jax_load_pth(FIXTURE, JaxConfig(small=True)),
            load_pth(FIXTURE, RAFTConfig(small=True)))


@pytest.mark.parametrize("iters", [12, 20])
def test_small_trained_fixture_matches_jax(small_models, iters):
    variables, model = small_models
    im1 = _crop(FRAMES[0])[None]
    im2 = _crop(FRAMES[1])[None]
    jfwd, _ = jax_make_forward(JaxConfig(small=True), iters)
    want_lo, want_up = (np.asarray(a) for a in jfwd(variables, im1, im2))
    fwd, _ = make_forward(RAFTConfig(small=True), iters, device="cpu")
    got_lo, got_up = (a.numpy() for a in fwd(model, im1, im2))
    assert got_lo.shape == want_lo.shape and got_up.shape == want_up.shape
    assert np.abs(want_up).max() > 0.5   # trained weights see real motion
    np.testing.assert_allclose(got_lo, want_lo, atol=5e-4, rtol=0)
    np.testing.assert_allclose(got_up, want_up, atol=5e-4, rtol=0)


def test_small_trained_fixture_bf16_volume_matches_jax(small_models):
    """``corr_dtype="bfloat16"``: both packages store the pyramid in bf16
    and lerp in fp32. The fp32 volumes they round differ in the last bits
    (matmul order), which flips the bf16 rounding of a few entries, so the
    bound is the bf16 one stated here: 5e-3 px."""
    variables, model = small_models
    im1 = _crop(FRAMES[0])[None]
    im2 = _crop(FRAMES[1])[None]
    jfwd, _ = jax_make_forward(
        JaxConfig(small=True, corr_dtype="bfloat16"), 12)
    want = [np.asarray(a) for a in jfwd(variables, im1, im2)]
    cfg = RAFTConfig(small=True, corr_dtype="bfloat16")
    port = RAFT(cfg)
    port.load_state_dict(model.state_dict())
    fwd, _ = make_forward(cfg, 12, device="cpu")
    got = [a.numpy() for a in fwd(port, im1, im2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-3, rtol=0)


def _basic_inputs(size):
    """Two ``size``-px frames (the second shifted) and JAX-initialised basic
    variables as numpy."""
    rng = np.random.RandomState(0)
    im1 = (rng.rand(1, size, size, 3) * 255).astype(np.float32)
    im2 = np.roll(im1, (2, 3), axis=(1, 2))
    variables = JaxRAFT(JaxConfig()).init(
        jax.random.PRNGKey(0), jnp.asarray(im1), jnp.asarray(im1), iters=1)
    return im1, im2, jax.tree_util.tree_map(np.asarray, variables)


def _jax_flow(variables, im1, im2, iters, **kw):
    jfwd, _ = jax_make_forward(JaxConfig(**kw), iters)
    return [np.asarray(a) for a in jfwd(variables, im1, im2)]


def _port_flow(variables, im1, im2, iters, **kw):
    cfg = RAFTConfig(**kw)
    port = RAFT(cfg)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    fwd, _ = make_forward(cfg, iters, device="cpu")
    return [a.numpy() for a in fwd(port, im1, im2)]


KERNELS = dict(corr_impl="pallas", gru_impl="fused")


def test_basic_random_init_pallas_fused_matches_jax():
    im1, im2, variables = _basic_inputs(64)
    want_lo, want_up = _jax_flow(variables, im1, im2, 2, **KERNELS)
    got_lo, got_up = _port_flow(variables, im1, im2, 2, **KERNELS)
    np.testing.assert_allclose(got_lo, want_lo, atol=5e-3, rtol=0)
    np.testing.assert_allclose(got_up, want_up, atol=5e-3, rtol=0)


def test_basic_random_init_iters3_empty_level_matches_jax():
    """32x32: levels 4x4, 2x2, 1x1 and an empty 0x0 that both packages read
    as zeros."""
    im1, im2, variables = _basic_inputs(32)
    want = _jax_flow(variables, im1, im2, 3, **KERNELS)
    got = _port_flow(variables, im1, im2, 3, **KERNELS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-3, rtol=0)


def test_basic_random_init_iters3_within_jax_own_spread():
    """At iters=3 on 64x64 the random-weight recurrence has amplified fp32
    order noise past 5e-3 px in the JAX package itself: its xla and fused
    formulations differ by ~1.0e-2 px, and image1 moved by one ulp moves
    its fused flow by ~3.0e-2 px (the port, against JAX fused, ~2.6e-2
    px: its channels-last convs take oneDNN's brgemm kernel, CPU). The
    port is held to twice the reference's own spread, the larger of the
    two, which a semantic fault (a wrong tap, gate or channel order)
    exceeds by orders."""
    im1, im2, variables = _basic_inputs(64)
    want = _jax_flow(variables, im1, im2, 3, **KERNELS)
    ulp = np.nextafter(im1, np.float32(np.inf))
    spread = max(np.abs(a - b).max() for a, b in zip(
        _jax_flow(variables, im1, im2, 3)
        + _jax_flow(variables, ulp, im2, 3, **KERNELS), want + want))
    got = _port_flow(variables, im1, im2, 3, **KERNELS)
    assert 0 < spread < 5e-2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2 * spread, rtol=0)


def test_demo_cli_pngs_match_jax_demo(tmp_path):
    """Three cropped frames through both demos: the PNGs agree within one
    level (the flow colors come from two runs' float flows)."""
    from PIL import Image

    from raft_tpu.cli.demo import main as jax_main
    from raft_tpu_torch.cli.demo import main as port_main

    fdir = tmp_path / "frames"
    fdir.mkdir()
    for f in FRAMES[:3]:
        Image.fromarray(_crop(f).astype(np.uint8)).save(fdir / osp.basename(f))
    common = ["--model", FIXTURE, "--path", str(fdir), "--small",
              "--iters", "12"]
    jax_main(common + ["--out", str(tmp_path / "jax")])
    port_main(common + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    want = sorted(glob.glob(str(tmp_path / "jax" / "*.png")))
    got = sorted(glob.glob(str(tmp_path / "port" / "*.png")))
    assert len(want) == 2
    assert [osp.basename(p) for p in got] == [osp.basename(p) for p in want]
    for w, g in zip(want, got):
        a = np.asarray(Image.open(w)).astype(np.int16)
        b = np.asarray(Image.open(g)).astype(np.int16)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1
