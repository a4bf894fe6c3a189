"""Mixed precision, remat and dropout of the port, on the CPU.

Mixed precision (``mixed_precision=True``: bf16 convs on fp32 parameters,
fp32 norms and correlation island, coords fp32) against ``raft_tpu``'s
``mixed_precision`` from the same weights and inputs:

- The forward in test mode, and one train step's loss and gradients. bf16
  rounds differently in the two packages (XLA's CPU convs and PyTorch's
  accumulate and round in other places), so the bound comes from the same
  run: the gap between the port's bf16 result and JAX's bf16 result must
  be at most twice the gap between JAX's bf16 and JAX's own fp32 result
  (seen: 0.97-1.06 of it on the forward). The fp32 results are held
  tightly beside (5e-3 px; 1e-5 relative for the loss), and the port's
  bf16 result must differ from its fp32 one: bf16 really ran.
- The casts themselves: every conv computes in bf16, the batch norms
  return fp32 and the instance norms bf16 (the fnet's blocks end in bf16,
  the cnet's in fp32), the update block and its GRU take and give bf16,
  and the flow comes out fp32.

Remat: ``remat=True`` with ``remat_policy`` ``full`` and ``dots`` gives
bitwise the gradients of ``remat=False`` (CPU convs are deterministic), and
its backward really recomputes: ``full`` runs the refinement step's
convolutions again, ``dots`` only its other ops.

Dropout: off in eval and test mode; a keep/drop draw per (sample, channel),
broadcast over H and W, kept channels scaled by 1/(1-p); reproducible from
the generator's seed, and a train step replays it from (seed, step).
"""

import glob
import os.path as osp

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.models import RAFT as JaxRAFT
from raft_tpu.tools.convert import convert_state_dict
from raft_tpu.training.train_step import create_train_state as jax_state
from raft_tpu.training.train_step import make_train_step as jax_step
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.data.png import read_png
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.models.encoders import BasicEncoder, channel_dropout
from raft_tpu_torch.models.layers import Conv2d
from raft_tpu_torch.tools.convert import load_pth, state_dict_from_flax
from raft_tpu_torch.training.train_step import (create_train_state,
                                                make_train_step)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
FRAMES = sorted(glob.glob(osp.join(REPO, "demo-frames", "*.png")))
SPREAD = 2.0          # port bf16 vs JAX bf16, in units of JAX bf16 vs fp32
FP32_PX = 5e-3


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(h=64, w=128, top=150, left=300):
    fr = [read_png(f).astype(np.float32) for f in FRAMES[:3]]
    im1 = np.stack([fr[0][top:top + h, left:left + w],
                    fr[1][top + 30:top + 30 + h, left:left + w]])
    im2 = np.stack([fr[1][top:top + h, left:left + w],
                    fr[2][top + 30:top + 30 + h, left:left + w]])
    return im1, im2


def _weights(kind):
    """(JAX variables, port state_dict) of one model: the trained small
    fixture, or the basic model at JAX's random init."""
    if kind == "small":
        model = load_pth(FIXTURE, RAFTConfig(small=True))
        sd = model.state_dict()
        img = jnp.zeros((1, 32, 32, 3))
        shapes = jax.eval_shape(lambda: JaxRAFT(JaxConfig(small=True)).init(
            jax.random.PRNGKey(0), img, img, iters=1))
        return convert_state_dict(sd, shapes), sd
    img = jnp.zeros((1, 64, 64, 3))
    variables = JaxRAFT(JaxConfig()).init(jax.random.PRNGKey(0), img, img,
                                          iters=1)
    return variables, state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables))


@pytest.mark.parametrize("kind,iters", [("basic", 1), ("small", 12)])
def test_mixed_forward_matches_jax(kind, iters):
    variables, sd = _weights(kind)
    im1, im2 = _pair()
    out = {}
    for mp in (False, True):
        kw = dict(small=kind == "small", mixed_precision=mp,
                  corr_impl="gather")
        _, up = JaxRAFT(JaxConfig(**kw)).apply(
            variables, jnp.asarray(im1), jnp.asarray(im2), iters=iters,
            test_mode=True)
        out["jax", mp] = np.asarray(up, np.float32)
        model = RAFT(RAFTConfig(**kw))
        model.load_state_dict(sd)
        with torch.no_grad():
            _, up = model(torch.from_numpy(im1), torch.from_numpy(im2),
                          iters=iters)
        assert up.dtype == torch.float32
        out["port", mp] = up.numpy()

    def gap(a, b):
        return float(np.abs(out[a] - out[b]).max())

    assert gap(("port", False), ("jax", False)) <= FP32_PX
    jax_own = gap(("jax", True), ("jax", False))
    assert gap(("port", True), ("port", False)) > 0.1 * jax_own > 0
    assert gap(("port", True), ("jax", True)) <= SPREAD * jax_own


def test_mixed_casts_follow_jax():
    model = RAFT(RAFTConfig(mixed_precision=True, corr_impl="gather"))
    seen = {}

    def record(name):
        def hook(mod, args, out):
            seen.setdefault(name, set()).add(
                out[0].dtype if isinstance(out, tuple) else out.dtype)
            if name == "update_block":
                seen.setdefault("update_in", set()).update(
                    a.dtype for a in args)
        return hook

    for name, mod in model.named_modules():
        if isinstance(mod, Conv2d):
            mod.register_forward_hook(record("conv"))
        elif isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_hook(record("batch_norm"))
        elif name in ("update_block", "update_block.gru", "fnet.layer3.1",
                      "cnet.layer3.1"):
            mod.register_forward_hook(record(name))
    im1, im2 = _pair()
    flows = model(torch.from_numpy(im1), torch.from_numpy(im2), iters=2,
                  test_mode=False, train=True)
    bf16 = {torch.bfloat16}
    assert seen["conv"] == bf16
    assert seen["update_in"] == seen["update_block.gru"] == bf16
    # instance norms return bf16 (fnet), batch norms fp32 (cnet)
    assert seen["fnet.layer3.1"] == bf16
    assert seen["batch_norm"] == seen["cnet.layer3.1"] == {torch.float32}
    assert flows.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _find_mu(opt_state):
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            mu = _find_mu(s)
            if mu is not None:
                return mu
    return None


def _jax_step(variables, cfg_kw, train_kw, batch):
    """(loss, gradients) of one ``raft_tpu`` train step; the gradient is
    read from Adam's first moment after the step (``mu = 0.1·g``)."""
    jcfg, jtc = JaxConfig(**cfg_kw), JaxTrainConfig(**train_kw)
    state = jax_state(jcfg, jtc, jax.random.PRNGKey(0),
                      init_variables=variables)
    new, metrics = jax.jit(jax_step(jcfg, jtc))(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))
    grads = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _find_mu(new.opt_state))})
    return float(metrics["loss"]), {k: v.numpy() for k, v in grads.items()}


@pytest.fixture(scope="module")
def steps():
    """One train step of the trained small fixture (iters=12) in both
    packages, fp32 and mixed: (loss, gradients) by (package, mixed)."""
    variables, sd = _weights("small")
    im1, im2 = _pair()
    rng = np.random.RandomState(0)
    batch = {"image1": im1, "image2": im2,
             "flow": (3 * rng.randn(2, 64, 128, 2)).astype(np.float32),
             "valid": (rng.rand(2, 64, 128) > 0.2).astype(np.float32)}
    train_kw = dict(stage="chairs", batch_size=2, image_size=(64, 128),
                    iters=12, lr=4e-4, add_noise=False)
    out = {}
    for mp in (False, True):
        kw = dict(small=True, mixed_precision=mp, corr_impl="gather")
        out["jax", mp] = _jax_step(variables, kw, train_kw, batch)
        model = RAFT(RAFTConfig(**kw))
        model.load_state_dict(sd)
        tc = TrainConfig(**train_kw)
        metrics = make_train_step(RAFTConfig(**kw), tc)(
            create_train_state(model, tc), batch)
        out["port", mp] = (float(metrics["loss"]),
                           {k: p.grad.numpy()
                            for k, p in model.named_parameters()})
    return out


def _step_gap(a, b):
    """(relative loss gap, the largest per-parameter gradient gap as a share
    of the parameter's largest gradient)."""
    (la, ga), (lb, gb) = a, b
    gmax = max(np.abs(g).max() for g in gb.values())
    rel = [np.abs(ga[k] - gb[k]).max() / np.abs(gb[k]).max() for k in gb
           if np.abs(gb[k]).max() > 1e-4 * gmax]
    return abs(la - lb) / abs(lb), max(rel)


def test_mixed_train_step_matches_jax(steps):
    fp32_loss, fp32_grad = _step_gap(steps["port", False],
                                     steps["jax", False])
    assert fp32_loss <= 1e-5 and fp32_grad <= 2e-2
    own_loss, own_grad = _step_gap(steps["jax", True], steps["jax", False])
    port_loss, port_grad = _step_gap(steps["port", True], steps["jax", True])
    assert own_loss > 0 and own_grad > 0
    assert _step_gap(steps["port", True], steps["port", False])[1] > 0
    assert port_loss <= SPREAD * own_loss
    assert port_grad <= SPREAD * own_grad


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("base", [dict(), dict(small=True),
                                  dict(mixed_precision=True),
                                  dict(corr_impl="pallas", gru_impl="fused")])
def test_remat_gradients_equal_no_remat(base):
    torch.manual_seed(0)
    im1 = torch.rand(2, 32, 48, 3) * 255
    im2 = torch.roll(im1, 2, 2)
    grads, backward_ops = [], []
    for kw in (dict(), dict(remat=True),
               dict(remat=True, remat_policy="dots")):
        model = RAFT(RAFTConfig(**base, **kw))
        flows = model(im1, im2, iters=3, test_mode=False, train=True)
        with _CountOps() as ops:
            (flows ** 2).mean().backward()
        backward_ops.append(ops.counts)
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for g in grads[1:]:
        for k in g:
            torch.testing.assert_close(g[k], grads[0][k], rtol=0, atol=0,
                                       msg=k)
    plain, full, dots = backward_ops
    assert "convolution" not in plain
    assert full["convolution"] > 0                 # the step ran again
    assert "convolution" not in dots               # its convs were saved
    assert dots.get("relu", 0) > plain.get("relu", 0)   # the rest ran again


def test_dropout_masks_channels():
    x = 3.0 * torch.ones(4, 64, 5, 7)
    gen = torch.Generator().manual_seed(0)
    y = channel_dropout(x, 0.25, gen)
    planes = y.flatten(2)
    # each (sample, channel) plane is all dropped or all kept, scaled 1/(1-p)
    assert torch.equal(planes.amin(-1), planes.amax(-1))
    assert set(planes[..., 0].unique().tolist()) == {0.0, 4.0}
    assert 0.15 < float((planes[..., 0] == 0).float().mean()) < 0.35
    again = channel_dropout(x, 0.25, torch.Generator().manual_seed(0))
    other = channel_dropout(x, 0.25, torch.Generator().manual_seed(1))
    assert torch.equal(y, again) and not torch.equal(y, other)


def test_dropout_train_mode_only():
    plain = BasicEncoder(64, "instance")
    drop = BasicEncoder(64, "instance", dropout=0.5)
    drop.load_state_dict(plain.state_dict())
    x = torch.randn(2, 3, 32, 32)
    torch.testing.assert_close(drop(x), plain(x), rtol=0, atol=0)
    ratio = (drop(x, train=True, generator=torch.Generator().manual_seed(3))
             / plain(x, train=True)).flatten(2)
    finite = torch.nan_to_num(ratio, nan=0.0)
    assert set(finite.amax(-1).unique().tolist()) <= {0.0, 2.0}
    model = RAFT(RAFTConfig(small=True, dropout=0.5))
    ref = RAFT(RAFTConfig(small=True))
    im1, im2 = (torch.from_numpy(a) for a in _pair(32, 32))
    with torch.no_grad():
        for a, b in zip(model(im1, im2, iters=2), ref(im1, im2, iters=2)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_replays_dropout_from_seed_and_step():
    cfg = RAFTConfig(small=True, dropout=0.2)
    tc = TrainConfig(batch_size=2, image_size=(32, 32), iters=2,
                     add_noise=True)
    im1, im2 = _pair(32, 32)
    batch = {"image1": im1, "image2": im2,
             "flow": np.ones((2, 32, 32, 2), np.float32),
             "valid": np.ones((2, 32, 32), np.float32)}
    losses = []
    for seed in (1234, 1234, 99):
        model = RAFT(cfg)
        step = make_train_step(cfg, TrainConfig(**{**tc.__dict__,
                                                   "seed": seed}))
        losses.append(float(step(create_train_state(model, tc), batch)
                            ["loss"]))
    assert losses[0] == losses[1] != losses[2]
