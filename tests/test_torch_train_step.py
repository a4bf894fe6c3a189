"""One train step of the port against ``raft_tpu``'s ``make_train_step``.

From the same weights (the port's, carried into JAX with
``raft_tpu.tools.convert.convert_state_dict``) and the same batch, with
``add_noise=False``, on the CPU, the Pallas kernels in interpret mode:

- (a) the basic model at random init, ``pallas`` + ``fused``, 64x64, B=2,
  iters=2, chairs stage (batch norms trained, fused subpixel loss);
- (b) the trained small fixture at iters=12 on two crops of the demo
  frames (no batch norm, the standard loss).

JAX's gradient is read from Adam's first moment after the step (``mu =
(1-β1)·g`` after one update), so one compiled ``make_train_step`` gives the
loss, metrics, gradient, batch statistics and new parameters. Both sides'
gradients are taken after the clip, as the optimizers see them.

Tolerances, and why:

- loss, epe: 1e-5 relative (fp32 sums over the batch in two orders; seen
  ~7e-7). grad_norm: 1e-4 relative (seen ~6e-6).
- 1px/3px/5px: two pixels' share (a pixel within rounding of a threshold
  may fall on either side).
- gradients: each parameter's within ``grad_rtol`` of its largest
  gradient (plus 1e-6 of the model's largest), and the median of those
  per-parameter errors within 1e-3. Random weights do not contract the
  recurrence, and a ReLU whose input lies within rounding of 0 may switch
  between the packages while the norm before it spreads that one element
  over its channel: at iters=2 ``raft_tpu``'s own two formulations
  (``gru_impl`` xla and fused) differ by up to 2.6% of a parameter's
  largest gradient on input (a) (CPU), the port against JAX fused by 1.5%
  at most and 6.5e-5 at the median; the basic model gets 5e-2, twice
  JAX's own spread. The trained small fixture at iters=12 differs by
  0.66% at most and 1.7e-5 at the median, and gets 2e-2.
- batch-norm running statistics: 1e-5 (flax takes the variance as
  E[x²]−E[x]², the port in two passes; seen 2e-6).
- parameters after the step: Adam's first update is ±lr per element, so
  an element whose gradient is at noise level may move the other way:
  every element within 2·lr + 1e-6; where both gradients agree in sign and
  exceed 1e-5 (1000 times Adam's eps, whose share of the update then
  differs by under 2e-8), within 1e-7 + 1e-6·|p|.
"""

import glob
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.kernels import corr_pallas, gru_pallas
from raft_tpu.models import RAFT as JaxRAFT
from raft_tpu.tools.convert import convert_state_dict
from raft_tpu.training.train_step import create_train_state as jax_state
from raft_tpu.training.train_step import make_train_step as jax_step
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.tools.convert import load_pth, state_dict_from_flax
from raft_tpu_torch.training.train_step import (create_train_state,
                                                make_train_step)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
FRAMES = sorted(glob.glob(osp.join(REPO, "demo-frames", "*.png")))
KERNELS = dict(corr_impl="pallas", gru_impl="fused")


def _find_mu(opt_state):
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            mu = _find_mu(s)
            if mu is not None:
                return mu
    return None


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run(model, cfg_kw, train_kw, batch):
    """One step of each package from ``model``'s weights; the port's model
    is stepped in place."""
    jcfg = JaxConfig(**cfg_kw)
    img = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: JaxRAFT(jcfg).init(
        jax.random.PRNGKey(0), img, img, iters=1))
    variables = convert_state_dict(model.state_dict(), shapes)
    jtc = JaxTrainConfig(**train_kw)
    state = jax_state(jcfg, jtc, jax.random.PRNGKey(0),
                      init_variables=variables)
    new, jmetrics = jax.jit(jax_step(jcfg, jtc))(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))
    b1 = 0.9
    jgrads = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - b1), _find_mu(new.opt_state))})
    jafter = state_dict_from_flax({"params": _np(new.params),
                                   "batch_stats": _np(new.batch_stats)})

    tc = TrainConfig(**train_kw)
    pstate = create_train_state(model, tc)
    pmetrics = make_train_step(RAFTConfig(**cfg_kw), tc)(pstate, batch)
    lr0 = train_kw["lr"] / 25     # OneCycle's first learning rate
    return dict(model=model, lr=lr0, port=pmetrics, jax=_np(jmetrics),
                jgrads=jgrads, jafter=jafter, n=batch["valid"].size)


def _crop(path, top, left, h=64, w=128):
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
    return img[top:top + h, left:left + w]


@pytest.fixture(scope="module", params=["basic", "small"])
def case(request):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(corr_pallas, "_INTERPRET", True)
        mp.setattr(gru_pallas, "_INTERPRET", True)
        rng = np.random.RandomState(0)
        if request.param == "basic":
            im1 = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
            im2 = np.roll(im1, (2, 3), axis=(1, 2))
            model = RAFT(RAFTConfig(**KERNELS), torch.Generator().manual_seed(3))
            cfg_kw = KERNELS
            train_kw = dict(stage="chairs", batch_size=2, image_size=(64, 64),
                            iters=2, lr=4e-4, add_noise=False)
            grad_rtol = 5e-2
        else:
            im1 = np.stack([_crop(FRAMES[0], 186, 448), _crop(FRAMES[0], 120, 300)])
            im2 = np.stack([_crop(FRAMES[1], 186, 448), _crop(FRAMES[1], 120, 300)])
            model = load_pth(FIXTURE, RAFTConfig(small=True))
            cfg_kw = dict(small=True)
            train_kw = dict(stage="chairs", batch_size=2, image_size=(64, 128),
                            iters=12, lr=4e-4, add_noise=False)
            grad_rtol = 2e-2
        B, H, W, _ = im1.shape
        batch = {"image1": im1, "image2": im2,
                 "flow": (3 * rng.randn(B, H, W, 2)).astype(np.float32),
                 "valid": (rng.rand(B, H, W) > 0.2).astype(np.float32)}
        out = _run(model, cfg_kw, train_kw, batch)
    torch.set_num_threads(n)
    out.update(name=request.param, grad_rtol=grad_rtol)
    return out


def test_loss_and_metrics_match_jax(case):
    got = {k: float(v) for k, v in case["port"].items()}
    want = {k: float(v) for k, v in case["jax"].items()}
    assert sorted(got) == sorted(want)
    for k in ("loss", "epe"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    for k in ("1px", "3px", "5px"):
        assert abs(got[k] - want[k]) <= 2 / case["n"], k


def test_gradients_match_jax(case):
    params = dict(case["model"].named_parameters())
    want = {k: case["jgrads"][k].numpy() for k in params}
    gmax = max(np.abs(w).max() for w in want.values())
    assert gmax > 0
    rel = {}
    for k, p in params.items():
        got, w = p.grad.numpy(), want[k]
        assert got.shape == w.shape, k
        scale = np.abs(w).max()
        err = np.abs(got - w).max()
        assert err <= case["grad_rtol"] * scale + 1e-6 * gmax, (k, err, scale)
        if scale > 1e-4 * gmax:     # not a bias in front of a norm
            rel[k] = err / scale
    assert np.median(list(rel.values())) <= 1e-3, sorted(
        rel.items(), key=lambda kv: -kv[1])[:5]


def test_batchnorm_statistics_match_jax(case):
    sd = case["model"].state_dict()
    keys = [k for k in case["jafter"] if "running_" in k]
    assert bool(keys) == (case["name"] == "basic")
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), case["jafter"][k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    if keys:   # the batch norms moved off their (0, 1) start
        assert any(float(sd[k].abs().max()) > 1e-3 for k in keys
                   if k.endswith("running_mean"))


def test_parameters_after_the_step_match_jax(case):
    lr = case["lr"]
    for k, p in case["model"].named_parameters():
        got = p.detach().numpy()
        want = case["jafter"][k].numpy()
        d = np.abs(got - want)
        assert d.max() <= 2 * lr * (1 + 1e-4) + 1e-6, k
        g, w = p.grad.numpy(), case["jgrads"][k].numpy()
        same = (np.sign(g) == np.sign(w)) & (np.minimum(np.abs(g), np.abs(w))
                                             > 1e-5)
        assert (d[same] <= 1e-7 + 1e-6 * np.abs(want[same])).all(), k
