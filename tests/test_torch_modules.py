"""The port's layers, encoders and update blocks against the JAX package's,
with the JAX module's weights mapped across by ``state_dict_from_flax``.

Norm scales, shifts and running statistics are randomized first, so the
batch/group norms are exercised with non-trivial parameters. Inputs are
NHWC numpy for JAX and NCHW for the port; outputs agree within 1e-4
(fp32 conv sums taken in another order by XLA and by PyTorch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.kernels import gru_pallas
from raft_tpu.models import encoders as jenc
from raft_tpu.models import layers as jlay
from raft_tpu.models import update as jupd
from raft_tpu_torch.models import encoders, layers, update
from raft_tpu_torch.tools.convert import state_dict_from_flax

TOL = 1e-4


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
    monkeypatch.setattr(gru_pallas, "_INTERPRET", True)


def _randomize_norms(tree, rng, path=()):
    """Numpy copy of a flax variable tree with random norm parameters."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize_norms(v, rng, p)
            continue
        v = np.array(v, dtype=np.float32)
        if p[0] == "batch_stats":
            v = (0.1 * rng.randn(*v.shape) if k == "mean"
                 else 0.5 + rng.rand(*v.shape)).astype(np.float32)
        elif "norm" in p[:-1] and k in ("scale", "bias"):
            v = ((1.0 if k == "scale" else 0.0)
                 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        out[k] = v
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _check(jmod, port, inputs, call=None, jcall=None):
    """Init ``jmod`` on NHWC ``inputs``, load its weights into ``port``
    (strict), run both, compare every output."""
    rng = np.random.RandomState(0)
    jin = [jnp.asarray(a) for a in inputs]
    call = call or (lambda m, *a: m(*a))
    jcall = jcall or (lambda m, v, *a: m.apply(v, *a))
    variables = _randomize_norms(jmod.init(jax.random.PRNGKey(0), *jin), rng)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    want = jcall(jmod, variables, *jin)
    with torch.no_grad():
        got = call(port.eval(), *[_nchw(a) for a in inputs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g = g.numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=TOL)


def _arr(*shape, scale=1.0, seed=1):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _cin(stride):
    return 16 if stride == 2 else 32   # a stride-1 block keeps its width


@pytest.mark.parametrize("norm,stride", [
    ("group", 2), ("batch", 2), ("instance", 2), ("none", 2), ("batch", 1)])
def test_residual_block(norm, stride):
    ura = dict(use_running_average=True)
    _check(jlay.ResidualBlock(32, norm, stride),
           layers.ResidualBlock(_cin(stride), 32, norm, stride),
           [_arr(2, 12, 10, _cin(stride))],
           jcall=lambda m, v, x: m.apply(v, x, **ura))


@pytest.mark.parametrize("norm,stride", [
    ("group", 2), ("batch", 2), ("instance", 2), ("none", 2), ("batch", 1)])
def test_bottleneck_block(norm, stride):
    ura = dict(use_running_average=True)
    _check(jlay.BottleneckBlock(32, norm, stride),
           layers.BottleneckBlock(_cin(stride), 32, norm, stride),
           [_arr(2, 12, 10, _cin(stride))],
           jcall=lambda m, v, x: m.apply(v, x, **ura))


@pytest.mark.parametrize("small,norm,dim", [
    (False, "instance", 256), (False, "batch", 256),
    (True, "instance", 128), (True, "none", 160)])
def test_encoder(small, norm, dim):
    jmod = (jenc.SmallEncoder if small else jenc.BasicEncoder)(dim, norm)
    port = (encoders.SmallEncoder if small else encoders.BasicEncoder)(
        dim, norm)
    _check(jmod, port, [_arr(2, 32, 24, 3)],
           jcall=lambda m, v, x: m.apply(v, x, train=False,
                                         use_running_average=True))


def test_flow_head():
    _check(jupd.FlowHead(256), update.FlowHead(128, 256),
           [_arr(2, 6, 8, 128, scale=0.5)])


def test_conv_gru():
    _check(jupd.ConvGRU(96), update.ConvGRU(96, 146),
           [_arr(2, 6, 8, 96, scale=0.5), _arr(2, 6, 8, 146, seed=2)])


@pytest.mark.parametrize("fused", [False, True])
def test_sep_conv_gru(fused):
    _check(jupd.SepConvGRU(128), update.SepConvGRU(128, 256, fused=fused),
           [_arr(2, 6, 8, 128, scale=0.5), _arr(2, 6, 8, 256, seed=2)])


@pytest.mark.parametrize("small", [False, True])
def test_motion_encoder(small):
    planes = 196 if small else 324
    jmod = jupd.SmallMotionEncoder() if small else jupd.BasicMotionEncoder()
    port = (update.SmallMotionEncoder if small
            else update.BasicMotionEncoder)(planes)
    _check(jmod, port, [_arr(2, 6, 8, 2, scale=3.0),
                        _arr(2, 6, 8, planes, seed=2)])


@pytest.mark.parametrize("jax_block", ["BasicUpdateBlock",
                                       "FusedBasicUpdateBlock"])
@pytest.mark.parametrize("fused", [False, True])
def test_basic_update_block(jax_block, fused):
    """Both JAX blocks (reference NHWC and lane-major + Pallas epilogues)
    against both port forms (plain tails and the gate/blend wrappers)."""
    _check(getattr(jupd, jax_block)(128),
           update.BasicUpdateBlock(324, 128, fused=fused),
           [_arr(2, 6, 8, 128, scale=0.5), _arr(2, 6, 8, 128, seed=2),
            _arr(2, 6, 8, 324, seed=3), _arr(2, 6, 8, 2, scale=3.0, seed=4)])


def test_small_update_block():
    _check(jupd.SmallUpdateBlock(96), update.SmallUpdateBlock(196, 96),
           [_arr(2, 6, 8, 96, scale=0.5), _arr(2, 6, 8, 64, seed=2),
            _arr(2, 6, 8, 196, seed=3), _arr(2, 6, 8, 2, scale=3.0, seed=4)])
