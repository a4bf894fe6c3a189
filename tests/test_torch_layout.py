"""The model's one activation layout: channels-last through the refinement
loop, on the CPU.

The weights are stored in their module's layout (channels-last but in the
feature encoder, whose instance norm keeps it NCHW). Every convolution of
the update block (the module convs and the GRU's
double-width gate convs, which call ``F.conv2d`` directly) must see a
channels-last-dense input and weight, and the fused GRU's gate and blend
kernels must get operands they read on the ``"channels_last"`` route, in
every mode the model runs: test mode, train mode with and without remat,
``forward_ragged`` and ``forward_cached``, for RAFT basic and RAFT small.
Each mode's outputs are held to an NCHW twin of the same model (every conv
given contiguous copies of its input and weight, which is the layout the
model ran in before it went channels-last) within the JAX-parity tests'
bounds (``test_torch_raft.py``): 5e-4 px for the small model's trained
fixture, 5e-3 px for the basic model at random init at iters=2.
"""

import os.path as osp

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.kernels import gru
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.models import update as update_mod
from raft_tpu_torch.tools.convert import load_pth

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
CL = torch.channels_last
#: convolutions per update-block call: the motion encoder's, the GRU's
#: gate (one double-width conv a half) and candidate convs, the heads'
CONVS = {"basic": 5 + 2 * 2 + 2 + 2, "small": 4 + 1 + 1 + 2}
#: of those, the mask head's, which test mode runs in the last step alone
MASK_CONVS = {"basic": 2, "small": 0}
TOL = {"basic": 5e-3, "small": 5e-4}
MODES = ("test", "train", "train_remat", "ragged", "cached")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name, remat=False):
    if name == "small":
        cfg = RAFTConfig(small=True, remat=remat)
        model = RAFT(cfg)
        model.load_state_dict(load_pth(FIXTURE, RAFTConfig(small=True))
                              .state_dict())
        return model
    return RAFT(RAFTConfig(gru_impl="fused", remat=remat),
                generator=torch.Generator().manual_seed(0))


def _images(B=2, H=64, W=64):
    rng = np.random.RandomState(0)
    im1 = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    im2 = np.roll(im1, (2, 3), axis=(1, 2))
    return torch.from_numpy(im1), torch.from_numpy(im2)


def _run(model, mode):
    """The mode's outputs as a list of tensors (train modes: the
    per-iteration stack)."""
    im1, im2 = _images()
    B, H, W = im1.shape[:3]
    if mode == "test":
        with torch.no_grad():
            return list(model(im1, im2, iters=2))
    if mode.startswith("train"):
        model.train()
        out = model(im1, im2, iters=2, test_mode=False, train=True)
        out.square().mean().backward()
        return [out.detach()]
    model.eval()
    with torch.no_grad():
        if mode == "ragged":
            vh = torch.tensor([H // 8, H // 8 - 2], dtype=torch.int32)
            vw = torch.tensor([W // 8, W // 8 - 3], dtype=torch.int32)
            return list(model.forward_ragged(im1, im2, vh, vw, iters=2))
        g = torch.Generator().manual_seed(1)
        cfg = model.config
        fmap1 = torch.randn((B, H // 8, W // 8, cfg.fnet_dim), generator=g)
        cnet1 = torch.randn((B, H // 8, W // 8, cfg.cnet_dim), generator=g)
        flow0 = torch.randn((B, H // 8, W // 8, 2), generator=g)
        return list(model.forward_cached(im2, fmap1, cnet1, flow0, iters=2))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["basic", "small"])
def test_refinement_loop_runs_channels_last(monkeypatch, name, mode):
    model = _model(name, remat=mode == "train_remat")
    # the weights in their module's layout: the update block's and the
    # context encoder's channels-last, the feature encoder's NCHW (its
    # instance norm normalises NCHW copies)
    assert model.fnet.memory_format == torch.contiguous_format
    assert model.cnet.memory_format == CL
    for mod, fmt in ((model.fnet, torch.contiguous_format), (model.cnet, CL),
                     (model.update_block, CL)):
        assert all(p.is_contiguous(memory_format=fmt)
                   for p in mod.parameters() if p.dim() == 4)
    inside = []          # the update block's calls in flight
    seen = []            # (input channels-last, weight channels-last)
    module_calls = []
    routes = []
    conv2d = F.conv2d

    def recording_conv2d(x, w, *args, **kwargs):
        if inside:
            seen.append((x.is_contiguous(memory_format=CL),
                         w.is_contiguous(memory_format=CL)))
        return conv2d(x, w, *args, **kwargs)

    def check_module(mod, args):
        module_calls.append((args[0].is_contiguous(memory_format=CL),
                             mod.weight.is_contiguous(memory_format=CL)))

    block = model.update_block
    block.register_forward_pre_hook(lambda m, a: inside.append(1))
    block.register_forward_hook(lambda m, a, o: inside.clear())
    for mod in block.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_pre_hook(check_module)
    monkeypatch.setattr(F, "conv2d", recording_conv2d)
    for fn in ("gru_gates", "gru_blend"):
        real = getattr(update_mod, fn)

        def recording(*ts, _real=real):
            routes.append(gru.layout(*ts))
            return _real(*ts)
        monkeypatch.setattr(update_mod, fn, recording)

    got = _run(model, mode)
    calls = 2 * (2 if mode == "train_remat" else 1)  # remat runs each twice
    skipped = 0 if mode.startswith("train") else MASK_CONVS[name]
    assert len(seen) == CONVS[name] * calls - skipped
    assert all(x and w for x, w in seen), seen
    assert module_calls and all(x and w for x, w in module_calls)
    if name == "basic":
        assert routes and set(routes) == {"channels_last"}
    else:
        assert routes == []      # the small model's GRU runs its plain tails
    assert all(t.is_contiguous() for t in got)

    # the NCHW twin: every conv on contiguous copies of its operands
    monkeypatch.setattr(
        F, "conv2d", lambda x, w, *a, **k: conv2d(x.contiguous(),
                                                  w.contiguous(), *a, **k))
    twin = _model(name, remat=mode == "train_remat")
    want = _run(twin, mode)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL[name],
                                   rtol=0)


def test_gate_conv_halves_are_views_whose_gradient_keeps_the_layout():
    """The double-width gate conv's halves are views of one channels-last
    output, and their gradients come back concatenated channels-last."""
    model = _model("basic")
    gru_block = model.update_block.gru
    x = torch.randn(2, 128 + 256, 6, 7).contiguous(memory_format=CL)
    x.requires_grad_()
    zl, rl = update_mod._pair_conv(gru_block.convz1, gru_block.convr1, x)
    assert zl._base is rl._base is not None
    assert zl.stride() == (6 * 7 * 256, 1, 7 * 256, 256)
    assert gru.layout(zl, rl) == "channels_last"
    # the halves' cotangents as the gate kernels' backward gives them:
    # dense channels-last
    gz, gr = (torch.randn(zl.shape).contiguous(memory_format=CL)
              for _ in range(2))
    grads = []
    zl._base.register_hook(grads.append)
    torch.autograd.backward([zl, rl], [gz, gr])
    assert grads[0].is_contiguous(memory_format=CL)
    torch.testing.assert_close(grads[0], torch.cat([gz, gr], 1), rtol=0,
                               atol=0)
    assert x.grad.is_contiguous(memory_format=CL)
