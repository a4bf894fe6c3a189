"""The upsampling-mask head in the refinement loop, on the CPU.

Test mode reads the mask of the last refinement step alone (the convex
upsampler's input), so ``RAFT._refine`` runs the update block's mask head
in that step only; train mode stacks and supervises every step's mask, so
it runs the head in every step. Each mode is held bitwise to the loop the
model ran before, written here: every step calls the update block's
default form, which computes the mask, and test mode keeps the last one.
Covered: RAFT basic with plain and fused GRU tails, in fp32 and bf16,
GMA, ``forward_ragged`` and ``forward_cached``, and train mode with and
without remat, with and without ``raw_predictions``.
"""

import types

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.ops.flow_ops import (convex_upsample,
                                         convex_upsample_batched_raw,
                                         initialize_flow, subpixel_to_standard)

ITERS = 3


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _every_step_refine(self, lookup, net, inp, B, H, W, iters, flow_init,
                       test_mode, raw_predictions, device, attn=None):
    """The refinement loop with the mask head in every step: the update
    block's default call, the last step's mask upsampling the test-mode
    flow (whole images, RAFT basic or GMA)."""
    dt = self.config.compute_dtype
    coords0, coords1 = initialize_flow(B, H // 8, W // 8, device, 0)
    if flow_init is not None:
        coords1 = coords1 + flow_init
    flows, masks = [], []
    for _ in range(iters):
        coords1 = coords1.detach().contiguous()
        args = (net, inp, lookup(coords1).to(dt).permute(0, 3, 1, 2),
                (coords1 - coords0).to(dt).permute(0, 3, 1, 2))
        if attn is not None:
            args += (attn,)
        net, up_mask, delta = self.update_block(*args)
        coords1 = coords1 + delta.permute(0, 2, 3, 1).float()
        flows.append(coords1 - coords0)
        masks.append(up_mask.permute(0, 2, 3, 1))
    if test_mode:
        return flows[-1], convex_upsample(flows[-1], masks[-1])
    up = convex_upsample_batched_raw(torch.stack(flows), torch.stack(masks))
    return up if raw_predictions else subpixel_to_standard(up, H // 8,
                                                           W // 8)


def _model(gru_impl="xla", gma=False, mixed_precision=False, remat=False):
    model = RAFT(RAFTConfig(gru_impl=gru_impl, gma_heads=int(gma),
                            mixed_precision=mixed_precision, remat=remat),
                 generator=torch.Generator().manual_seed(0))
    if gma:
        # a nonzero aggregate, so the GRU's input depends on the attention
        with torch.no_grad():
            model.update_block.aggregator.gamma.fill_(1.0)
    return model.eval()


def _reference(model):
    """A twin of ``model`` (same weights) whose ``_refine`` is the loop
    above."""
    twin = _model(model.config.gru_impl, bool(model.config.gma_heads),
                  model.config.mixed_precision, model.config.remat)
    twin.load_state_dict(model.state_dict())
    twin._refine = types.MethodType(_every_step_refine, twin)
    return twin


def _images(B=2, H=64, W=64):
    rng = np.random.RandomState(0)
    im1 = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    im2 = np.roll(im1, (2, 3), axis=(1, 2))
    return torch.from_numpy(im1), torch.from_numpy(im2)


def _count_mask_calls(model):
    calls = []
    model.update_block.mask.register_forward_hook(
        lambda m, a, o: calls.append(1))
    return calls


def _run(model, mode):
    im1, im2 = _images()
    B, H, W = im1.shape[:3]
    with torch.no_grad():
        if mode == "plain":
            return model(im1, im2, iters=ITERS)
        if mode == "ragged":
            vh = torch.tensor([H // 8, H // 8 - 2], dtype=torch.int32)
            vw = torch.tensor([W // 8, W // 8 - 3], dtype=torch.int32)
            return model.forward_ragged(im1, im2, vh, vw, iters=ITERS)
        g = torch.Generator().manual_seed(1)
        cfg = model.config
        fmap1 = torch.randn((B, H // 8, W // 8, cfg.fnet_dim), generator=g)
        cnet1 = torch.randn((B, H // 8, W // 8, cfg.cnet_dim), generator=g)
        flow0 = torch.randn((B, H // 8, W // 8, 2), generator=g)
        return model.forward_cached(im2, fmap1, cnet1, flow0, iters=ITERS)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", [
    dict(mode="plain"),
    dict(mode="plain", gru_impl="fused"),
    dict(mode="plain", mixed_precision=True),
    dict(mode="plain", gma=True),
    dict(mode="ragged", gru_impl="fused"),
    dict(mode="cached", gru_impl="fused"),
], ids=["basic", "basic-fused", "basic-bf16", "gma", "ragged", "cached"])
def test_test_mode_flow_is_the_every_step_mask_loop_bitwise(case):
    case = dict(case)
    mode = case.pop("mode")
    model = _model(**case)
    calls = _count_mask_calls(model)
    got = _run(model, mode)
    assert len(calls) == 1           # the last step's head alone
    ref = _reference(model)
    ref_calls = _count_mask_calls(ref)
    want = _run(ref, mode)
    assert len(ref_calls) == ITERS
    _assert_bitwise(got, want)


@pytest.mark.parametrize("iters", [1, 2, 5])
def test_test_mode_runs_the_mask_head_once(iters):
    model = _model()
    calls = _count_mask_calls(model)
    im1, im2 = _images(B=1, H=32, W=32)
    with torch.no_grad():
        _, up = model(im1, im2, iters=iters)
    assert len(calls) == 1 and up.shape == (1, 32, 32, 2)


def test_small_model_has_no_mask_head():
    model = RAFT(RAFTConfig(small=True),
                 generator=torch.Generator().manual_seed(0)).eval()
    assert not hasattr(model.update_block, "mask")
    im1, im2 = _images(B=1, H=32, W=32)
    with torch.no_grad():
        low, up = model(im1, im2, iters=2)
    assert low.shape == (1, 4, 4, 2) and up.shape == (1, 32, 32, 2)


@pytest.mark.parametrize("raw", [False, True], ids=["standard", "raw"])
@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
def test_train_mode_keeps_every_mask_bitwise(remat, raw):
    model = _model(gru_impl="fused", remat=remat).train()
    ref = _reference(model).train()
    im1, im2 = _images()
    outs, grads = [], []
    for m in (model, ref):
        calls = _count_mask_calls(m)
        out = m(im1, im2, iters=ITERS, test_mode=False, train=True,
                raw_predictions=raw)
        assert len(calls) == ITERS   # counted before the backward's remat
        out.square().mean().backward()
        outs.append(out.detach())
        grads.append([p.grad for p in m.parameters()])
    _assert_bitwise([outs[0]], [outs[1]])
    _assert_bitwise(grads[0], grads[1])


def test_update_block_default_call_returns_the_mask():
    """The blocks' default call keeps the parent's ``(net, mask, delta)``;
    ``mask=False`` leaves the mask out and the rest bitwise."""
    block = _model().update_block
    g = torch.Generator().manual_seed(2)
    args = [torch.randn(s, generator=g) for s in
            ((2, 128, 6, 8), (2, 128, 6, 8), (2, 324, 6, 8), (2, 2, 6, 8))]
    args = [a.contiguous(memory_format=torch.channels_last) for a in args]
    with torch.no_grad():
        net, mask, delta = block(*args)
        net2, none, delta2 = block(*args, mask=False)
    assert mask.shape == (2, 576, 6, 8) and none is None
    _assert_bitwise([net2, delta2], [net, delta])
