"""GMA's kernels (K6, K7: ``raft_tpu_torch/kernels/gma.py``) on the card,
and a GMA bucket of the serving engine.

Imports no JAX (the card's machine has none); run there with

    python -m pytest --noconftest -m gpu tests/test_torch_gma_gpu.py

Every test asks the ``cuda`` fixture for the card, and skips when there is
none, as on a CPU-only host. K6 and K7 compute to float32 accuracy: each is
held against float64 on sampled rows, within twice the error of PyTorch's
own float32 products (cuBLAS with TF32 off) on the same rows, or within
1e-5 of the largest value where cuBLAS errs less (its sums of thousands of
float32 terms run in another order; one TF32 product errs by ~1e-3), at
batch 2 on the 1080p cell's 135x240 grid, on the 136x240 grid and at a
ragged width; K7 also where its 128-row tiles and 32-key slabs run past N
and on a padded A. A captured GMA bucket replays one K6 and 20 K7, and
reads γ swapped after the capture.
"""

import json
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.kernels.gma import gma_aggregate, gma_attention
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.serving.engine import RAFTEngine

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 128 ** -0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(B, H, W, dev, seed):
    """q and k as the halves of one (B, N, 256) tensor (the W_qk conv's
    channels-last output), logits of about 4 in spread, v and m."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qk = torch.randn(B, H * W, 256, generator=g, device=dev) * 2.0
    q, k = qk.split(128, -1)
    v = torch.randn(B, H * W, 128, generator=g, device=dev)
    m = torch.randn(B, H * W, 128, generator=g, device=dev)
    return q, k, v, m


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def _fp32(lib_err):
    """The largest error a float32-accurate kernel may show, given
    cuBLAS's float32 error on the same rows."""
    return max(2 * lib_err, 1e-5)


@pytest.mark.parametrize("B,H,W", [(2, 135, 240), (2, 136, 240),
                                   (1, 45, 81)])
def test_kernels_hold_float32_accuracy(cuda, B, H, W):
    q, k, v, m = _operands(B, H, W, cuda, H * W)
    gamma = torch.tensor([0.7], device=cuda)
    N = H * W
    rows = torch.randperm(N, device=cuda)[:512]
    before = kernels.launch_counts()
    attn = gma_attention(q, k, SCALE)
    g = gma_aggregate(attn, v, m, gamma)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gma_attention"] - before["gma_attention"] == 1
    assert after["gma_aggregate"] - before["gma_aggregate"] == 1
    assert attn.shape == (B, N, N) and g.shape == (B, N, 128)

    want_a = torch.softmax((q[:, rows].double() * SCALE)
                           @ k.double().transpose(1, 2), -1)
    lib_a = torch.softmax((q * SCALE) @ k.transpose(1, 2), -1)[:, rows]
    assert _rel(attn[:, rows], want_a) <= _fp32(_rel(lib_a, want_a))
    assert float(attn[:, rows].sum(-1).sub(1).abs().max()) < 1e-5

    want_g = m[:, rows].double() + 0.7 * (attn[:, rows].double()
                                          @ v.double())
    lib_g = (m + gamma * (attn @ v))[:, rows]
    assert _rel(g[:, rows], want_g) <= _fp32(_rel(lib_g, want_g))


@pytest.mark.parametrize("B,H,W,pad", [
    (1, 7, 9, 0),      # N = 63: under one 128-row tile and two 32-key slabs
    (1, 21, 61, 0),    # N = 1281: one past 10 row tiles and 40 key slabs
    (2, 24, 40, 12),   # batch 2, A's rows 972 apart (N = 960)
])
def test_aggregate_edges_hold_float32_accuracy(cuda, B, H, W, pad):
    """K7 where its tiles and slabs run past N, and on an A whose rows are
    padded: every row against float64, within twice cuBLAS's float32 error
    there."""
    q, k, v, m = _operands(B, H, W, cuda, 7 * H + W)
    gamma = torch.tensor([0.7], device=cuda)
    N = H * W
    attn = gma_attention(q, k, SCALE)
    if pad:
        attn = torch.zeros(B, N, N + pad, device=cuda)[:, :, :N].copy_(attn)
        assert attn.stride(1) == N + pad
    g = gma_aggregate(attn, v, m, gamma)
    want = m.double() + 0.7 * (attn.double() @ v.double())
    lib = m + gamma * (attn @ v)
    assert _rel(g, want) <= _fp32(_rel(lib, want))


def test_aggregate_reads_a_transposed_view(cuda):
    """``Aᵀ`` (the planted fault's view), which the kernel cannot read in
    place, is copied into a layout it can and gives ``m + γ·(Aᵀ v)``; so
    does an A whose rows are not 16 bytes apart."""
    q, k, v, m = _operands(1, 24, 40, cuda, 3)
    gamma = torch.tensor([0.5], device=cuda)
    attn = gma_attention(q, k, SCALE)
    got = gma_aggregate(attn.transpose(1, 2), v, m, gamma)
    want = m.double() + 0.5 * (attn.double().transpose(1, 2) @ v.double())
    assert _rel(got, want) < 1e-5
    odd = torch.empty(1, 960, 961, device=cuda)[:, :, 1:].copy_(attn)
    got = gma_aggregate(odd, v, m, gamma)
    want = m.double() + 0.5 * (attn.double() @ v.double())
    assert _rel(got, want) < 1e-5


def test_wrappers_refuse(cuda):
    q, k, v, m = _operands(1, 8, 8, cuda, 0)
    with pytest.raises(ValueError, match="float32"):
        gma_attention(q.half(), k.half(), SCALE)
    with pytest.raises(ValueError, match="backward"):
        gma_attention(q.detach().requires_grad_(), k, SCALE)
    attn = gma_attention(q, k, SCALE)
    with pytest.raises(ValueError, match="gamma"):
        gma_aggregate(attn, v, m, torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        gma_aggregate(attn, v.transpose(1, 2).contiguous().transpose(1, 2),
                      m, torch.ones(1, device=cuda))


def test_gma_bucket_replays_one_k6_and_twenty_k7(cuda):
    """A captured GMA bucket at iters 20: one K6 and 20 K7 launches a
    replay (and RAFT's 20 K1, 40 gates and 40 blends), and its flow is the
    eager forward's."""
    with open(os.path.join(ROOT, "flowbench", "configs", "gma.json")) as f:
        cfg = json.load(f)
    config = RAFTConfig(gma_heads=1, **cfg["program"])
    model = RAFT(config)
    with torch.no_grad():
        model.update_block.aggregator.gamma.fill_(1.0)
    shape = (2, 128, 256)
    engine = RAFTEngine(model.state_dict(), config=config, iters=20,
                        envelope=[shape], wire="u8", device="cuda")
    prog = engine._programs[shape]
    assert prog.launches == {"gma_attention": 1, "gma_aggregate": 20,
                             "corr_lookup": 20, "gru_gates": 40,
                             "gru_blend": 40}
    rng = np.random.default_rng(0)
    im1, im2 = (rng.integers(0, 256, (2, 128, 256, 3), dtype=np.uint8)
                for _ in range(2))
    before = engine.replayed_launches()
    flows = engine.infer_batch(im1, im2)
    after = engine.replayed_launches()
    assert after["gma_attention"] - before.get("gma_attention", 0) == 1
    assert after["gma_aggregate"] - before.get("gma_aggregate", 0) == 20
    model = model.to(cuda).eval()
    with torch.no_grad():
        _, up = model(torch.from_numpy(im1).to(cuda).float(),
                      torch.from_numpy(im2).to(cuda).float(), iters=20)
    gap = np.sqrt(((np.asarray(flows) - up.cpu().numpy()) ** 2).sum(-1))
    assert float(gap.mean()) < 1e-3


def test_gma_replay_reads_gamma_swapped_after_capture(cuda):
    """γ swapped by ``update_weights`` after a GMA bucket's capture: the
    next replay's K7 reads the new value on the device, so its flow is the
    eager forward's at the new γ and not the old one's."""
    with open(os.path.join(ROOT, "flowbench", "configs", "gma.json")) as f:
        cfg = json.load(f)
    config = RAFTConfig(gma_heads=1, **cfg["program"])
    model = RAFT(config)
    with torch.no_grad():
        model.update_block.aggregator.gamma.fill_(1.0)
        model.att.to_qk.weight.mul_(12.0)     # peaked rows, as the cell's
    shape = (1, 64, 96)
    engine = RAFTEngine(model.state_dict(), config=config, iters=6,
                        envelope=[shape], wire="u8", device="cuda")
    rng = np.random.default_rng(1)
    im1, im2 = (rng.integers(0, 256, (1, 64, 96, 3), dtype=np.uint8)
                for _ in range(2))
    before_swap = np.asarray(engine.infer_batch(im1, im2))
    with torch.no_grad():
        model.update_block.aggregator.gamma.fill_(0.25)
    engine.update_weights(model.state_dict())
    before = engine.replayed_launches().get("gma_aggregate", 0)
    flows = np.asarray(engine.infer_batch(im1, im2))
    assert engine.replayed_launches()["gma_aggregate"] - before == 6
    model = model.to(cuda).eval()
    with torch.no_grad():
        _, up = model(torch.from_numpy(im1).to(cuda).float(),
                      torch.from_numpy(im2).to(cuda).float(), iters=6)
    gap = np.sqrt(((flows - up.cpu().numpy()) ** 2).sum(-1))
    moved = np.sqrt(((flows - before_swap) ** 2).sum(-1))
    assert float(gap.mean()) < 1e-3
    assert float(moved.mean()) > 100 * float(gap.mean())
