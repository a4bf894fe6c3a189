"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX (the card's machine has none); run there with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Every test asks the ``cuda`` fixture for the card, and skips when there is
none, as on a CPU-only host. Tolerances: 1e-5 for the lookup (both versions
lerp identical window values in fp32, in another order), 1e-6 for the fp32
gates and blend (expf/tanhf against PyTorch's, about an ulp), one bf16 ulp
for bf16 operands (the same fp32 value rounded once).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raft_tpu_torch import kernels
from raft_tpu_torch.kernels.corr_lookup import corr_lookup_cuda
from raft_tpu_torch.kernels.gru import (gru_blend, gru_blend_plain, gru_gates,
                                        gru_gates_plain)
from raft_tpu_torch.models.corr import corr_lookup_gather

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pyramid(rng, B, H, W, levels, dtype, dev):
    vol = torch.from_numpy(rng.randn(B, H * W, H, W).astype(np.float32))
    pyr = [vol.to(dev)]
    for _ in range(levels - 1):
        pyr.append(F.avg_pool2d(pyr[-1], 2, stride=2))
    return [v.to(dtype).contiguous() for v in pyr]


def _coords(rng, B, H, W, spread, dev):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([xs, ys], -1)[None].astype(np.float32)
    c = grid + spread * rng.randn(B, H, W, 2).astype(np.float32)
    far = rng.rand(B, H, W, 1) < 0.1
    c = np.where(far, c + 100 * np.sign(rng.randn(B, H, W, 2)), c)
    return torch.from_numpy(c.astype(np.float32)).to(dev)


@pytest.mark.parametrize("B,H,W,radius", [(1, 55, 128, 4), (2, 12, 20, 3),
                                          (1, 9, 33, 4), (2, 16, 16, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_matches_plain(cuda, B, H, W, radius, dtype):
    rng = np.random.RandomState(H * W + radius)
    pyr = _pyramid(rng, B, H, W, 4 if min(H, W) >= 8 else 2, dtype, cuda)
    coords = _coords(rng, B, H, W, 6.0, cuda)
    before = kernels.launch_counts()["corr_lookup"]
    got = corr_lookup_cuda(pyr, coords, radius)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["corr_lookup"] == before + 1
    want = corr_lookup_gather(pyr, coords, radius)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 2])
def test_gates_and_blend_match_plain(cuda, dtype, B):
    """Operands are the z/r halves of a double-width NCHW conv output, read
    in place (not contiguous when B > 1)."""
    g = torch.Generator(device="cuda").manual_seed(B)
    zr = (3 * torch.randn((B, 256, 55, 128), generator=g, device=cuda)).to(dtype)
    zl, rl = zr[:, :128], zr[:, 128:]
    h, ql = ((torch.randn((B, 128, 55, 128), generator=g, device=cuda)
              .to(dtype)) for _ in range(2))
    z, rh = gru_gates(zl, rl, h)
    out = gru_blend(z, h, ql)
    torch.cuda.synchronize()
    want_z, want_rh = gru_gates_plain(zl, rl, h)
    want_out = gru_blend_plain(z, h, ql)
    for got, want in ((z, want_z), (rh, want_rh), (out, want_out)):
        assert got.dtype == dtype and got.shape == want.shape
        diff = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert float(diff.max()) <= 1e-6
        else:
            assert bool((diff <= 2 ** -7 * want.float().abs().clamp(min=1)).all())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn((1, 8, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gru_gates(x.transpose(2, 3), x, x)
    with pytest.raises(ValueError, match="dtype"):
        gru_blend(x.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="device"):
        gru_gates(x, x.cpu(), x)
    pyr = [torch.randn((1, 16, 4, 4), device=cuda)]
    coords = torch.zeros((1, 4, 4, 2), device=cuda)
    with pytest.raises(ValueError, match="coords"):
        corr_lookup_cuda(pyr, coords.double(), 3)
    with pytest.raises(ValueError, match="level 0"):
        corr_lookup_cuda([pyr[0][:, :8]], coords, 3)
    with pytest.raises(ValueError, match="radius"):
        corr_lookup_cuda(pyr, coords, 0)


@pytest.mark.parametrize("radius", [4, 3])
def test_lookup_reads_empty_levels_as_zeros(cuda, radius):
    """A 3x5 grid pools to levels 3x5, 1x2, 0x1 and 0x0: the kernel masks
    every tap of an empty level, as the plain version reads it as zeros."""
    from raft_tpu_torch.models.corr import build_corr_pyramid

    g = torch.Generator(device="cuda").manual_seed(radius)
    f1, f2 = (torch.randn((2, 3, 5, 32), generator=g, device=cuda)
              for _ in range(2))
    pyr = build_corr_pyramid(f1, f2)
    assert [tuple(v.shape[2:]) for v in pyr] == [(3, 5), (1, 2), (0, 1), (0, 0)]
    coords = 8 * torch.rand((2, 3, 5, 2), generator=g, device=cuda) - 2
    got = corr_lookup_cuda(pyr, coords, radius)
    want = corr_lookup_gather(pyr, coords, radius)
    KK = (2 * radius + 1) ** 2
    assert not got[..., 2 * KK:].any()
    assert float((got - want).abs().max()) <= 1e-5
