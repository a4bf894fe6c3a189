"""The port's CUDA kernels against their plain PyTorch versions, on the card,
forward and backward, and gradients through them.

Imports no JAX (the card's machine has none); run there with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Every test asks the ``cuda`` fixture for the card, and skips when there is
none, as on a CPU-only host. Tolerances: 1e-5 for the lookup (both versions
lerp identical window values in fp32, in another order), 1e-6 for the fp32
gates and blend (expf/tanhf against PyTorch's, about an ulp), one bf16 ulp
for bf16 operands (the same fp32 value rounded once). The scatter (the
lookup's backward) is held within 1e-5 of the plain VJP in fp32, and a bf16
gradient volume within half a bf16 ulp (plus 1e-5) of the plain fp32 VJP,
which it rounds once. The on-the-fly lookup (K5) is held within 1e-5 plus
1e-5 relative of ``alt_corr_lookup`` (the same products summed over C in
another order), with exact zeros for far-out queries and empty levels.
"""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raft_tpu_torch import kernels
from raft_tpu_torch.kernels.corr_lookup import (corr_lookup_bwd_plain,
                                                corr_lookup_cuda,
                                                corr_scatter_cuda)
from raft_tpu_torch.kernels.gru import (gru_blend, gru_blend_bwd,
                                        gru_blend_bwd_plain, gru_blend_plain,
                                        gru_gates, gru_gates_bwd,
                                        gru_gates_bwd_plain, gru_gates_plain)
from raft_tpu_torch.models.corr import (build_corr_pyramid, corr_lookup,
                                        corr_lookup_gather)

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


def _coords(rng, B, H, W, spread, dev, out=100):
    """grid + ``spread`` px of noise, a tenth of the queries ``out`` px out"""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([xs, ys], -1)[None].astype(np.float32)
    c = grid + spread * rng.randn(B, H, W, 2).astype(np.float32)
    far = rng.rand(B, H, W, 1) < 0.1
    c = np.where(far, c + out * np.sign(rng.randn(B, H, W, 2)), c)
    return torch.from_numpy(c.astype(np.float32)).to(dev)


@pytest.mark.parametrize("B,H,W,radius", [(1, 55, 128, 4), (2, 12, 20, 3),
                                          (1, 9, 33, 4), (2, 16, 16, 1),
                                          (10, 46, 62, 4), (1, 5, 7, 19)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_matches_plain(cuda, B, H, W, radius, dtype):
    """The inference (1,55,128) and training (10,46,62) geometries among
    them, and the largest radius the wrappers take."""
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
    with pytest.raises(ValueError, match="radius"):
        corr_lookup_cuda(pyr, coords, 20)       # MAX_RADIUS is 19


@pytest.mark.parametrize("radius", [4, 3])
def test_lookup_reads_empty_levels_as_zeros(cuda, radius):
    """A 3x5 grid pools to levels 3x5, 1x2, 0x1 and 0x0: the kernel masks
    every tap of an empty level, as the plain version reads it as zeros."""
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


def _bf16_close(got, want32):
    """A bf16 value rounded once from ``want32``: within half a bf16 ulp
    (2^-8 of its magnitude) plus 1e-5."""
    return bool(((got.float() - want32).abs()
                 <= 2 ** -8 * want32.abs() + 1e-5).all())


@pytest.mark.parametrize("B,H,W,radius", [(1, 46, 62, 4), (2, 12, 20, 3),
                                          (1, 9, 33, 4), (2, 3, 5, 4),
                                          (1, 5, 7, 19)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_matches_plain_vjp(cuda, B, H, W, radius, dtype):
    """A tenth of the queries 100 px out of range; the 3x5 grid has two
    empty levels, whose gradients are empty; r=19 is the largest radius
    the wrapper takes."""
    rng = np.random.RandomState(H * W + radius)
    if min(H, W) >= 8:
        pyr = _pyramid(rng, B, H, W, 4, dtype, cuda)
    else:
        f1, f2 = (torch.from_numpy(rng.randn(B, H, W, 32).astype(np.float32))
                  .to(cuda) for _ in range(2))
        pyr = [v.to(dtype) for v in build_corr_pyramid(f1, f2)]
    coords = _coords(rng, B, H, W, 6.0, cuda)
    K2 = (2 * radius + 1) ** 2
    g = torch.from_numpy(rng.randn(B, H, W, 4 * K2).astype(np.float32)).to(cuda)
    before = kernels.launch_counts()["corr_scatter"]
    got = corr_scatter_cuda(g, pyr, coords, radius)
    again = corr_scatter_cuda(g, pyr, coords, radius)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["corr_scatter"] == before + 2
    want = corr_lookup_bwd_plain(g, [v.float() for v in pyr], coords, radius)
    for a, b, w, v in zip(got, again, want, pyr):
        assert a.shape == v.shape and a.dtype == dtype
        assert torch.equal(a, b)      # no atomics: bitwise run to run
        if a.numel() == 0:
            continue
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-5
        else:
            assert _bf16_close(a, w)
    plain = corr_lookup_bwd_plain(g, pyr, coords, radius)
    assert [p.dtype for p in plain] == [dtype] * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 2])
def test_gru_backward_kernels_match_plain(cuda, dtype, B):
    """zl and rl are the halves of a double-width conv output (not
    contiguous when B > 1), as on the main path."""
    g = torch.Generator(device="cuda").manual_seed(10 + B)

    def rand(*shape):
        return (3 * torch.randn(shape, generator=g, device=cuda)).to(dtype)

    zr = rand(B, 256, 46, 62)
    zl, rl = zr[:, :128], zr[:, 128:]
    h, dz, drh, z, ql, go = (rand(B, 128, 46, 62) for _ in range(6))
    z = torch.sigmoid(z.float()).to(dtype)
    pairs = ((gru_gates_bwd(zl, rl, h, dz, drh),
              gru_gates_bwd_plain(zl, rl, h, dz, drh)),
             (gru_blend_bwd(z, h, ql, go), gru_blend_bwd_plain(z, h, ql, go)))
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, w in zip(got, want):
            assert a.dtype == dtype and a.shape == w.shape and a.is_contiguous()
            diff = (a.float() - w.float()).abs()
            if dtype == torch.float32:
                assert float(diff.max()) <= 1e-6 * max(1.0, float(w.abs().max()))
            else:
                assert bool((diff <= 2 ** -7 * w.float().abs().clamp(min=1)).all())


@pytest.mark.parametrize("hw", [(55, 128), (46, 62)],
                         ids=["440x1024", "368x496"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_gru_kernels_read_nhwc_and_nchw_halves(cuda, layout, dtype, B, hw):
    """K2 and K4 at the inference and training 1/8 grids, on the halves of
    a double-width gate conv output in either layout (NHWC: rows of 128
    channels 256 apart; NCHW: one run a batch element) and, for the gates'
    backward, a channel slice of a concatenation's gradient as ``drh``:
    each equals its plain version, its outputs take the operands' layout,
    and ``launch_layouts()`` counts each launch under that layout."""
    fmt = torch.channels_last if layout == "channels_last" else \
        torch.contiguous_format
    g = torch.Generator(device="cuda").manual_seed(100 * B + hw[0])

    def rand(C):
        return (3 * torch.randn((B, C) + hw, generator=g, device=cuda)).to(
            dtype).contiguous(memory_format=fmt)

    zl, rl = rand(256).split(128, 1)
    h, ql, dz, go = (rand(128) for _ in range(4))
    drh = rand(384)[:, :128]
    z = torch.sigmoid(rand(128).float()).to(dtype)
    before = kernels.launch_layouts()
    pairs = {"gru_gates": (gru_gates(zl, rl, h), gru_gates_plain(zl, rl, h)),
             "gru_blend": ((gru_blend(z, h, ql),),
                           (gru_blend_plain(z, h, ql),)),
             "gru_gates_bwd": (gru_gates_bwd(zl, rl, h, dz, drh),
                               gru_gates_bwd_plain(zl, rl, h, dz, drh)),
             "gru_blend_bwd": (gru_blend_bwd(z, h, ql, go),
                               gru_blend_bwd_plain(z, h, ql, go))}
    torch.cuda.synchronize()
    after = kernels.launch_layouts()
    other = "contiguous" if layout == "channels_last" else "channels_last"
    for name, (got, want) in pairs.items():
        assert after[name][layout] == before[name][layout] + 1
        assert after[name][other] == before[name][other]
        for a, w in zip(got, want):
            assert a.dtype == dtype and a.shape == w.shape
            assert a.is_contiguous(memory_format=fmt)
            diff = (a.float() - w.float()).abs()
            if dtype == torch.float32:
                assert float(diff.max()) <= 1e-6 * max(1.0,
                                                       float(w.abs().max()))
            else:
                assert bool((diff <= 2 ** -7 * w.float().abs().clamp(min=1))
                            .all())


def test_channels_last_gru_gradients_match_plain(cuda):
    """The SepConvGRU as the model runs it, channels-last weights and
    activations: the gradients through K2 and K4 equal the plain tails'
    (1e-4 of the largest, as for NCHW below), and every GRU launch takes
    the channels-last route."""
    from raft_tpu_torch.models.update import SepConvGRU

    torch.manual_seed(1)
    cl = torch.channels_last
    fused = SepConvGRU(128, 256, fused=True).to(cuda, memory_format=cl)
    plain = SepConvGRU(128, 256, fused=False).to(cuda, memory_format=cl)
    plain.load_state_dict(fused.state_dict())
    h0, x0, Gh = (torch.randn(2, c, 23, 31, device=cuda)
                  .contiguous(memory_format=cl) for c in (128, 256, 128))
    kernels.reset_launch_counts()
    res = {}
    for name, mod in (("fused", fused), ("plain", plain)):
        h, x = h0.clone().requires_grad_(), x0.clone().requires_grad_()
        out = mod(h, x)
        assert out.is_contiguous(memory_format=cl)
        (out * Gh).sum().backward()
        res[name] = [h.grad, x.grad] + [p.grad for p in mod.parameters()]
    layouts = kernels.launch_layouts()
    for name in ("gru_gates", "gru_blend", "gru_gates_bwd", "gru_blend_bwd"):
        assert layouts[name] == {"channels_last": 2, "contiguous": 0}
    for a, b in zip(res["fused"], res["plain"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_gradients_flow_through_the_forward_kernels(cuda):
    """A backward through the lookup kernel and the fused SepConvGRU gives
    the gradients of the plain versions (1e-5 of the largest for the
    lookup, 1e-4 for the GRU's convs and inputs, whose fp32 sums take
    another order), and launches the backward kernels."""
    from raft_tpu_torch.models.update import SepConvGRU

    rng = np.random.RandomState(0)
    base = _pyramid(rng, 2, 12, 20, 4, torch.float32, cuda)
    coords = _coords(rng, 2, 12, 20, 4.0, cuda)
    G = torch.from_numpy(rng.randn(2, 12, 20, 324).astype(np.float32)).to(cuda)
    grads = {}
    for impl in ("pallas", "gather"):
        pyr = [v.clone().requires_grad_() for v in base]
        out = corr_lookup(pyr, coords, 4, impl)
        assert out.grad_fn is not None
        (out * G).sum().backward()
        grads[impl] = [v.grad for v in pyr]
    for a, b in zip(grads["pallas"], grads["gather"]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())

    torch.manual_seed(0)
    fused = SepConvGRU(128, 256, fused=True).to(cuda)
    plain = SepConvGRU(128, 256, fused=False).to(cuda)
    plain.load_state_dict(fused.state_dict())
    h0 = torch.randn(2, 128, 23, 31, device=cuda)
    x0 = torch.randn(2, 256, 23, 31, device=cuda)
    Gh = torch.randn(2, 128, 23, 31, device=cuda)
    before = kernels.launch_counts()
    res = {}
    for name, mod in (("fused", fused), ("plain", plain)):
        h, x = h0.clone().requires_grad_(), x0.clone().requires_grad_()
        out = mod(h, x)
        assert out.grad_fn is not None
        (out * Gh).sum().backward()
        res[name] = [h.grad, x.grad] + [p.grad for p in mod.parameters()]
    after = kernels.launch_counts()
    assert after["gru_gates_bwd"] - before["gru_gates_bwd"] == 2
    assert after["gru_blend_bwd"] - before["gru_blend_bwd"] == 2
    for a, b in zip(res["fused"], res["plain"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _field_coords(rng, B, H, W, field, dev, out=100):
    """Coords of one of K5's fields, with a tenth of the queries ``out`` px
    out:
    "iid" (3 px of noise per query); "smooth" (a flow of (-3, -2) plus up
    to +-8 px whose wavelength is the grid width, and a 20 px jump in x at
    a vertical boundary through a column of 8x8 tiles: every tile's box
    stays small); "boundary" (the same with a 60 px jump: the boundary's
    tiles have boxes over the kernel's limit); "edges" (the grid spread by
    1.3 about its centre: windows straddle every edge of every level)."""
    if field == "iid":
        return _coords(rng, B, H, W, 3.0, dev, out)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    if field == "edges":
        c = np.stack([(xs - W / 2) * 1.3 + W / 2, (ys - H / 2) * 1.3 + H / 2], -1)
    else:
        jump = {"smooth": 20.0, "boundary": 60.0}[field]
        u = -3 + 8 * np.sin(2 * np.pi * (xs + ys) / W) + jump * (xs >= W // 2 + 3)
        v = -2 + 8 * np.cos(2 * np.pi * (xs - ys) / W)
        c = np.stack([xs + u, ys + v], -1)
    c = np.broadcast_to(c, (B, H, W, 2))
    far = rng.rand(B, H, W, 1) < 0.1
    c = np.where(far, c + out * np.sign(rng.randn(B, H, W, 2)), c)
    return torch.from_numpy(c.astype(np.float32)).to(dev)


def _alt_inputs(rng, B, H, W, C, levels, dev, field="iid", out=100,
                scale=1.0):
    """fmap1, an NHWC fmap2 pyramid pooled from a random fmap2 (both
    ``scale`` times unit variance; levels may come out empty), and coords
    of ``field`` with one window straddling the top-left edge."""
    from raft_tpu_torch.models.corr import AlternateCorrBlock

    f1, f2 = (torch.from_numpy((scale * rng.randn(B, H, W, C))
                               .astype(np.float32)).to(dev) for _ in range(2))
    block = AlternateCorrBlock(f1, f2, levels)
    coords = _field_coords(rng, B, H, W, field, dev, out)
    coords[0, 0, 0] = torch.tensor([-0.5, -1.5])
    return block.fmap1, block.fmap2_pyramid, coords.contiguous()


def _straddled_edges(coords, pyr, radius):
    """Per non-empty level, which of its four edges some query's
    (2r+2)² window straddles (part in, part out)."""
    P = 2 * radius + 2
    out = []
    for i, v in enumerate(pyr):
        Hl, Wl = v.shape[1:3]
        if v.numel() == 0:
            continue
        edges = set()
        for axis, size, lo, hi in ((0, Wl, "left", "right"),
                                   (1, Hl, "top", "bottom")):
            c = (coords[..., axis] / 2 ** i).clamp(-(radius + 2.0),
                                                   size + radius + 1.0)
            o = torch.floor(c) - radius
            if bool(((o < 0) & (o + P - 1 >= 0)).any()):
                edges.add(lo)
            if bool(((o <= size - 1) & (o + P - 1 > size - 1)).any()):
                edges.add(hi)
        out.append(edges)
    return out


@pytest.mark.parametrize("field,B,H,W,C,radius", [
    ("iid", 1, 47, 156, 256, 4), ("iid", 1, 55, 128, 128, 3),
    ("iid", 2, 12, 20, 16, 2), ("iid", 2, 3, 5, 36, 4),
    ("smooth", 1, 48, 160, 256, 4), ("smooth", 2, 20, 30, 132, 3),
    ("boundary", 1, 48, 160, 256, 4), ("edges", 1, 47, 156, 128, 3),
    ("edges", 2, 13, 21, 132, 4), ("iid", 1, 9, 11, 8, 10),
    ("smooth x3", 1, 48, 160, 256, 4), ("iid x3", 1, 48, 160, 256, 4),
    ("boundary x3", 1, 48, 160, 256, 4)])
def test_alt_lookup_matches_plain(cuda, field, B, H, W, C, radius):
    """K5 against ``alt_corr_lookup`` within 1e-5 + 1e-5 relative (the same
    products summed over C in another order, on the tensor cores through
    the error-compensated TF32 split or on the CUDA cores); far-out queries
    exact zeros; two calls bitwise equal. Grids whose sides are not
    multiples of the 8x8 tile, B = 2, C = 132 (a multiple of 4, not of 8)
    and the largest radius the wrapper takes; the 3x5 grid's last two
    levels are empty. "x3" makes the fmaps three times unit variance, twice
    the rms the model's encoders give K5 (1.4-1.5): the tolerance's
    absolute part does not grow with them while the dots' rounding does. The branch counter shows which branch the tiles
    took: at least 90% tiled on the smooth field, both across the 60 px
    boundary, and the "edges" field's windows straddle every edge of every
    level."""
    from raft_tpu_torch.kernels.corr_alt import (alt_corr_lookup_cuda,
                                                 branch_counts)
    from raft_tpu_torch.models.corr import alt_corr_lookup

    rng = np.random.RandomState(C + radius)
    field, _, times = field.partition(" x")
    # far-out queries beyond every level's reach, (r+1)·2^3 px
    f1, pyr, coords = _alt_inputs(rng, B, H, W, C, 4, cuda, field,
                                  max(100, 8 * (radius + 2)),
                                  float(times or 1))
    before = kernels.launch_counts()["corr_alt"]
    branch_counts(cuda).zero_()
    got = alt_corr_lookup_cuda(f1, pyr, coords, radius)
    tiled, per_query = branch_counts(cuda).tolist()
    again = alt_corr_lookup_cuda(f1, pyr, coords, radius)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["corr_alt"] == before + 2
    tiles = B * -(-H // 8) * -(-W // 8) * len(pyr)
    assert tiled + per_query == tiles
    if field == "smooth":
        # tiles holding a far-out query that lands back in a coarse level
        # may have boxes over the limit
        assert tiled >= 0.9 * tiles
    if field == "boundary":
        assert tiled > 0 and per_query > 0
    if field == "edges":
        assert all(e == {"left", "right", "top", "bottom"}
                   for e in _straddled_edges(coords, pyr, radius))
    want = alt_corr_lookup(f1, pyr, coords, radius)
    assert got.shape == want.shape and torch.equal(got, again)
    assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    # outside every level's window reach: (r+1)·2^3 px past the image
    m = (radius + 1) * 8 + 1
    x, y = coords[..., 0], coords[..., 1]
    far = (x < -m) | (x > W - 1 + m) | (y < -m) | (y > H - 1 + m)
    assert bool(far.any()) and not got[far].any()
    for v, lvl in zip(pyr, got.split((2 * radius + 1) ** 2, dim=-1)):
        if v.numel() == 0:
            assert not lvl.any()


def test_alt_lookup_gradients_match_plain_autograd(cuda):
    """``AltCorrLookup``'s backward (the plain version's VJP) gives the
    gradients of plain autograd for fmap1, every level and the coords,
    within 1e-5 of each one's largest (``index_put`` accumulates in another
    order)."""
    from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda
    from raft_tpu_torch.models.corr import alt_corr_lookup

    rng = np.random.RandomState(3)
    f1, pyr, coords = _alt_inputs(rng, 2, 12, 20, 64, 4, cuda)
    g = torch.from_numpy(rng.randn(2, 12, 20, 4 * 81).astype(np.float32)).to(cuda)
    res = {}
    for name, fn in (("kernel", alt_corr_lookup_cuda), ("plain", alt_corr_lookup)):
        leaves = [t.clone().requires_grad_() for t in [f1, coords, *pyr]]
        out = fn(leaves[0], leaves[2:], leaves[1], 4)
        res[name] = torch.autograd.grad(out, leaves, g)
    for a, b in zip(res["kernel"], res["plain"]):
        assert float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_alt_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda

    f1 = torch.randn((1, 4, 4, 8), device=cuda)
    coords = torch.zeros((1, 4, 4, 2), device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        alt_corr_lookup_cuda(f1[..., :6], [f1[..., :6]], coords, 3)
    with pytest.raises(ValueError, match="float32"):
        alt_corr_lookup_cuda(f1.double(), [f1.double()], coords, 3)
    with pytest.raises(ValueError, match="contiguous"):
        alt_corr_lookup_cuda(f1, [f1.transpose(1, 2)], coords, 3)
    with pytest.raises(ValueError, match="radius"):
        alt_corr_lookup_cuda(f1, [f1], coords, 11)   # MAX_RADIUS is 10
    with pytest.raises(ValueError, match="levels"):
        alt_corr_lookup_cuda(f1, [f1] * 9, coords, 3)


def test_alternate_corr_model_runs_through_k5(cuda):
    """``RAFT(alternate_corr=True)`` on the card: one K5 launch per step and
    no K1, within 2e-3 px of the plain alternate path and of the
    materialized path after one step (64x96, random weights; the bound
    ``chip_smoke.py`` holds K1 to after one step: the correlations differ
    by fp32 rounding, which random weights amplify)."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT

    rng = np.random.RandomState(5)
    im1 = torch.from_numpy((rng.rand(1, 64, 96, 3) * 255).astype(np.float32))
    im2 = torch.roll(im1, (2, 3), dims=(1, 2))
    im1, im2 = im1.to(cuda), im2.to(cuda)
    weights = RAFT(RAFTConfig()).state_dict()
    flows = {}
    for name, kw in (("k5", dict(alternate_corr=True, corr_impl="pallas")),
                     ("alt", dict(alternate_corr=True, corr_impl="gather")),
                     ("k1", dict(corr_impl="pallas"))):
        model = RAFT(RAFTConfig(**kw)).to(cuda).eval()
        model.load_state_dict(weights)
        kernels.reset_launch_counts()
        with torch.no_grad():
            flows[name] = model(im1, im2, iters=1)[1]
        counts = kernels.launch_counts()
        if name == "k5":
            assert counts["corr_alt"] == 1 and counts["corr_lookup"] == 0
    for name in ("alt", "k1"):
        assert float((flows["k5"] - flows[name]).abs().max()) <= 2e-3, name


def test_train_mode_gradients_kernels_match_plain(cuda, monkeypatch):
    """One train step's loss and gradients through ``RAFT`` at iters=1,
    ``pallas``+``fused`` against ``gather``+``xla`` from the same weights
    and batch (cuDNN deterministic, TF32 off): the loss within 1e-5
    relative; each parameter's gradient within 1e-3 of its largest (plus
    1e-6 of the model's largest; a ReLU input within rounding of 0 may
    switch and its norm spreads it over a channel), and their median
    within 1e-5."""
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rng = np.random.RandomState(1)
    im1 = (rng.rand(2, 128, 160, 3) * 255).astype(np.float32)
    batch = {"image1": im1, "image2": np.roll(im1, (3, 5), axis=(1, 2)),
             "flow": (3 * rng.randn(2, 128, 160, 2)).astype(np.float32),
             "valid": np.ones((2, 128, 160), np.float32)}
    tc = TrainConfig(batch_size=2, image_size=(128, 160), iters=1)
    weights = RAFT(RAFTConfig()).state_dict()
    out = {}
    for kw in (dict(corr_impl="pallas", gru_impl="fused"),
               dict(corr_impl="gather", gru_impl="xla")):
        cfg = RAFTConfig(**kw)
        model = RAFT(cfg)
        model.load_state_dict(weights)
        state = create_train_state(model.to(cuda), tc)
        metrics = make_train_step(cfg, tc)(state, batch)
        out[kw["corr_impl"]] = (float(metrics["loss"]),
                                {k: p.grad for k, p in model.named_parameters()})
    (lk, gk), (lp, gp) = out["pallas"], out["gather"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    gmax = max(float(g.abs().max()) for g in gp.values())
    rel = []
    for k in gp:
        scale = float(gp[k].abs().max())
        err = float((gk[k] - gp[k]).abs().max())
        assert err <= 1e-3 * scale + 1e-6 * gmax, (k, err, scale)
        if scale > 1e-4 * gmax:
            rel.append(err / scale)
    assert float(np.median(rel)) <= 1e-5


def test_test_mode_mask_head_once_matches_every_step_loop(cuda):
    """The basic serving geometry (batch 4, 440x1024, iters 20, TF32
    convolutions, K1 and fused K2): test mode, whose mask head runs in the
    last step alone, against the loop that runs it in every step
    (``tests/test_torch_mask_once.py``), both eager: within 1e-5 px, and
    bitwise where cuDNN takes the same algorithms for the same shapes."""
    import types

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from tests.test_torch_mask_once import _every_step_refine

    torch.backends.cudnn.allow_tf32 = True
    try:
        cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
        model = RAFT(cfg, torch.Generator().manual_seed(0)).to(cuda).eval()
        rng = np.random.RandomState(0)
        base = np.floor(rng.rand(4, 440 + 4, 1024 + 6, 3) * 256)
        im1 = torch.from_numpy(base[:, :440, :1024].astype(np.float32))
        im2 = torch.from_numpy(base[:, 4:, 6:].astype(np.float32))
        im1, im2 = im1.to(cuda), im2.to(cuda)
        calls = []
        model.update_block.mask.register_forward_hook(
            lambda *a: calls.append(1))
        with torch.no_grad():
            got = model(im1, im2, iters=20)
            assert len(calls) == 1
            model._refine = types.MethodType(_every_step_refine, model)
            want = model(im1, im2, iters=20)
        assert len(calls) == 1 + 20
        for a, b in zip(got, want):
            print(f"mask once vs every step {tuple(a.shape)}: max "
                  f"{float((a - b).abs().max()):.3g} px, bitwise "
                  f"{torch.equal(a, b)}")
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def test_envelope_measures_the_card(cuda):
    """``cli/envelope`` at small sizes: every rate positive and plausible
    for a card, the device named."""
    from raft_tpu_torch.cli import envelope

    out = envelope.main(["--n", "2048", "--copy-mib", "256", "--reps", "5",
                         "--launches", "200"])
    assert all(v > 1 for v in out["matmul_tflops"].values())
    assert out["copy_gbps"] > 100 and 0 < out["launch_us"] < 1000
    assert out["device"] == torch.cuda.get_device_name(0)


# -- serving: captured graphs, the kernels' operators, the export ----------

def _serving_frames(seed, n, h=60, w=92):
    rng = np.random.RandomState(seed)
    base = np.floor(rng.rand(h + 2 * n, w + 2 * n, 3) * 256).astype(
        np.float32)
    return [base[k:k + h, 2 * k:2 * k + w] for k in range(n)]


def test_graph_replay_is_bitwise_eager(cuda):
    """A bucket's captured graph against the eager forward of the same
    padded bucket inputs on the card (basic model, seeded random weights,
    K1 and K2): bitwise, plain and ragged, and each replay's K1/K2
    launches as its capture recorded them."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import RAFTEngine

    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    model = RAFT(cfg, torch.Generator().manual_seed(0))
    eng = RAFTEngine(model, cfg, iters=3, envelope=[(2, 64, 96)],
                     wire="u8", warm_start=True, ragged=True,
                     capacity_classes=[(2, 64, 96)])
    assert eng.capture_count == 2
    f = _serving_frames(0, 3)
    i1, i2 = np.stack(f[:2]), np.stack(f[1:])
    flow, low = eng.infer_batch(i1, i2, return_low=True)
    pad = ((0, 0), (2, 2), (2, 2), (0, 0))
    with torch.no_grad():
        want_low, want = eng.model(
            *[torch.from_numpy(np.pad(x, pad, mode="edge").astype(np.uint8))
              .to(cuda) for x in (i1, i2)], iters=3)
    np.testing.assert_array_equal(flow, want[:, 2:62, 2:94].cpu().numpy())
    np.testing.assert_array_equal(low, want_low.cpu().numpy())
    assert eng.replayed_launches() == {"corr_lookup": 3, "gru_gates": 6,
                                       "gru_blend": 6}
    # ragged: a full row and a smaller one in the class's one graph
    rows = eng.infer_ragged([(f[0], f[1]), (f[1][:40, :50], f[2][:40, :50])])
    np.testing.assert_array_equal(rows[0], flow[0])
    assert rows[1].shape == (40, 50, 2) and eng.capture_count == 2


def test_two_pending_replays_keep_their_own_flows(cuda):
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import RAFTEngine

    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    eng = RAFTEngine(RAFT(cfg), cfg, iters=2, envelope=[(1, 64, 96)])
    f = _serving_frames(1, 4)
    alone = [eng.infer_batch(f[i][None], f[i + 1][None]) for i in (0, 2)]
    first = eng.infer_batch_async(f[0][None], f[1][None])
    second = eng.infer_batch_async(f[2][None], f[3][None])
    np.testing.assert_array_equal(second.fetch(), alone[1])
    np.testing.assert_array_equal(first.fetch(), alone[0])
    assert not np.array_equal(alone[0], alone[1])


def test_operators_match_the_autograd_path(cuda):
    """The ``torch.library`` operators a traced program holds launch the
    same kernels as the wrappers' ``autograd.Function``s: bitwise."""
    from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda

    rng = np.random.RandomState(2)
    pyr = _pyramid(rng, 1, 12, 20, 3, torch.float32, cuda)
    coords = _coords(rng, 1, 12, 20, 4.0, cuda)
    ops = torch.ops.raft_tpu_torch
    assert torch.equal(ops.corr_lookup(coords, pyr, 4),
                       corr_lookup_cuda(pyr, coords, 4))
    zr = torch.randn(2, 256, 12, 20, device=cuda)
    h = torch.randn(2, 128, 12, 20, device=cuda)
    for a, b in zip(ops.gru_gates(zr[:, :128], zr[:, 128:], h),
                    gru_gates(zr[:, :128], zr[:, 128:], h)):
        assert torch.equal(a, b)
    assert torch.equal(ops.gru_blend(zr[:, :128], h, zr[:, 128:]),
                       gru_blend(zr[:, :128], h, zr[:, 128:]))
    f1 = torch.randn(1, 12, 20, 64, device=cuda)
    f2 = [torch.randn(1, 12, 20, 64, device=cuda),
          torch.randn(1, 6, 10, 64, device=cuda)]
    assert torch.equal(ops.alt_corr_lookup(f1, f2, coords, 3),
                       alt_corr_lookup_cuda(f1, f2, coords, 3))


def test_exported_program_launches_the_kernels(cuda, tmp_path):
    """``torch.export`` of the basic model on the card holds the K1 and K2
    operators; the saved and reloaded program launches the kernels and
    equals the eager forward at batch 1 and 2 within 1e-5 px."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving.export import (export_program, load_program,
                                               make_serving_fn)

    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    model = RAFT(cfg).to(cuda).eval()
    path = str(tmp_path / "basic.pt2")
    torch.export.save(export_program(model, cfg, iters=2, image_hw=(64, 96)), path)
    program = load_program(path)
    for b in (1, 2):
        f = _serving_frames(3 + b, b + 1, 64, 96)
        i1 = torch.from_numpy(np.stack(f[:b])).to(cuda)
        i2 = torch.from_numpy(np.stack(f[1:])).to(cuda)
        kernels.reset_launch_counts()
        got = program(i1, i2)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["corr_lookup"] == 2
        assert kernels.launch_counts()["gru_gates"] == 4
        with torch.no_grad():
            want = make_serving_fn(model, cfg, 2)(i1, i2)
        assert float((got - want).abs().max()) <= 1e-5


def test_scheduler_dispatches_replay_the_bucket_graphs(cuda):
    """The serving front end over a CUDA engine: every micro-batch the
    scheduler forms is one replay of the bucket's graph (its K1/K2
    launches as captured, no new capture), at pipeline depth 1 and 2, and
    each future's flow is the engine's direct ``infer_batch`` of the same
    pair in the same bucket, alone in it (within 2e-3 px, the bound of one
    basic-model step at random init, ``chip_smoke.BASIC_STEP_TOL``: the
    other row of the batch is another pair instead of zeros)."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import MicroBatchScheduler, RAFTEngine

    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    eng = RAFTEngine(RAFT(cfg, torch.Generator().manual_seed(0)), cfg,
                     iters=2, envelope=[(2, 64, 96)], wire="u8",
                     warm_start=True)
    f = _serving_frames(2, 5)
    direct = [eng.infer_batch(f[i][None], f[i + 1][None]) for i in range(4)]
    for depth in (1, 2):
        before = eng.replayed_launches()
        with MicroBatchScheduler(eng, max_batch=2, gather_window_s=0.0,
                                 pipeline_depth=depth) as sched:
            futs = [sched.submit(f[i], f[i + 1]) for i in range(4)]
            got = [fut.result(timeout=120).flow for fut in futs]
        n = sched.metrics.snapshot()["dispatches"]
        after = eng.replayed_launches()
        assert {k: after[k] - before.get(k, 0) for k in after} == {
            "corr_lookup": 2 * n, "gru_gates": 4 * n, "gru_blend": 4 * n}
        for g, d in zip(got, direct):
            assert np.abs(g - d[0]).max() <= 2e-3
    assert eng.capture_count == 1


def test_device_flow_init_is_bitwise_host_flow_init(cuda):
    """The scheduler's device-resident warm start (a CUDA ``flow_init``,
    assembled on the card with row copies) gives bitwise the flow of the
    same values shipped from the host."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.ops.interp import forward_interpolate_device
    from raft_tpu_torch.serving import MicroBatchScheduler, RAFTEngine

    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    eng = RAFTEngine(RAFT(cfg, torch.Generator().manual_seed(0)), cfg,
                     iters=2, envelope=[(2, 64, 96)], warm_start=True)
    f = _serving_frames(3, 3)
    with MicroBatchScheduler(eng, max_batch=2, gather_window_s=0.0) as sched:
        low = sched.submit(f[0], f[1], want_low=True,
                           low_device=True).result(timeout=120).flow_low
        assert low.is_cuda
        init = forward_interpolate_device(low)
        dev = sched.submit(f[1], f[2], flow_init=init).result(timeout=120)
        host = sched.submit(f[1], f[2], flow_init=init.cpu().numpy()
                            ).result(timeout=120)
    np.testing.assert_array_equal(dev.flow, host.flow)
    np.testing.assert_array_equal(forward_interpolate_device(low).cpu(),
                                  init.cpu())


def test_two_replicas_replay_concurrently_each_its_own(cuda):
    """A replica (``RAFTEngine.spawn_replica``: its own weights, stream,
    pool and capture) given other weights, and its primary, replaying at
    once from two threads on their two streams: each output within 1e-5
    px (``chip_smoke.SERVE_TOL``) of its own engine's eager forward of the
    same padded inputs — neither lane reads the other's weights or
    buffers."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import RAFTEngine

    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    primary = RAFTEngine(RAFT(cfg, torch.Generator().manual_seed(0)), cfg,
                         iters=3, envelope=[(2, 64, 96)], wire="u8")
    replica = primary.spawn_replica()
    assert replica.capture_count == 1
    assert replica._stream != primary._stream
    replica.update_weights(RAFT(cfg, torch.Generator().manual_seed(1)))
    torch.cuda.synchronize()      # the copy ran on the replica's stream
    engines = (primary, replica)
    frames = [_serving_frames(10 + k, 3) for k in range(2)]
    inputs = [(np.stack(f[:2]), np.stack(f[1:])) for f in frames]
    pad = ((0, 0), (2, 2), (2, 2), (0, 0))
    want = {}
    with torch.no_grad():
        for e, eng in enumerate(engines):
            for k, (i1, i2) in enumerate(inputs):
                up = eng.model(*[torch.from_numpy(
                    np.pad(x, pad, mode="edge").astype(np.uint8)).to(cuda)
                    for x in (i1, i2)], iters=3)[1]
                want[e, k] = up[:, 2:62, 2:94].cpu().numpy()
    assert float(np.abs(want[0, 0] - want[1, 0]).max()) > 1e-2
    got = {}
    barrier = threading.Barrier(2)

    def lane(e):
        barrier.wait(60)
        for rep in range(4):
            pend = [engines[e].infer_batch_async(*x) for x in inputs]
            for k, p in enumerate(pend):
                got[e, k, rep] = p.fetch()

    threads = [threading.Thread(target=lane, args=(e,)) for e in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert len(got) == 16
    for (e, k, _), flow in got.items():
        assert float(np.abs(flow - want[e, k]).max()) <= 1e-5
    assert replica.capture_count == 1 and primary.capture_count == 1


def test_loaded_program_replay_matches_the_live_module(cuda, tmp_path):
    """The program store on the card: an engine warm from the store (its
    bucket program loaded, traced nothing) replays within 1e-5 px of an
    engine that captured the live module, on the same inputs, and its
    capture recorded the same K1/K2 launches."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import RAFTEngine

    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    model = RAFT(cfg, torch.Generator().manual_seed(0))
    kw = dict(iters=3, envelope=[(2, 64, 96)], wire="u8", warm_start=True)
    live = RAFTEngine(model, cfg, **kw)
    cold = RAFTEngine(model, cfg, aot_cache=str(tmp_path), **kw)
    warm = RAFTEngine(model, cfg, aot_cache=str(tmp_path), **kw)
    assert cold.aot_stats()["compiles"] == 1
    assert warm.aot_stats()["aot_hits"] == 1
    assert warm.aot_stats()["compiles"] == 0
    f = _serving_frames(5, 3)
    i1, i2 = np.stack(f[:2]), np.stack(f[1:])
    want = live.infer_batch(i1, i2)
    for eng in (cold, warm):
        assert float(np.abs(eng.infer_batch(i1, i2) - want).max()) <= 1e-5
        assert eng._programs[(2, 64, 96)].launches == {
            "corr_lookup": 3, "gru_gates": 6, "gru_blend": 6}


def test_weight_swap_reaches_a_loaded_program(cuda, tmp_path):
    """A loaded program's parameters are the engine's live tensors: a
    swap after a warm start serves the new weights (the engine captured
    the loaded program, not a copy of the weights the .pt2 carries)."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import RAFTEngine

    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    v1 = RAFT(cfg, torch.Generator().manual_seed(0)).state_dict()
    v2 = RAFT(cfg, torch.Generator().manual_seed(1)).state_dict()
    kw = dict(iters=3, envelope=[(2, 64, 96)], wire="u8", warm_start=True)
    RAFTEngine(v1, cfg, aot_cache=str(tmp_path), **kw)
    warm = RAFTEngine(v1, cfg, aot_cache=str(tmp_path), **kw)
    assert warm.aot_stats()["aot_hits"] == 1
    f = _serving_frames(6, 3)
    i1, i2 = np.stack(f[:2]), np.stack(f[1:])
    before = warm.infer_batch(i1, i2)
    warm.update_weights(v2)
    want = RAFTEngine(v2, cfg, **kw).infer_batch(i1, i2)
    got = warm.infer_batch(i1, i2)
    assert float(np.abs(got - want).max()) <= 1e-5
    assert float(np.abs(got - before).max()) > 1e-3
    assert warm.capture_count == 1


@pytest.mark.parametrize("cell", [
    "live", "store", "live_profiled", "store_profiled", "store_cached",
    "store_cached_profiled"])
def test_graph_churn_cell(cuda, cell):
    """Serving graphs freed while another engine replays (the cells of
    ``profile_graph_churn.CELLS``): engine A replays its bucket on a
    thread, bitwise its first flow each time, while engine B's bucket is
    dropped with a replay in flight, rebuilt, and B is dropped whole and
    built again, 50 times; with and without ``torch.profiler``, B's
    program captured live or loaded from the store, and once through an
    in-process cache of deserialized programs. Each cell runs in a process
    of its own with ``faulthandler`` on, so a crash fails this cell with
    every thread's stack."""
    import os.path as osp
    import subprocess
    import sys

    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, osp.join(repo, "profile_graph_churn.py"), "--cell",
         cell, "--rounds", "50"], cwd=repo, capture_output=True, text=True,
        timeout=900)
    if r.returncode != 0:   # every thread's stack, unabridged
        pytest.fail(f"cell {cell}: exit {r.returncode}\n{r.stdout[-3000:]}"
                    f"\n{r.stderr[-8000:]}", pytrace=False)
