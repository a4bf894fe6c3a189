"""The plain GRU gate and blend tails against the JAX package's Pallas
kernels (interpret mode), within 1e-6, and what the wrappers do on the CPU.
The backward of ``GruGates`` and ``GruBlend`` (on the CPU, the plain
formulas of ``_gates_bwd_kernel`` and ``_blend_bwd_kernel``) is held
within 1e-6 of the VJPs of ``gru_pallas.gru_gates`` and ``gru_blend``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.kernels import gru_pallas
from raft_tpu_torch import kernels
from raft_tpu_torch.kernels import gru


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


def _data(shape, n, seed=0):
    rng = np.random.RandomState(seed)
    return [(3 * rng.randn(*shape)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("shape", [(2, 37, 16), (1, 600, 128)])
def test_gates_and_blend_match_jax(shape):
    zl, rl, h, ql = _data(shape, 4)
    jz, jrh = gru_pallas.gru_gates(jnp.asarray(zl), jnp.asarray(rl),
                                   jnp.asarray(h))
    z, rh = gru.gru_gates_plain(*(torch.from_numpy(a) for a in (zl, rl, h)))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rh.numpy(), np.asarray(jrh), atol=1e-6, rtol=0)
    jout = gru_pallas.gru_blend(jz, jnp.asarray(h), jnp.asarray(ql))
    out = gru.gru_blend_plain(z, torch.from_numpy(h), torch.from_numpy(ql))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=0)


def test_cpu_wrappers_run_the_plain_versions():
    zl, rl, h, ql = (torch.from_numpy(a) for a in _data((2, 3, 5, 7), 4, 1))
    before = kernels.launch_counts()
    z, rh = gru.gru_gates(zl, rl, h)
    out = gru.gru_blend(z, h, ql)
    assert kernels.launch_counts() == before
    want_z, want_rh = gru.gru_gates_plain(zl, rl, h)
    for got, want in ((z, want_z), (rh, want_rh),
                      (out, gru.gru_blend_plain(z, h, ql))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bf16_plain_rounds_once_from_fp32():
    zl, rl, h, ql = (torch.from_numpy(a).bfloat16()
                     for a in _data((1, 64, 32), 4, 2))
    z, rh = gru.gru_gates_plain(zl, rl, h)
    out = gru.gru_blend_plain(z, h, ql)
    assert z.dtype == rh.dtype == out.dtype == torch.bfloat16
    f = [t.float() for t in (zl, rl, h, ql, z)]
    torch.testing.assert_close(z, torch.sigmoid(f[0]).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(rh, (torch.sigmoid(f[1]) * f[2]).bfloat16(),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        out, ((1 - f[4]) * f[2] + f[4] * torch.tanh(f[3])).bfloat16(),
        rtol=0, atol=0)


def test_operand_checks_take_batch_views_and_refuse_copies():
    """What the kernels read in place: the z/r halves of a double-width
    NCHW conv output (batch stride 2·C·H·W, each batch element one row)
    pass; a transposed operand, a dtype or shape mismatch raise."""
    zr = torch.randn(2, 16, 3, 5)
    zl, rl = zr[:, :8], zr[:, 8:]
    h = torch.randn(2, 8, 3, 5)
    route, batch, outer, inner, strides, code = gru._operands(
        "gru_gates", zl, rl, h)
    assert (route, batch, outer, inner, code) == ("contiguous", 2, 1, 120, 0)
    assert strides == [(240, 120), (240, 120), (120, 120)]
    with pytest.raises(ValueError, match="contiguous"):
        gru._operands("gru_gates", zl, rl, h.transpose(2, 3).contiguous()
                      .transpose(2, 3))
    with pytest.raises(ValueError, match="dtype"):
        gru._operands("gru_blend", h.double(), h.double(), h.double())
    with pytest.raises(ValueError, match="shapes"):
        gru._operands("gru_blend", h, h, h[:, :4])
    with pytest.raises(ValueError, match="device and dtype"):
        gru._operands("gru_blend", h, h.bfloat16(), h)


@pytest.mark.parametrize("shape", [(2, 37, 16), (1, 600, 128)])
def test_gates_and_blend_vjps_match_jax(shape):
    """Pre-activations of spread 3, the state and cotangents of spread 1,
    so every gradient is O(1), where 1e-6 is a few fp32 ulps."""
    zl, rl, ql, *rest = _data(shape, 7, 3)
    h, dz, drh, g = (a / 3 for a in rest)
    jin = [jnp.asarray(a) for a in (zl, rl, h)]
    _, vjp = jax.vjp(gru_pallas.gru_gates, *jin)
    want_gates = vjp((jnp.asarray(dz), jnp.asarray(drh)))
    zb = np.asarray(jax.nn.sigmoid(jin[0]))
    _, vjp = jax.vjp(gru_pallas.gru_blend, jnp.asarray(zb), jin[2],
                     jnp.asarray(ql))
    want_blend = vjp(jnp.asarray(g))

    t = [torch.from_numpy(a).requires_grad_() for a in (zl, rl, h)]
    before = kernels.launch_counts()
    z, rh = gru.gru_gates(*t)
    torch.autograd.backward([z, rh], [torch.from_numpy(dz),
                                      torch.from_numpy(drh)])
    tb = [torch.from_numpy(a).requires_grad_() for a in (zb, h, ql)]
    gru.gru_blend(*tb).backward(torch.from_numpy(g))
    assert kernels.launch_counts() == before
    for got, want in ((t, want_gates), (tb, want_blend)):
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                       atol=1e-6, rtol=0)


def test_backward_of_view_operands_assembles_the_parent_gradient():
    """zl and rl are channel halves of one double-width conv output: each
    half gets its own gradient and autograd assembles the parent's, with
    nothing written through a view."""
    zr = torch.randn(2, 16, 3, 5, requires_grad=True)
    h = torch.randn(2, 8, 3, 5)
    dz, drh = torch.randn(2, 8, 3, 5), torch.randn(2, 8, 3, 5)
    z, rh = gru.gru_gates(zr[:, :8], zr[:, 8:], h)
    torch.autograd.backward([z, rh], [dz, drh])
    dzl, drl, _ = gru.gru_gates_bwd_plain(zr[:, :8].detach(),
                                          zr[:, 8:].detach(), h, dz, drh)
    torch.testing.assert_close(zr.grad, torch.cat([dzl, drl], 1), rtol=0,
                               atol=0)
    for fn, plain, n in ((gru.gru_gates_bwd, gru.gru_gates_bwd_plain, 5),
                         (gru.gru_blend_bwd, gru.gru_blend_bwd_plain, 4)):
        args = [torch.randn(2, 8, 3, 5) for _ in range(n)]
        for a, b in zip(fn(*args), plain(*args)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _halves(layout, B=2, C=8, H=3, W=5, dtype=torch.float32):
    """The z/r halves of a double-width gate conv output and a state, all
    in ``layout``."""
    fmt = gru.FORMATS[layout]
    zr = torch.randn(B, 2 * C, H, W, dtype=dtype).contiguous(memory_format=fmt)
    h = torch.randn(B, C, H, W, dtype=dtype).contiguous(memory_format=fmt)
    zl, rl = zr.split(C, 1)
    return zl, rl, h


def test_operands_take_nhwc_and_nchw_halves_in_place():
    """Channels-last halves: rows of C channels a pixel apart (row stride
    2C; the state's C); NCHW halves: each batch element one row."""
    zl, rl, h = _halves("channels_last")
    route, batch, outer, inner, strides, code = gru._operands(
        "gru_gates", zl, rl, h)
    assert (route, batch, outer, inner, code) == ("channels_last", 2, 15, 8,
                                                  0)
    assert strides == [(240, 16), (240, 16), (120, 8)]
    # a channel slice of a concatenation's gradient, beside dense operands
    cat = torch.randn(2, 24, 3, 5).contiguous(
        memory_format=torch.channels_last)
    got = gru._operands("gru_blend", h, h, cat[:, 8:16])
    assert got[:4] == ("channels_last", 2, 15, 8)
    assert got[4] == [(120, 8), (120, 8), (360, 24)]
    # all dense: one row a batch element
    assert gru._operands("gru_blend", h, h, h)[:5] == (
        "channels_last", 2, 1, 120, [(120, 120)] * 3)
    zl, rl, h = _halves("contiguous", dtype=torch.bfloat16)
    assert gru._operands("gru_gates", zl, rl, h) == (
        "contiguous", 2, 1, 120, [(240, 120), (240, 120), (120, 120)], 1)


@pytest.mark.parametrize("case", ["transposed_pixels", "mixed_layouts",
                                  "channel_stride", "uneven_pixels"])
def test_operands_refuse_other_layouts(case):
    zl, rl, h = _halves("channels_last")
    if case == "transposed_pixels":      # W outer, H inner
        zl = zl.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "mixed_layouts":        # an NCHW state with NHWC halves
        h = h.contiguous()
    elif case == "channel_stride":       # every other channel
        zl = torch.randn(2, 16, 3, 5).contiguous(
            memory_format=torch.channels_last)[:, ::2]
    else:                                # a column cut off each row
        zl = torch.randn(2, 8, 3, 6).contiguous(
            memory_format=torch.channels_last)[..., :5]
    with pytest.raises(ValueError, match="each batch slice must be "
                                         "contiguous"):
        gru._operands("gru_gates", zl, rl, h)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_outputs_and_cotangents_keep_the_operands_layout(layout):
    fmt = gru.FORMATS[layout]
    zl, rl, h = _halves(layout)
    out = gru._empty(h, layout)
    assert out.shape == h.shape and out.is_contiguous(memory_format=fmt)
    # the plain route's outputs come out in the same layout
    z, rh = gru.gru_gates(zl, rl, h)
    new_h = gru.gru_blend(z, h, rh)
    for t in (z, rh, new_h, *gru.gru_gates_bwd(zl, rl, h, z, rh),
              *gru.gru_blend_bwd(z, h, rh, new_h)):
        assert t.stride() == out.stride()
    # a cotangent that fits the route is passed as it is, zeros take the
    # saved operand's layout, any other layout is copied into the route's
    assert gru._cotangent(z, h, layout) is z
    assert gru._cotangent(None, h, layout).stride() == out.stride()
    other = "contiguous" if layout == "channels_last" else "channels_last"
    g = torch.randn(h.shape).contiguous(memory_format=gru.FORMATS[other])
    got = gru._cotangent(g, h, layout)
    assert got.is_contiguous(memory_format=fmt)
    torch.testing.assert_close(got, g, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("op", ["gru_gates", "gru_blend"])
def test_fake_outputs_have_the_cpu_routes_strides(op, layout):
    """What ``torch.export`` traces: the operators' fake implementations
    give each output the strides the real route gives it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    zl, rl, h = _halves(layout)
    args = (zl, rl, h) if op == "gru_gates" else (torch.sigmoid(zl), h, rl)
    fn = getattr(torch.ops.raft_tpu_torch, op)
    real = fn(*args)
    with FakeTensorMode() as mode:
        fake = fn(*(mode.from_tensor(t) for t in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [t.stride() for t in fake] == [t.stride() for t in real]
    assert all(t.is_contiguous(memory_format=gru.FORMATS[layout])
               for t in real)


def test_launch_layouts_keys_exist_and_reset_with_the_counts():
    from raft_tpu_torch.kernels import _build

    assert set(kernels.launch_layouts()) == set(gru.launches)
    _build.count_launch(gru.launches, "gru_gates", torch.float32,
                        "channels_last")
    _build.count_launch(gru.launches, "gru_blend_bwd", torch.bfloat16,
                        "contiguous")
    got = kernels.launch_layouts()
    assert got["gru_gates"]["channels_last"] >= 1
    assert got["gru_blend_bwd"]["contiguous"] >= 1
    assert all(set(v) == {"channels_last", "contiguous"}
               for v in got.values())
    kernels.reset_launch_counts()
    assert kernels.launch_layouts() == {
        name: {"channels_last": 0, "contiguous": 0} for name in gru.launches}
    assert not any(kernels.launch_counts().values())
    assert kernels.launch_dtypes() == {}
