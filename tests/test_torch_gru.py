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
    NCHW conv output (batch stride 2·C·H·W) pass; a transposed operand, a
    dtype or shape mismatch raise."""
    zr = torch.randn(2, 16, 3, 5)
    zl, rl = zr[:, :8], zr[:, 8:]
    h = torch.randn(2, 8, 3, 5)
    batch, inner, strides, code = gru._operands("gru_gates", zl, rl, h)
    assert (batch, inner, strides, code) == (2, 120, [240, 240, 120], 0)
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
