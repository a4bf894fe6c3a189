"""The plain GRU gate and blend tails against the JAX package's Pallas
kernels (interpret mode), within 1e-6, and what the wrappers do on the CPU.
"""

import numpy as np
import pytest
import torch

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
