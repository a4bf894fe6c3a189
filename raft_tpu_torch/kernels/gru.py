"""Kernels 2 and 3: the SepConvGRU gate and blend tails, CUDA C++ for Hopper.

Replace ``raft_tpu/kernels/gru_pallas.py::_gates_kernel`` and
``::_blend_kernel`` (through ``gru_gates`` and ``gru_blend``). The kernels
are ``csrc/gru.cu``, built into the same library as the lookup; its note
says what bounds them. They are written in CUDA C++ rather than Triton so
the port has one build and one binding for all its kernels.

- :func:`gru_gates`: ``(zl, rl, h) -> (σ(zl), σ(rl)·h)``
- :func:`gru_blend`: ``(z, h, ql) -> (1−z)·h + z·tanh(ql)``

Both take fp32 or bf16 operands of one shape, compute in fp32 and store in
the operands' dtype; :func:`gru_gates_plain` and :func:`gru_blend_plain` are
their plain versions, with the same rounding points. Each wrapper takes the
plain version only for CPU tensors; for CUDA tensors it launches its kernel
or raises. An operand may be any strided view whose per-batch slices
``t[b]`` are contiguous (the z and r halves of the double-width gate conv's
NCHW output are such views when B > 1); the kernel reads it in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.kernels._build import check, dtype_code, library, stream

#: kernel launches since the counts were last set to 0
gates_launches = 0
blend_launches = 0


def gru_gates_plain(zl, rl, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`gru_gates`: fp32 math, one rounding to the
    operands' dtype per output."""
    z = torch.sigmoid(zl.float())
    rh = torch.sigmoid(rl.float()) * h.float()
    return z.to(zl.dtype), rh.to(zl.dtype)


def gru_blend_plain(z, h, ql) -> torch.Tensor:
    """The plain version of :func:`gru_blend`."""
    zf = z.float()
    out = (1.0 - zf) * h.float() + zf * torch.tanh(ql.float())
    return out.to(z.dtype)


def _operands(name, *ts):
    """Check the operands the kernel reads; return (batch, inner, batch
    strides, dtype code)."""
    t0 = ts[0]
    for t in ts:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: operands must share device and dtype")
        if t.shape != t0.shape:
            raise ValueError(f"{name}: operand shapes differ: "
                             f"{[tuple(x.shape) for x in ts]}")
    code = dtype_code(t0.dtype)
    if t0.dim() < 2 or t0.shape[0] > 65535:
        raise ValueError(f"{name}: operands must be (B, ...) with B <= 65535, "
                         f"got {tuple(t0.shape)}")
    inner = 1
    for size in t0.shape[1:]:
        inner *= size
    for t in ts:
        expected = 1     # each batch slice t[b] must be contiguous
        for size, step in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
            if size != 1 and step != expected:
                raise ValueError(
                    f"{name}: each batch slice must be contiguous (strides "
                    f"{t.stride()}); the kernel reads operands in place and "
                    "does not copy")
            expected *= size
    return t0.shape[0], inner, [t.stride(0) for t in ts], code


def gru_gates(zl, rl, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused update/reset-gate tail: ``(σ(zl), σ(rl)·h)``; ``z`` feeds
    :func:`gru_blend`, ``r·h`` the candidate conv."""
    global gates_launches
    if zl.device.type == "cpu":
        return gru_gates_plain(zl, rl, h)
    if zl.device.type != "cuda":
        raise ValueError(f"gru_gates: no kernel for {zl.device}")
    batch, inner, (zl_bs, rl_bs, h_bs), code = _operands("gru_gates",
                                                         zl, rl, h)
    z = torch.empty(zl.shape, dtype=zl.dtype, device=zl.device)
    rh = torch.empty_like(z)
    if z.numel() == 0:
        return z, rh
    err = library().lib.gru_gates_launch(
        zl.data_ptr(), rl.data_ptr(), h.data_ptr(), z.data_ptr(),
        rh.data_ptr(), inner, batch, zl_bs, rl_bs, h_bs, code, stream(zl))
    check(err, "gru_gates")
    gates_launches += 1
    return z, rh


def gru_blend(z, h, ql) -> torch.Tensor:
    """Fused candidate/blend tail: ``(1−z)·h + z·tanh(ql)``; ``ql`` is the
    candidate conv's pre-tanh output, so q never lands in memory."""
    global blend_launches
    if z.device.type == "cpu":
        return gru_blend_plain(z, h, ql)
    if z.device.type != "cuda":
        raise ValueError(f"gru_blend: no kernel for {z.device}")
    batch, inner, (z_bs, h_bs, ql_bs), code = _operands("gru_blend",
                                                        z, h, ql)
    out = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    if out.numel() == 0:
        return out
    err = library().lib.gru_blend_launch(
        z.data_ptr(), h.data_ptr(), ql.data_ptr(), out.data_ptr(), inner,
        batch, z_bs, h_bs, ql_bs, code, stream(z))
    check(err, "gru_blend")
    blend_launches += 1
    return out
