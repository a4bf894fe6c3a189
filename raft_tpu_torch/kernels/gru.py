"""Kernels 2 and 4: the SepConvGRU gate and blend tails and their backward,
CUDA C++ for Hopper.

Replace ``raft_tpu/kernels/gru_pallas.py::_gates_kernel``, ``::_blend_kernel``,
``::_gates_bwd_kernel`` and ``::_blend_bwd_kernel`` (through ``gru_gates``
and ``gru_blend`` and their custom VJPs). The kernels are ``csrc/gru.cu``,
built into the same library as the lookup; its notes say what bounds them.
They are written in CUDA C++ rather than Triton so the port has one build
and one binding for all its kernels.

- :func:`gru_gates`: ``(zl, rl, h) -> (σ(zl), σ(rl)·h)``
- :func:`gru_blend`: ``(z, h, ql) -> (1−z)·h + z·tanh(ql)``
- :func:`gru_gates_bwd`: ``(zl, rl, h, dz, drh) -> (dzl, drl, dh)``
- :func:`gru_blend_bwd`: ``(z, h, ql, g) -> (dz, dh, dql)``

:func:`gru_gates` and :func:`gru_blend` are differentiable through
:class:`GruGates` and :class:`GruBlend`, whose backward runs the backward
kernels; as in JAX, the backward recomputes σ and tanh from the saved
inputs. All take fp32 or bf16 operands of one shape, compute in fp32 and
store in the operands' dtype; the ``*_plain`` functions are their plain
versions, with the same rounding points. Each wrapper takes the plain
version only for CPU tensors; for CUDA tensors it launches its kernel or
raises. The kernels read their inputs in place, in one of two layouts
(:func:`layout`), all operands of a launch in the same one:

- ``"channels_last"``: (B, C, H, W) views whose C channels are contiguous
  at each pixel and whose pixels are evenly spaced, such as the z and r
  halves of the double-width gate conv's channels-last output (pixel
  stride 2C) or a channel slice of a concatenation's gradient;
- ``"contiguous"``: views whose per-batch slices ``t[b]`` are contiguous,
  such as the halves of an NCHW conv output.

Any other layout raises; nothing is copied. Outputs take the operands'
layout, dense: channels-last or contiguous. Traced by ``torch.export`` (or
``torch.compile``), :func:`gru_gates` and :func:`gru_blend` call the
operators ``torch.ops.raft_tpu_torch.gru_gates`` and ``.gru_blend``
instead, the forwards alone, with the same two routes; their fake
implementations give the outputs the strides the real ones have.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from torch.autograd.function import once_differentiable

from raft_tpu_torch.kernels._build import (check, count_launch,
                                           dtype_code, library, stream,
                                           tracing)

#: kernel launches since the counts were last set to 0
launches = {"gru_gates": 0, "gru_blend": 0, "gru_gates_bwd": 0,
            "gru_blend_bwd": 0}


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


def gru_gates_bwd_plain(zl, rl, h, dz, drh):
    """The plain version of :func:`gru_gates_bwd` (``_gates_bwd_kernel``'s
    formulas): ``dzl = dz·z(1−z)``, ``drl = drh·h·r(1−r)``, ``dh = drh·r``
    with z and r recomputed from the inputs."""
    z = torch.sigmoid(zl.float())
    r = torch.sigmoid(rl.float())
    g = drh.float()
    dzl = dz.float() * z * (1.0 - z)
    drl = g * h.float() * r * (1.0 - r)
    return (dzl.to(zl.dtype), drl.to(zl.dtype), (g * r).to(zl.dtype))


def gru_blend_bwd_plain(z, h, ql, g):
    """The plain version of :func:`gru_blend_bwd` (``_blend_bwd_kernel``'s
    formulas): ``dz = g·(tanh ql − h)``, ``dh = g·(1−z)``,
    ``dql = g·z·(1 − tanh² ql)``."""
    zf, gf = z.float(), g.float()
    t = torch.tanh(ql.float())
    return ((gf * (t - h.float())).to(z.dtype), (gf * (1.0 - zf)).to(z.dtype),
            (gf * zf * (1.0 - t * t)).to(z.dtype))


def _rows(t, route):
    """``t`` as ``route`` reads it: ``(batch stride, row stride, rows,
    row length)``, or None when ``t`` does not fit that route."""
    shape, stride = t.shape, t.stride()
    if route == "channels_last":
        if t.dim() != 4:
            return None
        _, C, H, W = shape
        if C != 1 and stride[1] != 1:
            return None
        # the pixels (h, w) evenly spaced: one row stride for both
        step = stride[3] if W != 1 else stride[2]
        if H != 1 and W != 1 and stride[2] != W * step:
            return None
        return stride[0], step, H * W, C
    inner = 1
    for size, step in zip(reversed(shape[1:]), reversed(stride[1:])):
        if size != 1 and step != inner:
            return None
        inner *= size
    return stride[0], inner, 1, inner


#: the two layouts, in the order a tie is settled (a tensor with one
#: channel, or one pixel, fits both, and is dense either way)
ROUTES = ("contiguous", "channels_last")
FORMATS = {"contiguous": torch.contiguous_format,
           "channels_last": torch.channels_last}


def layout(*ts):
    """The layout every one of ``ts`` can be read in (:data:`ROUTES`), or
    None."""
    for route in ROUTES:
        if all(_rows(t, route) is not None for t in ts):
            return route
    return None


def _operands(name, *ts):
    """Check the operands the kernel reads; return (layout, batch, rows,
    row length, each operand's (batch stride, row stride), dtype code).
    A batch element whose rows are back to back is one row."""
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
    route = layout(*ts)
    if route is None:
        raise ValueError(
            f"{name}: each batch slice must be contiguous, or channels-last "
            f"with evenly spaced pixels (strides {[t.stride() for t in ts]}); "
            "the kernel reads operands in place and does not copy")
    views = [_rows(t, route) for t in ts]
    _, _, outer, inner = views[0]
    strides = [(bs, os) for bs, os, _, _ in views]
    if all(os == inner for _, os in strides):
        outer, inner = 1, outer * inner
        strides = [(bs, inner) for bs, _ in strides]
    return route, t0.shape[0], outer, inner, strides, code


def _empty(like, route):
    """A dense output shaped and typed like ``like``, in ``route``'s
    layout."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device,
                       memory_format=FORMATS[route])


def _launch(name, plain, n_out, *ts):
    """Kernel ``name`` on the operands ``ts``: ``plain(*ts)`` for CPU
    tensors; for CUDA tensors the kernel, into ``n_out`` dense outputs
    shaped, typed and laid out like the operands. Every ``<name>_launch``
    in ``csrc/gru.cu`` takes (operands, outputs, each operand's (batch
    stride, row stride), rows, row length, batch, dtype code, stream)."""
    t0 = ts[0]
    if t0.device.type == "cpu":
        return plain(*ts)
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t0.device}")
    route, batch, outer, inner, strides, code = _operands(name, *ts)
    outs = tuple(_empty(t0, route) for _ in range(n_out))
    if t0.numel():
        flat = [s for pair in strides for s in pair]
        err = getattr(library().lib, f"{name}_launch")(
            *(t.data_ptr() for t in ts), *(o.data_ptr() for o in outs),
            (ctypes.c_longlong * len(flat))(*flat), outer, inner, batch,
            code, stream(t0))
        check(err, name)
        count_launch(launches, name, t0.dtype, route)
    return outs[0] if n_out == 1 else outs


def gru_gates_bwd(zl, rl, h, dz, drh) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`gru_gates`: the cotangents ``dz``, ``drh`` of its
    outputs -> ``(dzl, drl, dh)``, recomputing z and r from the inputs."""
    return _launch("gru_gates_bwd", gru_gates_bwd_plain, 3,
                   zl, rl, h, dz, drh)


def gru_blend_bwd(z, h, ql, g) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`gru_blend`: the cotangent ``g`` of its output ->
    ``(dz, dh, dql)``, recomputing tanh(ql) from the input."""
    return _launch("gru_blend_bwd", gru_blend_bwd_plain, 3, z, h, ql, g)


def _cotangent(g, like, route):
    """An output's cotangent as the backward kernels take it: zeros in
    ``like``'s layout when the output was unused; otherwise ``g`` itself
    when it fits ``route``, the layout of the saved operands (None on
    the CPU, where the plain version takes any), else a dense copy in
    that layout."""
    if g is None:
        return torch.zeros_like(like)
    if route is None or _rows(g, route) is not None:
        return g
    return g.contiguous(memory_format=FORMATS[route])


class GruGates(torch.autograd.Function):
    """K2 gates forward, K4 gates backward; plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, zl, rl, h):
        ctx.save_for_backward(zl, rl, h)
        return _launch("gru_gates", gru_gates_plain, 2, zl, rl, h)

    @staticmethod
    @once_differentiable
    def backward(ctx, dz, drh):
        zl, rl, h = ctx.saved_tensors
        route = layout(zl, rl, h) if h.is_cuda else None
        # each half gets its own gradient; autograd assembles the gradient
        # of the double-width conv output that zl and rl are views of
        return gru_gates_bwd(zl, rl, h, _cotangent(dz, h, route),
                             _cotangent(drh, h, route))


class GruBlend(torch.autograd.Function):
    """K2 blend forward, K4 blend backward; plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, z, h, ql):
        ctx.save_for_backward(z, h, ql)
        return _launch("gru_blend", gru_blend_plain, 1, z, h, ql)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        z, h, ql = ctx.saved_tensors
        route = layout(z, h, ql) if h.is_cuda else None
        return gru_blend_bwd(z, h, ql, _cotangent(g, h, route))


@torch.library.custom_op(
    "raft_tpu_torch::gru_gates", mutates_args=(),
    schema="(Tensor zl, Tensor rl, Tensor h) -> (Tensor, Tensor)")
def gru_gates_op(zl, rl, h):
    """The K2 gates as an operator a traced program can hold."""
    return _launch("gru_gates", gru_gates_plain, 2, zl, rl, h)


@gru_gates_op.register_fake
def _(zl, rl, h):
    route = _operands("gru_gates", zl, rl, h)[0]
    return _empty(zl, route), _empty(zl, route)


@torch.library.custom_op(
    "raft_tpu_torch::gru_blend", mutates_args=(),
    schema="(Tensor z, Tensor h, Tensor ql) -> Tensor")
def gru_blend_op(z, h, ql):
    """The K2 blend as an operator a traced program can hold."""
    return _launch("gru_blend", gru_blend_plain, 1, z, h, ql)


@gru_blend_op.register_fake
def _(z, h, ql):
    return _empty(z, _operands("gru_blend", z, h, ql)[0])


def gru_gates(zl, rl, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused update/reset-gate tail: ``(σ(zl), σ(rl)·h)``; ``z`` feeds
    :func:`gru_blend`, ``r·h`` the candidate conv."""
    if tracing():
        return torch.ops.raft_tpu_torch.gru_gates(zl, rl, h)
    return GruGates.apply(zl, rl, h)


def gru_blend(z, h, ql) -> torch.Tensor:
    """Fused candidate/blend tail: ``(1−z)·h + z·tanh(ql)``; ``ql`` is the
    candidate conv's pre-tanh output, so q never lands in memory."""
    if tracing():
        return torch.ops.raft_tpu_torch.gru_blend(z, h, ql)
    return GruBlend.apply(z, h, ql)
