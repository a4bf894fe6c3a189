"""Kernel 1, the correlation window lookup, and kernel 3, its adjoint, in
CUDA C++ for Hopper.

Replace ``raft_tpu/kernels/corr_pallas.py::_lookup_kernel`` and
``::_scatter_kernel`` (through ``corr_lookup_pallas`` and its custom VJP,
``_lookup_bwd``). The kernels are ``csrc/corr_lookup.cu``; its notes say
what bounds them and how they are laid out. The plain versions are
``models.corr.corr_lookup_gather`` and :func:`corr_lookup_bwd_plain`, its
VJP by ``torch.autograd.grad``.

:class:`CorrLookup` is the ``torch.autograd.Function`` that carries both:
the lookup forward, the scatter backward; coords get no gradient, as in
``_lookup_bwd``. :func:`corr_lookup_cuda` and :func:`corr_scatter_cuda` take
the plain versions only for CPU tensors. For CUDA tensors they launch the
kernel or raise; nothing falls back. Traced by ``torch.export`` (or
``torch.compile``), :func:`corr_lookup_cuda` calls the operator
``torch.ops.raft_tpu_torch.corr_lookup`` instead, the forward alone, with
the same two routes.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
from torch.autograd.function import once_differentiable

from raft_tpu_torch.kernels._build import (check, count_launch,
                                           dtype_code, library, stream,
                                           tracing)
from raft_tpu_torch.models.corr import corr_lookup_gather

MAX_LEVELS = 8      # RAFT_MAX_LEVELS in csrc/corr_lookup.cu
# The scatter's 8 warps' (2r+1)² fp32 cotangents stay under the 48 KB of
# shared memory a block has without opting in up to r=19 (48,672 B); the
# lookup sizes its blocks to its warps' levels·(2r+2)² fp32 windows.
MAX_RADIUS = 19

#: kernel launches since the counts were last set to 0
launches = {"corr_lookup": 0, "corr_scatter": 0}


def _validate(pyramid, coords, radius):
    if not isinstance(radius, int) or not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius={radius!r}: the kernel takes 1..{MAX_RADIUS}")
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be (B, H, W, 2), got {tuple(coords.shape)}")
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        raise ValueError("coords must be contiguous float32")
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"{len(pyramid)} levels: the kernel takes 1..{MAX_LEVELS}")
    B, H, W, _ = coords.shape
    dtype = pyramid[0].dtype
    dtype_code(dtype)   # raises for a dtype the kernel does not take
    for i, v in enumerate(pyramid):
        if v.device != coords.device:
            raise ValueError(f"level {i} is on {v.device}, coords on "
                             f"{coords.device}")
        if v.dim() != 4 or tuple(v.shape[:2]) != (B, H * W):
            raise ValueError(f"level {i} must be (B, H*W, Hl, Wl) = "
                             f"({B}, {H * W}, Hl, Wl), got {tuple(v.shape)}")
        if v.dtype != dtype or not v.is_contiguous():
            raise ValueError("every level must be contiguous and of one "
                             "dtype")


def _levels(pyramid):
    L = len(pyramid)
    return ((ctypes.c_void_p * L)(*[v.data_ptr() for v in pyramid]),
            (ctypes.c_int * L)(*[v.shape[2] for v in pyramid]),
            (ctypes.c_int * L)(*[v.shape[3] for v in pyramid]))


def _lookup_launch(pyramid, coords, radius) -> torch.Tensor:
    _validate(pyramid, coords, radius)
    B, H, W, _ = coords.shape
    L = len(pyramid)
    K = 2 * radius + 1
    out = torch.empty((B, H, W, L * K * K), dtype=torch.float32,
                      device=coords.device)
    if out.numel() == 0:
        return out
    code = library().lib.corr_lookup_launch(
        *_levels(pyramid), L, coords.data_ptr(), out.data_ptr(), B * H * W,
        radius, dtype_code(pyramid[0].dtype), stream(coords))
    check(code, "corr_lookup")
    count_launch(launches, "corr_lookup", pyramid[0].dtype)
    return out


def corr_lookup_bwd_plain(grad: torch.Tensor, pyramid: Sequence[torch.Tensor],
                          coords: torch.Tensor, radius: int
                          ) -> List[torch.Tensor]:
    """The plain version of :func:`corr_scatter_cuda`: the VJP of
    ``corr_lookup_gather`` by ``torch.autograd.grad``. The lookup is linear
    in the volume, so only the levels' shapes, dtype and device are read.
    The VJP runs on fp32 volumes and each level's gradient is rounded once
    to the volume's dtype, as ``_scatter_kernel`` accumulates in fp32 and
    stores in the volume's dtype."""
    levels = [torch.zeros(v.shape, dtype=torch.float32, device=v.device,
                          requires_grad=True) for v in pyramid]
    with torch.enable_grad():
        out = corr_lookup_gather(levels, coords.detach(), radius)
        grads = torch.autograd.grad(out, levels, grad, allow_unused=True)
    return [(torch.zeros_like(lv) if g is None else g).to(v.dtype)
            for g, lv, v in zip(grads, levels, pyramid)]


def corr_scatter_cuda(grad: torch.Tensor, pyramid: Sequence[torch.Tensor],
                      coords: torch.Tensor, radius: int) -> List[torch.Tensor]:
    """The lookup's adjoint: the (B, H, W, levels·K²) fp32 cotangent of
    :func:`corr_lookup_cuda`'s output -> one gradient per level, shaped and
    typed like ``pyramid`` (whose values are not read). Zero outside each
    query's window; out-of-range taps are dropped."""
    if coords.device.type == "cpu":
        return corr_lookup_bwd_plain(grad, pyramid, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"corr_scatter_cuda: no kernel for {coords.device}")
    _validate(pyramid, coords, radius)
    B, H, W, _ = coords.shape
    L = len(pyramid)
    K = 2 * radius + 1
    if (grad.shape != (B, H, W, L * K * K) or grad.dtype != torch.float32
            or grad.device != coords.device or not grad.is_contiguous()):
        raise ValueError(f"grad must be contiguous float32 {(B, H, W, L * K * K)} "
                         f"on {coords.device}, got {grad.dtype} "
                         f"{tuple(grad.shape)} on {grad.device}")
    dvol = [torch.zeros(v.shape, dtype=v.dtype, device=v.device)
            for v in pyramid]
    if grad.numel() == 0:
        return dvol
    code = library().lib.corr_scatter_launch(
        *_levels(dvol), L, coords.data_ptr(), grad.data_ptr(), B * H * W,
        radius, dtype_code(pyramid[0].dtype), stream(coords))
    check(code, "corr_scatter")
    count_launch(launches, "corr_scatter", pyramid[0].dtype)
    return dvol


class CorrLookup(torch.autograd.Function):
    """K1 forward, K3 backward; the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, coords, radius, *pyramid):
        ctx.radius = radius
        ctx.save_for_backward(coords, *pyramid)
        if coords.device.type == "cpu":
            return corr_lookup_gather(pyramid, coords, radius)
        return _lookup_launch(pyramid, coords, radius)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        coords, *pyramid = ctx.saved_tensors
        if not any(ctx.needs_input_grad[2:]):
            return (None, None) + (None,) * len(pyramid)
        dvol = corr_scatter_cuda(grad.contiguous(), pyramid, coords,
                                 ctx.radius)
        # coords get no gradient, as _lookup_bwd returns None for them
        return (None, None, *dvol)


@torch.library.custom_op(
    "raft_tpu_torch::corr_lookup", mutates_args=(),
    schema="(Tensor coords, Tensor[] pyramid, int radius) -> Tensor")
def corr_lookup_op(coords, pyramid, radius):
    """K1 as an operator a traced program can hold: the plain version on a
    CPU tensor, the kernel on a CUDA one."""
    if coords.device.type == "cpu":
        return corr_lookup_gather(pyramid, coords, radius)
    return _lookup_launch(pyramid, coords, radius)


@corr_lookup_op.register_fake
def _(coords, pyramid, radius):
    B, H, W, _ = coords.shape
    K = 2 * radius + 1
    return coords.new_empty((B, H, W, len(pyramid) * K * K),
                            dtype=torch.float32)


def corr_lookup_cuda(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                     radius: int) -> torch.Tensor:
    """(B, N, Hl, Wl) levels (fp32 or bf16) + coords (B, H, W, 2) fp32 ->
    (B, H, W, levels·K²) fp32 in the x-major channel order; level i samples
    at coords/2^i with zeros outside its volume (an empty level gives
    zeros: the kernel masks every tap and never reads it). Differentiable
    in the levels through :class:`CorrLookup`."""
    if coords.device.type not in ("cpu", "cuda"):
        raise ValueError(f"corr_lookup_cuda: no kernel for {coords.device}")
    if tracing():
        return torch.ops.raft_tpu_torch.corr_lookup(coords, list(pyramid),
                                                    radius)
    return CorrLookup.apply(coords, radius, *pyramid)
