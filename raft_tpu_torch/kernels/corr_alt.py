"""Kernel 5, the on-the-fly correlation lookup of ``alternate_corr``, in CUDA
C++ for Hopper.

Replaces ``raft_tpu/kernels/corr_alt_pallas.py::_alt_kernel`` (through
``_level_alt_pallas`` and ``alt_corr_lookup_pallas``). The kernel is
``csrc/corr_alt.cu``, built into the same library as the others; its notes
say what bounds it and how it is laid out. The plain version is
``models.corr.alt_corr_lookup``.

:class:`AltCorrLookup` is the ``torch.autograd.Function``: K5 forward on a
CUDA tensor, the plain version on a CPU one; its backward is the VJP of the
plain version by ``torch.autograd.grad`` for fmap1, every fmap2 level and
the coords, as ``_alt_bwd`` goes through the XLA formulation (the JAX
package has no backward kernel for K5). Coords get a real gradient: the
alternate path is a drop-in lookup. :func:`alt_corr_lookup_cuda` takes the
plain version only for CPU tensors; for CUDA tensors it launches the kernel
or raises. Traced by ``torch.export`` (or ``torch.compile``), it calls the
operator ``torch.ops.raft_tpu_torch.alt_corr_lookup`` instead, the forward
alone, with the same two routes.

The kernel takes one of two branches for each (tile of 8x8 queries, level):
the tensor-core product of the tile against the box its windows cover, or
a per-query dot loop where that box is too large. Each launch adds the
count of each to :func:`branch_counts` on the device, which the path never
reads (reading it synchronises).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from raft_tpu_torch.kernels._build import (check, count_launch, library,
                                           stream, tracing)
from raft_tpu_torch.models.corr import alt_corr_lookup

MAX_LEVELS = 8      # RAFT_ALT_MAX_LEVELS in csrc/corr_alt.cu
# A block holds its 64 queries' (2r+2)² fp32 windows beside its copy ring and
# query planes (csrc/corr_alt.cu, corr_alt_smem_bytes); at r=10 that is
# 223,264 B of the 232,448 a block may opt into on the H100, at r=11 too much.
MAX_RADIUS = 10

#: kernel launches since the counts were last set to 0
launches = {"corr_alt": 0}

#: per CUDA device, an int64 tensor there: the tiles that took the tiled
#: branch and the per-query branch, summed by the kernel over its launches
_branches = {}


def branch_counts(device) -> torch.Tensor:
    """The (2,) int64 tensor on ``device`` into which every launch there
    adds its tiles that took the tiled branch and the per-query branch.
    Reading it synchronises; the path never does. ``.zero_()`` resets it."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _branches:
        _branches[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _branches[device]


def _validate(fmap1, pyramid, coords, radius):
    if not isinstance(radius, int) or not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius={radius!r}: the kernel takes 1..{MAX_RADIUS}")
    if fmap1.dim() != 4 or fmap1.shape[-1] % 4:
        raise ValueError("fmap1 must be (B, H, W, C) with C a multiple of 4, "
                         f"got {tuple(fmap1.shape)}")
    B, H, W, C = fmap1.shape
    if tuple(coords.shape) != (B, H, W, 2):
        raise ValueError(f"coords must be {(B, H, W, 2)}, got "
                         f"{tuple(coords.shape)}")
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"{len(pyramid)} levels: the kernel takes 1..{MAX_LEVELS}")
    for name, t in [("fmap1", fmap1), ("coords", coords)] + [
            (f"level {i}", v) for i, v in enumerate(pyramid)]:
        if t.device != coords.device:
            raise ValueError(f"{name} is on {t.device}, coords on "
                             f"{coords.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte aligned rows")
    for i, v in enumerate(pyramid):
        if v.dim() != 4 or v.shape[0] != B or v.shape[3] != C:
            raise ValueError(f"level {i} must be (B, Hl, Wl, C) = ({B}, Hl, "
                             f"Wl, {C}), got {tuple(v.shape)}")


def _alt_launch(fmap1, pyramid, coords, radius) -> torch.Tensor:
    _validate(fmap1, pyramid, coords, radius)
    B, H, W, C = fmap1.shape
    L = len(pyramid)
    K = 2 * radius + 1
    out = torch.empty((B, H, W, L * K * K), dtype=torch.float32,
                      device=coords.device)
    if out.numel() == 0:
        return out
    code = library().lib.corr_alt_launch(
        (ctypes.c_void_p * L)(*[v.data_ptr() for v in pyramid]),
        (ctypes.c_int * L)(*[v.shape[1] for v in pyramid]),
        (ctypes.c_int * L)(*[v.shape[2] for v in pyramid]),
        L, fmap1.data_ptr(), coords.data_ptr(), out.data_ptr(), B, H, W, C,
        radius, math.sqrt(C), branch_counts(coords.device).data_ptr(),
        stream(coords))
    check(code, "corr_alt")
    count_launch(launches, "corr_alt", fmap1.dtype)
    return out


class AltCorrLookup(torch.autograd.Function):
    """K5 forward; the plain version's VJP backward."""

    @staticmethod
    def forward(ctx, fmap1, coords, radius, *pyramid):
        ctx.radius = radius
        ctx.save_for_backward(fmap1, coords, *pyramid)
        if coords.device.type == "cpu":
            return alt_corr_lookup(fmap1, pyramid, coords, radius)
        return _alt_launch(fmap1, pyramid, coords, radius)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        inputs = ctx.saved_tensors              # fmap1, coords, *pyramid
        wanted = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                  *ctx.needs_input_grad[3:]]
        leaves = [t.detach().requires_grad_(w) for t, w in zip(inputs, wanted)]
        grads = [None] * len(leaves)
        if any(wanted):
            with torch.enable_grad():
                out = alt_corr_lookup(leaves[0], leaves[2:], leaves[1],
                                      ctx.radius)
                got = iter(torch.autograd.grad(
                    out, [t for t, w in zip(leaves, wanted) if w], grad,
                    allow_unused=True))
            for i, (t, w) in enumerate(zip(leaves, wanted)):
                if w:
                    g = next(got)
                    # an empty level is never read: its gradient is zeros
                    grads[i] = torch.zeros_like(t) if g is None else g
        return (grads[0], grads[1], None, *grads[2:])


@torch.library.custom_op(
    "raft_tpu_torch::alt_corr_lookup", mutates_args=(),
    schema="(Tensor fmap1, Tensor[] pyramid, Tensor coords, int radius) "
           "-> Tensor")
def alt_corr_lookup_op(fmap1, pyramid, coords, radius):
    """K5 as an operator a traced program can hold: the plain version on a
    CPU tensor, the kernel on a CUDA one."""
    if coords.device.type == "cpu":
        return alt_corr_lookup(fmap1, pyramid, coords, radius)
    return _alt_launch(fmap1, pyramid, coords, radius)


@alt_corr_lookup_op.register_fake
def _(fmap1, pyramid, coords, radius):
    B, H, W, _ = fmap1.shape
    K = 2 * radius + 1
    return fmap1.new_empty((B, H, W, len(pyramid) * K * K),
                           dtype=torch.float32)


def alt_corr_lookup_cuda(fmap1: torch.Tensor, pyramid: Sequence[torch.Tensor],
                         coords: torch.Tensor, radius: int) -> torch.Tensor:
    """fmap1 (B, H, W, C) + fmap2 levels (B, Hl, Wl, C), fp32 and contiguous,
    + coords (B, H, W, 2) fp32 -> (B, H, W, levels·K²) fp32 in the x-major
    channel order, divided by sqrt(C); level i samples at coords/2^i with
    zeros outside it (an empty level gives zeros). Differentiable in fmap1,
    the levels and the coords through :class:`AltCorrLookup`."""
    if coords.device.type not in ("cpu", "cuda"):
        raise ValueError(f"alt_corr_lookup_cuda: no kernel for {coords.device}")
    if tracing():
        return torch.ops.raft_tpu_torch.alt_corr_lookup(fmap1, list(pyramid),
                                                        coords, radius)
    return AltCorrLookup.apply(fmap1, coords, radius, *pyramid)
