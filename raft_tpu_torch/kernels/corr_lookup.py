"""Kernel 1: the correlation window lookup, CUDA C++ for Hopper.

Replaces ``raft_tpu/kernels/corr_pallas.py::_lookup_kernel`` (through
``_level_lookup_pallas`` and ``corr_lookup_pallas``). The kernel is
``csrc/corr_lookup.cu``; its note says what bounds it and how it is laid
out. The plain version is ``models.corr.corr_lookup_gather``.

:func:`corr_lookup_cuda` takes the plain version only for CPU tensors. For
CUDA tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from raft_tpu_torch.kernels._build import check, dtype_code, library, stream
from raft_tpu_torch.models.corr import corr_lookup_gather

MAX_LEVELS = 8      # RAFT_MAX_LEVELS in csrc/corr_lookup.cu
MAX_RADIUS = 16     # keeps 8 warps' (2r+2)² fp32 windows under 48 KB smem

#: kernel launches since the count was last set to 0
launches = 0


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


def corr_lookup_cuda(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                     radius: int) -> torch.Tensor:
    """(B, N, Hl, Wl) levels (fp32 or bf16) + coords (B, H, W, 2) fp32 ->
    (B, H, W, levels·K²) fp32 in the x-major channel order; level i samples
    at coords/2^i with zeros outside its volume (an empty level gives
    zeros: the kernel masks every tap and never reads it)."""
    global launches
    if coords.device.type == "cpu":
        return corr_lookup_gather(pyramid, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"corr_lookup_cuda: no kernel for {coords.device}")
    _validate(pyramid, coords, radius)
    B, H, W, _ = coords.shape
    L = len(pyramid)
    K = 2 * radius + 1
    out = torch.empty((B, H, W, L * K * K), dtype=torch.float32,
                      device=coords.device)
    if out.numel() == 0:
        return out
    vols = (ctypes.c_void_p * L)(*[v.data_ptr() for v in pyramid])
    hs = (ctypes.c_int * L)(*[v.shape[2] for v in pyramid])
    ws = (ctypes.c_int * L)(*[v.shape[3] for v in pyramid])
    code = library().lib.corr_lookup_launch(
        vols, hs, ws, L, coords.data_ptr(), out.data_ptr(), B * H * W,
        radius, dtype_code(pyramid[0].dtype), stream(coords))
    check(code, "corr_lookup")
    launches += 1
    return out
