"""Correlation volume: all-pairs pyramid + windowed lookup, port of
``raft_tpu/models/corr.py``.

- :func:`all_pairs_correlation` is one fp32 ``torch.matmul`` (the JAX
  package's ``einsum`` at HIGHEST precision), divided by sqrt(C).
- :func:`build_corr_pyramid` average-pools it into a 4-level pyramid of
  (B, N, Hl, Wl) volumes.
- :func:`corr_lookup_gather` is the plain version of the lookup kernel
  (``kernels.corr_lookup``): per level, four flattened-index corner gathers
  with grid_sample's zeros semantics.
- :func:`corr_lookup` dispatches on ``corr_impl`` and the tensor's device.
- :func:`alt_corr_lookup` is the memory-efficient path (``alternate_corr``):
  it never builds the (H·W)² volume, only the fmap2 pyramid, and is the
  plain version of the on-the-fly correlation kernel
  (``kernels.corr_alt``). :class:`AlternateCorrBlock` builds that pyramid.

Output channel layout (the checkpoint parity surface): c = level·K² +
x_idx·K + y_idx with K = 2r+1 — the x offset is the OUTER index, as in both
reference paths (``corr.py:39-43``, ``correlation_kernel.cu:92-95``).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops.pooling import avg_pool2x2


def all_pairs_correlation(fmap1: torch.Tensor,
                          fmap2: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) x (B,H2,W2,C) -> (B, H*W, H2, W2) all-pairs dot products /
    sqrt(C), fp32 (``CorrBlock.corr``, corr.py:52-60; the reference casts
    the fmaps to fp32 first, core/raft.py:102-103). fmap1 may be a band of
    the image's rows and fmap2 the whole image (the query-sharded volume
    of a ``spatial`` mesh axis: this band's queries against every
    target)."""
    B, H, W, C = fmap1.shape
    H2, W2 = fmap2.shape[1:3]
    f1 = fmap1.float().reshape(B, H * W, C)
    f2 = fmap2.float().reshape(B, H2 * W2, C)
    corr = torch.matmul(f1, f2.transpose(1, 2))
    corr = corr / math.sqrt(C)
    return corr.reshape(B, H * W, H2, W2)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> List[torch.Tensor]:
    """List of (B, N, Hl, Wl) volumes, level 0 full res (corr.py:18-27).
    Odd sizes floor, as ``F.avg_pool2d`` does. A level pooled from one
    under 2 px a side is empty (a 1/8 grid under 8x8, images under 64 px),
    as in the JAX package; the lookups read it as zeros."""
    corr = all_pairs_correlation(fmap1, fmap2)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        B, N, H, W = corr.shape
        if min(H, W) < 2:
            corr = corr.new_zeros((B, N, H // 2, W // 2))
        else:
            corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def _window_offsets(radius: int, device=None):
    """(K², ) x/y offsets in the x-major channel order."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    K = 2 * radius + 1
    return d.repeat_interleave(K), d.repeat(K)   # x outer, y inner


def _gather_bilinear_2d(vol: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                        wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample ``vol`` (B, N, H, W) at per-(B,N) points (B, N, P)
    given as integer corners ``x0``/``y0`` (B, N, P) and fractions
    ``wx``/``wy`` (B, N, 1), with zeros out of bounds. Returns (B, N, P)
    fp32."""
    B, N, H, W = vol.shape
    flat = vol.reshape(B, N, H * W)

    def corner(xi, yi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long())
        vals = torch.gather(flat, 2, idx).float()
        return vals * (w * valid.float())

    return (corner(x0, y0, (1 - wx) * (1 - wy))
            + corner(x0 + 1, y0, wx * (1 - wy))
            + corner(x0, y0 + 1, (1 - wx) * wy)
            + corner(x0 + 1, y0 + 1, wx * wy))


def corr_lookup_gather(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """The plain lookup: sample (2r+1)² windows at every level around
    ``coords`` (B,H,W,2); level i uses coords/2^i. fp32 or bf16 levels.
    Returns (B, H, W, num_levels·K²) fp32 (corr.py:29-50); an empty level
    gives zeros.

    The window offsets are integers, so every tap of a query shares the
    query's bilinear fractions; they are taken once per query, from
    coords/2^i, as ``_window_base`` and the Pallas kernel take them. (The
    JAX ``corr_lookup`` rounds coords/2^i + offset per tap, which moves a
    fraction by up to an ulp of the coordinate: ~1.5e-5 at x = 128.)
    """
    B, H, W, _ = coords.shape
    N = H * W
    du, dv = _window_offsets(radius, coords.device)
    x = coords[..., 0].reshape(B, N, 1).float()
    y = coords[..., 1].reshape(B, N, 1).float()
    out = []
    for i, vol in enumerate(pyramid):
        if vol.numel() == 0:
            out.append(x.new_zeros((B, N, du.numel())))
            continue
        xl, yl = x / (2 ** i), y / (2 ** i)
        x0, y0 = torch.floor(xl), torch.floor(yl)
        out.append(_gather_bilinear_2d(vol, x0 + du, y0 + dv,
                                       xl - x0, yl - y0))
    return torch.cat(out, dim=-1).reshape(B, H, W, -1)


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int, corr_impl: str = "pallas") -> torch.Tensor:
    """The lookup ``RAFTConfig.corr_impl`` selects: ``"gather"`` runs
    :func:`corr_lookup_gather` on any device; every other name runs
    ``kernels.corr_lookup.corr_lookup_cuda``, which launches the CUDA kernel
    on a CUDA tensor and takes the plain version only for a CPU tensor."""
    if corr_impl == "gather":
        return corr_lookup_gather(pyramid, coords, radius)
    # imported here: the kernel module imports this one for the plain version
    from raft_tpu_torch.kernels.corr_lookup import corr_lookup_cuda

    return corr_lookup_cuda(pyramid, coords, radius)


# ---------------------------------------------------------------------------
# Memory-efficient path (alt_cuda_corr equivalent)
# ---------------------------------------------------------------------------


def _gather_bilinear_fmap(fmap: torch.Tensor, x0: torch.Tensor,
                          y0: torch.Tensor, wx: torch.Tensor,
                          wy: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample ``fmap`` (B, H, W, C) at (B, n, P) points given as
    integer corners ``x0``/``y0`` (B, n, P) and fractions ``wx``/``wy``
    (B, n, 1), with zeros out of bounds -> (B, n, P, C)."""
    B, H, W, C = fmap.shape
    flat = fmap.reshape(B, H * W, C)
    batch = torch.arange(B, device=fmap.device)[:, None]

    def corner(xi, yi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1).long() * W
               + xi.clamp(0, W - 1).long()).reshape(B, -1)
        vals = flat[batch, idx].reshape(*xi.shape, C)      # (B, n, P, C)
        return vals * (w * valid.float())[..., None]

    return (corner(x0, y0, (1 - wx) * (1 - wy))
            + corner(x0 + 1, y0, wx * (1 - wy))
            + corner(x0, y0 + 1, (1 - wx) * wy)
            + corner(x0 + 1, y0 + 1, wx * wy))


def alt_corr_lookup(fmap1: torch.Tensor,
                    fmap2_pyramid: Sequence[torch.Tensor],
                    coords: torch.Tensor, radius: int,
                    chunk: int = 4096) -> torch.Tensor:
    """On-the-fly windowed correlation, never materializing (H·W)².

    fmap1 (B, H, W, C); fmap2 levels (B, Hl, Wl, C); coords (B, H, W, 2).
    For each level, sample fmap2 at the (2r+1)² window points around
    coords/2^i, dot with fmap1's row, and divide once by sqrt(C), C being
    fmap1's width (``AlternateCorrBlock``, corr.py:63-91). Returns
    (B, H, W, levels·K²) fp32; an empty level gives zeros. Chunked over
    queries to bound the (chunk, K², C) intermediate.

    As :func:`corr_lookup_gather` does, each query's bilinear fractions are
    taken once, from coords/2^i, as the Pallas kernel takes them; the JAX
    package's XLA formulation rounds coords/2^i + offset per tap, which
    moves a fraction by up to an ulp of the coordinate.
    """
    B, H, W, C = fmap1.shape
    N = H * W
    du, dv = _window_offsets(radius, coords.device)
    f1 = fmap1.float().reshape(B, N, C)
    x = coords[..., 0].reshape(B, N, 1).float()
    y = coords[..., 1].reshape(B, N, 1).float()
    out = []
    for s in range(0, N, chunk):
        f1_c, x_c, y_c = f1[:, s:s + chunk], x[:, s:s + chunk], y[:, s:s + chunk]
        levels = []
        for i, f2 in enumerate(fmap2_pyramid):
            if f2.numel() == 0:
                levels.append(x_c.new_zeros((B, x_c.shape[1], du.numel())))
                continue
            xl, yl = x_c / (2 ** i), y_c / (2 ** i)
            x0, y0 = torch.floor(xl), torch.floor(yl)
            f2v = _gather_bilinear_fmap(f2.float(), x0 + du, y0 + dv,
                                        xl - x0, yl - y0)
            levels.append(torch.einsum("bnkc,bnc->bnk", f2v, f1_c))
        out.append(torch.cat(levels, dim=-1))
    return (torch.cat(out, dim=1) / math.sqrt(C)).reshape(B, H, W, -1)


class AlternateCorrBlock:
    """Memory-efficient path (corr.py:63-91 + alt_cuda_corr).

    Builds the pooled fmap2 pyramid once, ``num_levels`` levels; each call
    recomputes the windowed correlation. The reference builds num_levels+1
    entries but indexes only 0..num_levels-1 (corr.py:68-72,82-83); this
    builds only what is used, as the JAX package does. Levels are
    contiguous NHWC, as the kernel reads them.
    """

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = 4, radius: int = 4, chunk: int = 4096):
        self.radius = radius
        self.chunk = chunk
        self.fmap1 = fmap1.float().contiguous()
        self.fmap2_pyramid = [fmap2.float().contiguous()]
        for _ in range(num_levels - 1):
            self.fmap2_pyramid.append(
                avg_pool2x2(self.fmap2_pyramid[-1]).contiguous())

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        return alt_corr_lookup(self.fmap1, self.fmap2_pyramid, coords,
                               self.radius, self.chunk)
