"""Collectives along the image height, for the ``spatial`` mesh axis.

Under a ``(data, spatial)`` mesh the ranks of one ``spatial`` group hold
horizontal bands of the same images: rank ``s`` of ``S`` holds rows
``s·h .. (s+1)·h`` of every tensor at every resolution (``h`` being the
band at that resolution; the mesh fences make every band whole). The JAX
package leaves the exchanges this needs to GSPMD; here they are written
out, each an autograd ``Function`` whose backward sends the cotangents
back to their owners:

- :func:`halo`: a band with ``top`` rows of the band above and ``bottom``
  rows of the band below, zeros past the image's true top and bottom (a
  conv's zero padding), for a convolution over the band;
- :func:`gather_rows`: the whole image from every band (the query-sharded
  correlation volume's fmap2);
- :func:`all_sum`: a sum over the group (the norms' statistics).

Every one is written on ``all_reduce``: each rank writes its rows into its
own slot of a zeroed buffer and the sum delivers them, exactly (a sum with
zeros rounds nothing). gloo carries CUDA tensors in ``all_reduce`` and
``broadcast`` only (no send/recv, no all-gather), so this one form runs on
gloo (two ranks on one card) and on NCCL alike. Every rank issues the
same collectives in the same order, the backward's too: a forward (or its
recompute under ``remat``) on one rank is the same program on every rank
of the group.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

class Spatial:
    """This rank's place on the ``spatial`` axis: the group of the ranks
    that share its ``data`` coordinate, its index in it and its size."""

    def __init__(self, group, index: int, size: int):
        self.group = group
        self.index = int(index)
        self.size = int(size)

    def band(self, rows: int) -> Tuple[int, int]:
        """``(first global row, global rows)`` of a band ``rows`` high."""
        return self.index * rows, self.size * rows

    def __repr__(self) -> str:
        return f"Spatial(index={self.index}, size={self.size})"


def _slots(x: torch.Tensor, n: int, dim: int = 0,
           rows: int = -1) -> torch.Tensor:
    """A zeroed ``(n, *x.shape)`` buffer; with ``rows`` >= 0, ``rows``
    wide along ``dim``."""
    shape = list(x.shape)
    if rows >= 0:
        shape[dim] = rows
    return x.new_zeros([n] + shape)


def _reduce(buf: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(buf, group=group)
    return buf


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.clone(), ctx.group), None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; its adjoint is the
    same sum of the cotangents (every rank's loss reads the summed
    value)."""
    return _AllReduceSum.apply(x, group)


def _layout_of(rows: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """Borrowed ``rows`` in ``band``'s layout when that is channels-last,
    so the concatenation keeps it (``torch.cat`` of mixed layouts returns
    NCHW, which the next conv would convert back)."""
    if (band.dim() == 4 and not band.is_contiguous()
            and band.is_contiguous(memory_format=torch.channels_last)):
        return rows.contiguous(memory_format=torch.channels_last)
    return rows


class _Halo(torch.autograd.Function):
    """The band with ``top`` rows above it and ``bottom`` below it, along
    ``dim``; zero rows past the image's edges."""

    @staticmethod
    def forward(ctx, x, top, bottom, dim, sp):
        ctx.top, ctx.bottom, ctx.dim, ctx.sp = top, bottom, dim, sp
        s, S, h = sp.index, sp.size, x.shape[dim]

        def rows(t, start, n):
            return torch.narrow(t, dim, start, n)

        # my slot: my first `bottom` rows (the band above's lower halo),
        # then my last `top` rows (the band below's upper halo)
        buf = _slots(x, S, dim, top + bottom)
        rows(buf[s], 0, bottom).copy_(rows(x, 0, bottom))
        rows(buf[s], bottom, top).copy_(rows(x, h - top, top))
        buf = _reduce(buf, sp.group)
        # past the image's edges: my own slot, zeroed
        above = (rows(buf[s - 1], bottom, top) if s > 0
                 else rows(buf[s], bottom, top).zero_())
        below = (rows(buf[s + 1], 0, bottom) if s < S - 1
                 else rows(buf[s], 0, bottom).zero_())
        return torch.cat([_layout_of(above, x), x, _layout_of(below, x)],
                         dim)

    @staticmethod
    def backward(ctx, g):
        top, bottom, dim, sp = ctx.top, ctx.bottom, ctx.dim, ctx.sp
        s, S = sp.index, sp.size
        h = g.shape[dim] - top - bottom

        def rows(t, start, n):
            return torch.narrow(t, dim, start, n)

        # my slot: the cotangents of the rows I borrowed, upper then lower
        buf = _slots(g, S, dim, top + bottom)
        rows(buf[s], 0, top).copy_(rows(g, 0, top))
        rows(buf[s], top, bottom).copy_(rows(g, top + h, bottom))
        buf = _reduce(buf, sp.group)
        gx = rows(g, top, h).clone()
        if s < S - 1:   # the band below borrowed my last `top` rows
            rows(gx, h - top, top).add_(rows(buf[s + 1], 0, top))
        if s > 0:       # the band above borrowed my first `bottom` rows
            rows(gx, 0, bottom).add_(rows(buf[s - 1], top, bottom))
        return gx, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, sp: Spatial,
         dim: int = 2) -> torch.Tensor:
    """``x``'s band along ``dim`` (the height: 2 for (B, C, H, W)) with
    ``top`` rows of the band above and ``bottom`` of the band below; zero
    rows past the image's first and last. No rows asked for: ``x`` itself,
    and no collective."""
    if top == 0 and bottom == 0:
        return x
    h = x.shape[dim]
    if top > h or bottom > h:
        raise ValueError(f"a halo of ({top}, {bottom}) rows from bands of "
                         f"{h}: the mesh fence keeps bands above the "
                         "largest halo")
    return _Halo.apply(x, top, bottom, dim, sp)


def conv_halo(kernel: int, stride: int, padding: int) -> Tuple[int, int]:
    """Rows above and below a band that a convolution along its height
    reads: output row ``j`` of a ``kernel``-row, ``stride``, ``padding``
    conv reads input rows ``j·stride − padding ..`` ``+ kernel − 1``. A
    band starting on a multiple of ``stride`` then needs ``padding`` rows
    above and ``kernel − padding − stride`` below (none when negative:
    the 7x7 stride-2 stem takes 3 and 2, a 3x3 stride 2 takes 1 and 0)."""
    return padding, max(0, kernel - padding - stride)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sp):
        ctx.dim, ctx.sp = dim, sp
        buf = _slots(x, sp.size)
        buf[sp.index].copy_(x)
        _reduce(buf, sp.group)
        return torch.cat(buf.unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        sp, dim = ctx.sp, ctx.dim
        h = g.shape[dim] // sp.size
        total = _reduce(g.clone(memory_format=torch.contiguous_format),
                        sp.group)
        return torch.narrow(total, dim, sp.index * h, h), None, None


def gather_rows(x: torch.Tensor, sp: Spatial, dim: int = 1) -> torch.Tensor:
    """Every band of ``x`` along ``dim``, in rank order: the whole image on
    every rank of the group. Its adjoint sums every rank's cotangent and
    keeps this band's rows."""
    return _GatherRows.apply(x, dim, sp)


def gather_blocks(t: torch.Tensor, grid: Sequence[int],
                  coords: Sequence[int], group: Optional[object]
                  ) -> torch.Tensor:
    """A ``(data, spatial)`` mesh's blocks of one value, whole on every
    rank: ``t`` is this rank's block, rows ``coords[0]`` of dim 0 and band
    ``coords[1]`` of dim 1 on a ``grid`` of ``(data, spatial)`` blocks;
    ``group`` holds every rank of the mesh. Not differentiable (the
    serving engine's outputs)."""
    data, spatial = grid
    buf = _slots(t, data * spatial)
    buf[coords[0] * spatial + coords[1]].copy_(t)
    _reduce(buf, group)
    buf = buf.reshape((data, spatial) + tuple(t.shape))
    rows = [torch.cat(buf[d].unbind(0), 1) for d in range(data)]
    return torch.cat(rows, 0)
