"""GMA's global motion aggregation: the attention formed once a pair and the
aggregation run every refinement step.

After Jiang, Campbell, Lu, Li and Hartley, "Learning to Estimate Hidden
Motions with Global Motion Aggregation" (ICCV 2021, arXiv:2104.02409), and
its public code (zacjiang/GMA ``core/gma.py``: ``RelPosEmb``,
``Attention``, ``Aggregate``), at its published settings: content-only
attention (``position_only`` and ``position_and_content`` off), one head
of ``dim_head`` = 128 over the 128 context channels:

- ``q, k = split(W_qk ⋆ inp)`` (a 1x1 conv, no bias), then
  ``A = softmax_rows((q/√dim_head) kᵀ)``, (B, N, N) over the N = H/8·W/8
  positions: :class:`Attention`, kernel K6 (``kernels.gma``);
- ``g = m + γ·(A (W_v ⋆ m))`` for the motion features m, γ a learned
  scalar: :class:`Aggregate`, kernel K7.

Parameter and buffer names are the published ``state_dict``'s
(``att.to_qk.weight``, ``att.pos_emb.rel_height.weight``,
``att.pos_emb.rel_width.weight``, ``att.pos_emb.rel_ind``,
``update_block.aggregator.to_v.weight``, ``update_block.aggregator.gamma``),
so a GMA checkpoint loads with ``strict=True``. The relative position
tables serve only the positional modes, which the published settings leave
off; they are held, not read. A state dict without ``rel_ind`` (a buffer
derived from ``max_pos_size``) loads too.

Tensors are (B, C, H, W) channels-last, as in ``models.raft``: the q and k
halves of the W_qk conv's NHWC output and the NHWC motion features are
read by the kernels in place, and ``g`` leaves as an NHWC view. The
products run in float32 whatever the compute dtype (the convs' outputs
are cast up, ``g`` back down), as the correlation volume does.
"""

from __future__ import annotations

import torch
from torch import nn

from raft_tpu_torch.kernels.gma import gma_aggregate, gma_attention
from raft_tpu_torch.models.layers import conv

#: the published ``max_pos_size`` of the relative position tables
MAX_POS_SIZE = 160


class _Table(nn.Module):
    """An ``nn.Embedding``'s ``weight`` under its name, drawn by
    :meth:`RelPosEmb.reset_parameters` (never by torch's global
    generator)."""

    def __init__(self, rows: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(rows, dim))


class RelPosEmb(nn.Module):
    """The published relative position tables (``core/gma.py``
    ``RelPosEmb``): unread under content-only attention."""

    def __init__(self, max_pos_size: int, dim_head: int):
        super().__init__()
        self.rel_height = _Table(2 * max_pos_size - 1, dim_head)
        self.rel_width = _Table(2 * max_pos_size - 1, dim_head)
        self.register_buffer("rel_ind", self.relative_index(max_pos_size))

    @staticmethod
    def relative_index(max_pos_size: int) -> torch.Tensor:
        pos = torch.arange(max_pos_size)
        return pos.view(1, -1) - pos.view(-1, 1) + max_pos_size - 1

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1), ``nn.Embedding``'s initialisation."""
        for t in (self.rel_height.weight, self.rel_width.weight):
            t.normal_(generator=generator)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "rel_ind"
        if key not in state_dict:
            state_dict[key] = self.rel_ind.clone()
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class Attention(nn.Module):
    """``A = softmax_rows((q/√dim_head) kᵀ)`` from the context features
    (``core/gma.py`` ``Attention``, content only, one head)."""

    def __init__(self, dim: int, heads: int = 1, dim_head: int = 128,
                 max_pos_size: int = MAX_POS_SIZE):
        super().__init__()
        if heads != 1:
            raise ValueError(f"heads={heads}: the port builds GMA's "
                             "published single head")
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.to_qk = conv(dim, 2 * heads * dim_head, 1, 1, 0, bias=False)
        self.pos_emb = RelPosEmb(max_pos_size, dim_head)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) context features -> A (B, H·W, H·W) float32."""
        qk = self.to_qk(inp).float()
        B, _, H, W = qk.shape
        q, k = qk.permute(0, 2, 3, 1).reshape(B, H * W, -1).split(
            self.dim_head, -1)
        return gma_attention(q, k, self.scale)


class Aggregate(nn.Module):
    """``g = m + γ·(A (W_v ⋆ m))`` (``core/gma.py`` ``Aggregate``, one
    head of ``dim`` channels, so no output projection)."""

    def __init__(self, dim: int, heads: int = 1, dim_head: int = 128):
        super().__init__()
        if heads * dim_head != dim:
            raise ValueError(f"heads·dim_head = {heads * dim_head} must be "
                             f"dim = {dim}: the port builds no projection")
        self.to_v = conv(dim, heads * dim_head, 1, 1, 0, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """A (B, N, N) and the motion features m (B, C, H, W) -> g, shaped
        and typed like m, channels-last."""
        B, C, H, W = m.shape
        v = self.to_v(m).float().permute(0, 2, 3, 1).reshape(B, H * W, C)
        rows = m.float().permute(0, 2, 3, 1).reshape(B, H * W, C)
        g = gma_aggregate(attn, v, rows, self.gamma)
        return g.view(B, H, W, C).permute(0, 3, 1, 2).to(m.dtype)
