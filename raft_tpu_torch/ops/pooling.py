"""Pooling helpers, port of ``raft_tpu/ops/pooling.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool over the two middle dims of (..., H, W, C).

    Matches ``F.avg_pool2d(x, 2, stride=2)``: odd sizes floor, dropping the
    trailing row/col (55 -> 27 -> 13 -> 6), as the reference's correlation
    pyramid does (``core/corr.py:25-27``). A side under 2 px pools to an
    empty level, as JAX's VALID ``reduce_window`` does (``F.avg_pool2d``
    would raise there).
    """
    *lead, H, W, C = x.shape
    if min(H, W) < 2:
        return x.new_zeros((*lead, H // 2, W // 2, C))
    planes = x.movedim(-1, -3).reshape(-1, 1, H, W)
    pooled = F.avg_pool2d(planes, 2, stride=2)
    return pooled.reshape(*lead, C, H // 2, W // 2).movedim(-3, -1)
