"""Input padding to stride-8 alignment (NHWC), port of
``raft_tpu/ops/padding.py``.

Padding replicates the edge; 'sintel' centers the pad, 'kitti' pads only
the bottom (``core/utils/utils.py:16``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_amounts(ht: int, wd: int, mode: str = "sintel"):
    """(left, right, top, bottom) pad that makes ``ht``/``wd`` divisible by 8."""
    pad_ht = (((ht // 8) + 1) * 8 - ht) % 8
    pad_wd = (((wd // 8) + 1) * 8 - wd) % 8
    if mode == "sintel":
        return (pad_wd // 2, pad_wd - pad_wd // 2,
                pad_ht // 2, pad_ht - pad_ht // 2)
    return (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)


class InputPadder:
    """Pads NHWC images so H and W are divisible by 8."""

    def __init__(self, dims, mode: str = "sintel"):
        # dims: a shape tuple (..., H, W, C) — NHWC
        self.ht, self.wd = dims[-3], dims[-2]
        self._pad = pad_amounts(self.ht, self.wd, mode)

    def pad(self, *inputs: torch.Tensor):
        left, right, top, bottom = self._pad
        out = [F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
                     mode="replicate").permute(0, 2, 3, 1)
               for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        left, right, top, bottom = self._pad
        ht, wd = x.shape[-3], x.shape[-2]
        return x[..., top:ht - bottom, left:wd - right, :]
