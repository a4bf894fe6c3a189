"""Feature/context encoders (extractor.py:118-267), port of
``raft_tpu/models/encoders.py``.

3-stage residual CNNs with total stride 8, on (B, C, H, W) tensors. An
encoder runs in the memory layout :func:`memory_format` gives its norm:
channels-last, except under the instance and group norms, which normalise
NCHW copies on the card (``F.instance_norm`` and CUDA's group norm make
their input contiguous), so those encoders keep NCHW weights and take an
NCHW copy of their input, and cuDNN transposes around each conv where a
channels-last encoder would copy before every conv and after every norm.

``forward(x, train=False, freeze_bn=False)`` normalizes with the batch's
statistics (and updates the running ones) only when ``train`` and not
``freeze_bn``, as the JAX encoders' ``use_running_average = not train or
freeze_bn``.

``dropout > 0`` drops whole channels of the output in train mode only, as
flax's ``Dropout(broadcast_dims=(1, 2))`` (torch's ``Dropout2d``,
extractor.py:146-148): one keep draw per (sample, channel) broadcast over H
and W, kept channels scaled by 1/(1-p). The draws come from the
``generator`` the caller passes (the trainer seeds it from (seed, step));
their numbers are not JAX's. In a data-parallel step each rank passes
``draw_rows=(start, global_batch)``: it draws the global batch's mask and
keeps its own rows, so N ranks drop what one rank drops on the whole batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from raft_tpu_torch.models.layers import (BottleneckBlock, ResidualBlock,
                                          apply_norm, conv, norm_layer)


def channel_dropout(x: torch.Tensor, p: float,
                    generator: Optional[torch.Generator],
                    draw_rows: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """flax ``Dropout(p, broadcast_dims=(1, 2))`` on (B, C, H, W): each
    (sample, channel) kept with probability 1-p, kept ones divided by it.
    ``draw_rows=(start, global_batch)``: ``x`` is rows ``start..`` of a
    global batch, whose whole mask is drawn."""
    keep_prob = 1.0 - p
    b = x.shape[0]
    start, total = draw_rows if draw_rows is not None else (0, b)
    draw = torch.rand((total,) + x.shape[1:2] + (1, 1), generator=generator,
                      device=x.device)[start:start + b]
    return torch.where(draw < keep_prob, x / keep_prob, torch.zeros_like(x))


def memory_format(norm_fn: str) -> torch.memory_format:
    """The layout an encoder with norm ``norm_fn`` computes in (see the
    module's note)."""
    if norm_fn in ("instance", "group"):
        return torch.contiguous_format
    return torch.channels_last


def _encode(enc: nn.Module, x: torch.Tensor, train: bool, freeze_bn: bool,
            generator: Optional[torch.Generator],
            draw_rows: Optional[Tuple[int, int]]) -> torch.Tensor:
    ura = (not train) or freeze_bn
    x = x.contiguous(memory_format=enc.memory_format)
    x = enc.relu1(apply_norm(enc.norm1, enc.conv1(x), ura))
    for layer in (enc.layer1, enc.layer2, enc.layer3):
        for block in layer:
            x = block(x, ura)
    x = enc.conv2(x)
    if train and enc.dropout > 0:
        x = channel_dropout(x, enc.dropout, generator, draw_rows)
    return x


class BasicEncoder(nn.Module):
    """64 -> 64 -> 96 -> 128 residual encoder + 1x1 head (extractor.py:118)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.memory_format = memory_format(norm_fn)
        self.conv1 = conv(3, 64, 7, 2, 3)
        # stem GroupNorm uses 8 groups, not 64//8 (extractor.py:124)
        self.norm1 = norm_layer(norm_fn, 64, num_groups=8)
        self.relu1 = nn.ReLU()
        self.layer1 = self._layer(64, 64, norm_fn, 1)
        self.layer2 = self._layer(64, 96, norm_fn, 2)
        self.layer3 = self._layer(96, 128, norm_fn, 2)
        self.conv2 = conv(128, output_dim, 1, 1, 0)

    @staticmethod
    def _layer(cin, dim, norm_fn, stride):
        return nn.Sequential(ResidualBlock(cin, dim, norm_fn, stride),
                             ResidualBlock(dim, dim, norm_fn, 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                freeze_bn: bool = False,
                generator: Optional[torch.Generator] = None,
                draw_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return _encode(self, x, train, freeze_bn, generator, draw_rows)


class SmallEncoder(nn.Module):
    """32 -> 32 -> 64 -> 96 bottleneck encoder + 1x1 head (extractor.py:195)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.memory_format = memory_format(norm_fn)
        self.conv1 = conv(3, 32, 7, 2, 3)
        self.norm1 = norm_layer(norm_fn, 32, num_groups=8)
        self.relu1 = nn.ReLU()
        self.layer1 = self._layer(32, 32, norm_fn, 1)
        self.layer2 = self._layer(32, 64, norm_fn, 2)
        self.layer3 = self._layer(64, 96, norm_fn, 2)
        self.conv2 = conv(96, output_dim, 1, 1, 0)

    @staticmethod
    def _layer(cin, dim, norm_fn, stride):
        return nn.Sequential(
            BottleneckBlock(cin, dim, norm_fn, stride),
            BottleneckBlock(dim, dim, norm_fn, 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                freeze_bn: bool = False,
                generator: Optional[torch.Generator] = None,
                draw_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return _encode(self, x, train, freeze_bn, generator, draw_rows)
