"""Recurrent update blocks, port of ``raft_tpu/models/update.py``.

Tensors are (B, C, H, W), channels-last in memory (see ``models.raft``).

Channel arithmetic is the parity surface: basic corr feature
4·(2·4+1)²=324, motion feature 126+2=128, GRU input 128+128
(update.py:82,87,97,119); small corr feature 4·49=196, motion 80+2=82, GRU
input 82+64 (update.py:65,103); GMA's block adds the 128 aggregated
motion channels, 128+128+128 (:class:`GMAUpdateBlock`). The motion
encoders' convs are cuDNN convs, as the JAX package leaves them to XLA
outside Pallas.

Each GRU half computes its z and r pre-activations as one double-width conv
over the shared input (the weights of ``convz*`` and ``convr*``
concatenated; identical values, one conv call instead of two) and hands
the two halves of its output, as views, to the gate tail: channels-last,
each half is every pixel's first or last C channels, which the gate
kernels read in place. Under mixed
precision every conv here computes in bf16 and the blocks take and give
bf16, so the gate and blend kernels run in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from raft_tpu_torch.kernels.gru import (gru_blend, gru_blend_plain, gru_gates,
                                        gru_gates_plain)
from raft_tpu_torch.models.gma import Aggregate
from raft_tpu_torch.models.layers import conv
from raft_tpu_torch.parallel.halo import halo


def _pair_conv(conv_a: nn.Conv2d, conv_b: nn.Conv2d, x: torch.Tensor):
    """Two same-geometry convs over the same input as one double-width conv
    in their compute dtype; returns the two outputs as channel-slice views
    of it (one ``split``, whose backward concatenates the halves'
    gradients in their layout). Under a ``spatial`` context the input band
    takes its halo once for both (``Conv2d.forward``'s rule)."""
    dt = conv_a.compute_dtype
    w = torch.cat([conv_a.weight, conv_b.weight], 0).to(dt)
    b = torch.cat([conv_a.bias, conv_b.bias], 0).to(dt)
    x, pad = x.to(dt), conv_a.padding
    if conv_a.spatial is not None:
        x = halo(x, *conv_a.halo_rows(), conv_a.spatial)
        pad = (0, pad[1])
    y = F.conv2d(x, w, b, padding=pad)
    return y.split(conv_a.out_channels, 1)


class FlowHead(nn.Module):
    """2-layer conv head -> delta flow (update.py:6-14)."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = conv(input_dim, hidden_dim, 3, 1, 1)
        self.conv2 = conv(hidden_dim, 2, 3, 1, 1)
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """Full 3x3 ConvGRU (update.py:16-31), plain elementwise tails."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = conv(cin, hidden_dim, 3, 1, 1)
        self.convr = conv(cin, hidden_dim, 3, 1, 1)
        self.convq = conv(cin, hidden_dim, 3, 1, 1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        zl, rl = _pair_conv(self.convz, self.convr, torch.cat([h, x], 1))
        z, rh = gru_gates_plain(zl, rl, h)
        return gru_blend_plain(z, h, self.convq(torch.cat([rh, x], 1)))


class SepConvGRU(nn.Module):
    """Separable 1x5 + 5x1 ConvGRU (update.py:33-60).

    ``fused=True`` (``gru_impl="fused"``) runs each half's tails through the
    gate and blend kernels, as the JAX ``FusedSepConvGRU`` does; otherwise
    through their plain versions.
    """

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128,
                 fused: bool = False):
        super().__init__()
        cin = hidden_dim + input_dim
        self.fused = fused
        self.convz1 = conv(cin, hidden_dim, (1, 5), 1, (0, 2))
        self.convr1 = conv(cin, hidden_dim, (1, 5), 1, (0, 2))
        self.convq1 = conv(cin, hidden_dim, (1, 5), 1, (0, 2))
        self.convz2 = conv(cin, hidden_dim, (5, 1), 1, (2, 0))
        self.convr2 = conv(cin, hidden_dim, (5, 1), 1, (2, 0))
        self.convq2 = conv(cin, hidden_dim, (5, 1), 1, (2, 0))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gates, blend = ((gru_gates, gru_blend) if self.fused
                        else (gru_gates_plain, gru_blend_plain))
        for convz, convr, convq in ((self.convz1, self.convr1, self.convq1),
                                    (self.convz2, self.convr2, self.convq2)):
            zl, rl = _pair_conv(convz, convr, torch.cat([h, x], 1))
            z, rh = gates(zl, rl, h)
            h = blend(z, h, convq(torch.cat([rh, x], 1)))
        return h


class SmallMotionEncoder(nn.Module):
    """corr+flow -> 80+2 ch motion features (update.py:62-77)."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = conv(corr_planes, 96, 1, 1, 0)
        self.convf1 = conv(2, 64, 7, 1, 3)
        self.convf2 = conv(64, 32, 3, 1, 1)
        self.conv = conv(128, 80, 3, 1, 1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class BasicMotionEncoder(nn.Module):
    """corr+flow -> 126+2 ch motion features (update.py:79-97)."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = conv(corr_planes, 256, 1, 1, 0)
        self.convc2 = conv(256, 192, 3, 1, 1)
        self.convf1 = conv(2, 128, 7, 1, 3)
        self.convf2 = conv(128, 64, 3, 1, 1)
        self.conv = conv(64 + 192, 128 - 2, 3, 1, 1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class SmallUpdateBlock(nn.Module):
    """Motion encoder + ConvGRU + flow head; no mask head (update.py:99-112),
    so ``mask`` changes nothing."""

    def __init__(self, corr_planes: int, hidden_dim: int = 96):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_planes)
        self.gru = ConvGRU(hidden_dim, input_dim=82 + 64)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow, mask: bool = True):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, None, self.flow_head(net)


class BasicUpdateBlock(nn.Module):
    """Motion encoder + SepConvGRU + flow head + mask head (update.py:114-136)."""

    def __init__(self, corr_planes: int, hidden_dim: int = 128,
                 fused: bool = False):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, input_dim=128 + hidden_dim,
                              fused=fused)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(conv(hidden_dim, 256, 3, 1, 1), nn.ReLU(),
                                  conv(256, 64 * 9, 1, 1, 0))

    def forward(self, net, inp, corr, flow, mask: bool = True):
        """``mask=False`` skips the mask head and returns None for the mask
        (a test-mode step whose mask nothing reads)."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        delta = self.flow_head(net)
        # .25 scale to balance gradients (update.py:134-135)
        return net, 0.25 * self.mask(net) if mask else None, delta


class GMAUpdateBlock(nn.Module):
    """GMA's update block (zacjiang/GMA ``core/update.py``
    ``GMAUpdateBlock``): the basic block with the motion features'
    aggregate over the attention, ``g``, as a third part of the GRU's
    input (``[inp, motion, g]``, 384 channels, so each gate conv takes
    512); the gate and blend tails keep their 128 channels."""

    def __init__(self, corr_planes: int, hidden_dim: int = 128,
                 fused: bool = False, heads: int = 1):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, input_dim=128 + 2 * hidden_dim,
                              fused=fused)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(conv(hidden_dim, 256, 3, 1, 1), nn.ReLU(),
                                  conv(256, 64 * 9, 1, 1, 0))
        self.aggregator = Aggregate(128, heads, 128)

    def forward(self, net, inp, corr, flow, attn, mask: bool = True):
        motion = self.encoder(flow, corr)
        glob = self.aggregator(attn, motion)
        net = self.gru(net, torch.cat([inp, motion, glob], 1))
        delta = self.flow_head(net)
        return net, 0.25 * self.mask(net) if mask else None, delta
