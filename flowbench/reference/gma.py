"""Plain GMA in PyTorch: the yardstick that decides the GMA cell's
``correct``.

Written from the published model (Jiang, Campbell, Lu, Li and Hartley,
"Learning to Estimate Hidden Motions with Global Motion Aggregation", ICCV
2021, arXiv:2104.02409) and the layout of its public code (zacjiang/GMA
``core/network.py`` ``RAFTGMA``, ``core/gma.py`` ``RelPosEmb``,
``Attention``, ``Aggregate``, ``core/update.py`` ``GMAUpdateBlock``), at
its published settings: content-only attention (``position_only`` and
``position_and_content`` off), ``num_heads`` heads of ``dim_head``
channels. Everything GMA shares with RAFT basic (the encoders, the
correlation pyramid and its lookup, the motion encoder, the SepConvGRU,
the heads and the convex upsampler) is ``flowbench.reference.raft``'s.
NCHW throughout, GMA's own einsums for the attention and the aggregation.
Parameter and buffer names are the published ``state_dict``'s.

It imports nothing but ``torch`` and the RAFT reference: no kernel, no
cache, no batching, no package of the system under test. Its arithmetic
is float32 unless the caller passes ``quantize``, applied to every
convolution's operands, the correlation's features and the attention's
and aggregation's operands (a lower-precision control).
"""

from __future__ import annotations

import torch
from torch import nn

from flowbench.reference.raft import (BasicMotionEncoder, Conv, CorrBlock,
                                      Encoder, FlowHead, Quantize,
                                      SepConvGRU, convex_upsample,
                                      coords_grid, infer)

__all__ = ["GMA", "infer"]


def _q(quantize: Quantize, t: torch.Tensor) -> torch.Tensor:
    return t if quantize is None else quantize(t)


class RelPosEmb(nn.Module):
    """The relative position tables: read only by the positional modes,
    which the published settings leave off."""

    def __init__(self, max_pos_size: int, dim_head: int):
        super().__init__()
        rows = 2 * max_pos_size - 1
        # given a weight, so not drawn here: the state dict brings it
        self.rel_height = nn.Embedding(rows, dim_head,
                                       _weight=torch.zeros(rows, dim_head))
        self.rel_width = nn.Embedding(rows, dim_head,
                                      _weight=torch.zeros(rows, dim_head))
        # on the CPU even under a meta device: arithmetic on meta tensors
        # loads torch's compiler stack, seconds of a run's set-up
        pos = torch.arange(max_pos_size, device="cpu")
        self.register_buffer("rel_ind", pos.view(1, -1) - pos.view(-1, 1)
                             + max_pos_size - 1)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 max_pos_size: int, quantize: Quantize = None):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.quantize = quantize
        self.to_qk = Conv(dim, heads * dim_head * 2, 1, bias=False)
        self.pos_emb = RelPosEmb(max_pos_size, dim_head)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, heads, H·W, H·W)."""
        B, _, H, W = fmap.shape
        q, k = self.to_qk(fmap).chunk(2, dim=1)
        # 'b (h d) x y -> b h x y d'
        q, k = (t.reshape(B, self.heads, -1, H, W).permute(0, 1, 3, 4, 2)
                for t in (q, k))
        q = self.scale * q
        sim = torch.einsum("bhxyd,bhuvd->bhxyuv", _q(self.quantize, q),
                           _q(self.quantize, k))
        sim = sim.reshape(B, self.heads, H * W, H * W)
        return sim.softmax(dim=-1)


class Aggregate(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 quantize: Quantize = None):
        super().__init__()
        self.heads = heads
        self.quantize = quantize
        inner = heads * dim_head
        self.to_v = Conv(dim, inner, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.project = (Conv(inner, dim, 1, bias=False) if dim != inner
                        else None)

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        B, _, H, W = fmap.shape
        v = self.to_v(fmap)
        # 'b (h d) x y -> b h (x y) d'
        v = v.reshape(B, self.heads, -1, H * W).transpose(2, 3)
        out = torch.einsum("bhij,bhjd->bhid", _q(self.quantize, attn),
                           _q(self.quantize, v))
        # 'b h (x y) d -> b (h d) x y'
        out = out.transpose(2, 3).reshape(B, -1, H, W)
        if self.project is not None:
            out = self.project(out)
        return fmap + self.gamma * out


class GMAUpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden: int, heads: int,
                 quantize: Quantize = None):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, 128 + hidden + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(Conv(128, 256, 3, padding=1),
                                  nn.ReLU(inplace=False),
                                  Conv(256, 64 * 9, 1))
        self.aggregator = Aggregate(128, heads, 128, quantize)

    def forward(self, net, inp, corr, flow, attention):
        motion = self.encoder(flow, corr)
        glob = self.aggregator(attention, motion)
        net = self.gru(net, torch.cat([inp, motion, glob], 1))
        # the published code scales the mask by .25 to balance gradients
        return net, 0.25 * self.mask(net), self.flow_head(net)


class GMA(nn.Module):
    """``arch``: a configuration's ``architecture`` block: RAFT basic's
    keys (``hidden_dim``, ``context_dim``, ``fnet_dim``, ``cnet_dim``,
    ``corr_levels``, ``corr_radius``) and GMA's (``gma_heads``,
    ``dim_head``, ``max_pos_size``). ``quantize`` rounds the operands of
    every convolution, of the correlation and of the attention's two
    products (the control); None computes in float32."""

    def __init__(self, arch: dict, quantize: Quantize = None):
        super().__init__()
        if arch["small"]:
            raise ValueError("GMA is built on RAFT basic")
        self.hdim, self.cdim = arch["hidden_dim"], arch["context_dim"]
        self.levels, self.radius = arch["corr_levels"], arch["corr_radius"]
        self.quantize = quantize
        planes = self.levels * (2 * self.radius + 1) ** 2
        heads = arch["gma_heads"]
        self.fnet = Encoder(arch["fnet_dim"], "instance", False)
        self.cnet = Encoder(arch["cnet_dim"], "batch", False)
        self.update_block = GMAUpdateBlock(planes, self.hdim, heads,
                                           quantize)
        self.att = Attention(self.cdim, heads, arch["dim_head"],
                             arch["max_pos_size"], quantize)
        for m in self.modules():
            if isinstance(m, Conv):
                m.quantize = quantize

    def forward(self, image1, image2, iters: int, test_mode: bool = True):
        """Images (B, 3, H, W) in [0, 255], H and W multiples of 8. Test
        mode returns ``(flow_low, flow_up)``; otherwise the list of every
        iteration's upsampled flow (B, 2, H, W)."""
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        B = image1.shape[0]
        fmaps = self.fnet(torch.cat([image1, image2], 0)).float()
        corr_fn = CorrBlock(fmaps[:B], fmaps[B:], self.levels, self.radius,
                            self.quantize)
        net, inp = torch.split(self.cnet(image1), [self.hdim, self.cdim], 1)
        net, inp = torch.tanh(net), torch.relu(inp)
        attention = self.att(inp)
        H8, W8 = image1.shape[2] // 8, image1.shape[3] // 8
        coords0 = coords_grid(B, H8, W8, image1.device)
        coords1 = coords0.clone()
        preds = []
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net, up_mask, delta = self.update_block(net, inp, corr, flow,
                                                    attention)
            coords1 = coords1 + delta
            up = convex_upsample(coords1 - coords0, up_mask)
            if not test_mode:
                preds.append(up)
        if test_mode:
            return coords1 - coords0, up
        return preds
