"""Plain RAFT in PyTorch: the yardstick that decides ``correct``.

Written from the published model (Teed and Deng, "RAFT: Recurrent All-Pairs
Field Transforms for Optical Flow", ECCV 2020, arXiv:2003.12039) and the
layout of its public code (princeton-vl/RAFT ``core/raft.py``,
``extractor.py``, ``update.py``, ``corr.py``, ``utils/utils.py``): NCHW
throughout, the correlation pyramid sampled with ``F.grid_sample``, the
convex upsampler through ``F.unfold``, one ``F.conv2d`` per convolution.
Parameter names are that code's ``state_dict`` names, so one state dict
loads into this model and into the system under test.

It imports nothing but ``torch``: no kernel, no cache, no batching, no
package of the system under test. Its arithmetic is float32 unless the
caller passes ``quantize``, a function applied to every convolution's
input and weight (the lower-precision control of ``flowbench.check``).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

Quantize = Optional[Callable[[torch.Tensor], torch.Tensor]]


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose input and weight pass through ``quantize``."""

    quantize: Quantize = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quantize
        if q is None:
            return super().forward(x)
        return self._conv_forward(q(x), q(self.weight), self.bias)


def _norm(kind: str, planes: int, groups: int) -> nn.Module:
    if kind == "group":
        return nn.GroupNorm(groups, planes)
    if kind == "batch":
        return nn.BatchNorm2d(planes)
    if kind == "instance":
        return nn.InstanceNorm2d(planes)
    return nn.Sequential()


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str, stride: int):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, padding=1, stride=stride)
        self.conv2 = Conv(planes, planes, 3, padding=1)
        self.relu = nn.ReLU()
        g = planes // 8
        self.norm1 = _norm(norm, planes, g)
        self.norm2 = _norm(norm, planes, g)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm, planes, g)
            self.downsample = nn.Sequential(
                Conv(cin, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str, stride: int):
        super().__init__()
        p4, g = planes // 4, planes // 8
        self.conv1 = Conv(cin, p4, 1)
        self.conv2 = Conv(p4, p4, 3, padding=1, stride=stride)
        self.conv3 = Conv(p4, planes, 1)
        self.relu = nn.ReLU()
        self.norm1 = _norm(norm, p4, g)
        self.norm2 = _norm(norm, p4, g)
        self.norm3 = _norm(norm, planes, g)
        self.downsample = None
        if stride != 1:
            self.norm4 = _norm(norm, planes, g)
            self.downsample = nn.Sequential(
                Conv(cin, planes, 1, stride=stride), self.norm4)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        y = self.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class Encoder(nn.Module):
    """The feature and context encoders: a 7x7 stride-2 stem and three
    stages of two blocks (stride 1, 2, 2), then a 1x1 head; total stride 8.
    Basic: residual blocks of 64, 96, 128 channels; small: bottleneck
    blocks of 32, 64, 96."""

    def __init__(self, out_dim: int, norm: str, small: bool):
        super().__init__()
        dims = (32, 32, 64, 96) if small else (64, 64, 96, 128)
        block = BottleneckBlock if small else ResidualBlock
        self.conv1 = Conv(3, dims[0], 7, stride=2, padding=3)
        self.norm1 = _norm(norm, dims[0], 8)
        self.relu1 = nn.ReLU()
        layers, cin = [], dims[0]
        for dim, stride in zip(dims[1:], (1, 2, 2)):
            layers.append(nn.Sequential(block(cin, dim, norm, stride),
                                        block(dim, dim, norm, 1)))
            cin = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = Conv(cin, out_dim, 1)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class FlowHead(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.conv1 = Conv(cin, hidden, 3, padding=1)
        self.conv2 = Conv(hidden, 2, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        self.convz = Conv(hidden + cin, hidden, 3, padding=1)
        self.convr = Conv(hidden + cin, hidden, 3, padding=1)
        self.convq = Conv(hidden + cin, hidden, 3, padding=1)

    def forward(self, h, x):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        c = hidden + cin
        self.convz1 = Conv(c, hidden, (1, 5), padding=(0, 2))
        self.convr1 = Conv(c, hidden, (1, 5), padding=(0, 2))
        self.convq1 = Conv(c, hidden, (1, 5), padding=(0, 2))
        self.convz2 = Conv(c, hidden, (5, 1), padding=(2, 0))
        self.convr2 = Conv(c, hidden, (5, 1), padding=(2, 0))
        self.convq2 = Conv(c, hidden, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        for cz, cr, cq in ((self.convz1, self.convr1, self.convq1),
                           (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(cz(hx))
            r = torch.sigmoid(cr(hx))
            q = torch.tanh(cq(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv(corr_planes, 96, 1)
        self.convf1 = Conv(2, 64, 7, padding=3)
        self.convf2 = Conv(64, 32, 3, padding=1)
        self.conv = Conv(128, 80, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv(corr_planes, 256, 1)
        self.convc2 = Conv(256, 192, 3, padding=1)
        self.convf1 = Conv(2, 128, 7, padding=3)
        self.convf2 = Conv(128, 64, 3, padding=1)
        self.conv = Conv(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class SmallUpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden: int):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_planes)
        self.gru = ConvGRU(hidden, 82 + 64)
        self.flow_head = FlowHead(hidden, 128)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, None, self.flow_head(net)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(Conv(hidden, 256, 3, padding=1),
                                  nn.ReLU(inplace=False),
                                  Conv(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        # the published code scales the mask by .25 to balance gradients
        return net, 0.25 * self.mask(net), self.flow_head(net)


def coords_grid(batch: int, ht: int, wd: int, device) -> torch.Tensor:
    """(B, 2, H, W): channel 0 is x, channel 1 is y."""
    ys, xs = torch.meshgrid(torch.arange(ht, device=device),
                            torch.arange(wd, device=device), indexing="ij")
    return torch.stack([xs, ys]).float()[None].repeat(batch, 1, 1, 1)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (N, C, H, W) at pixel coordinates ``coords`` (N, h, w,
    2), zeros outside, as ``utils.bilinear_sampler``."""
    H, W = img.shape[-2:]
    xg, yg = coords.split([1, 1], dim=-1)
    xg = 2 * xg / (W - 1) - 1
    yg = 2 * yg / (H - 1) - 1
    return F.grid_sample(img, torch.cat([xg, yg], -1), align_corners=True)


class CorrBlock:
    """The all-pairs volume, average-pooled into ``levels`` levels, and the
    (2r+1)² window lookup at each level (``corr.py``'s ``CorrBlock``)."""

    def __init__(self, fmap1, fmap2, levels: int, radius: int,
                 quantize: Quantize = None):
        self.levels, self.radius = levels, radius
        B, C, H, W = fmap1.shape
        f1 = fmap1.reshape(B, C, H * W)
        f2 = fmap2.reshape(B, C, H * W)
        if quantize is not None:
            f1, f2 = quantize(f1), quantize(f2)
        corr = torch.matmul(f1.transpose(1, 2), f2) / math.sqrt(C)
        corr = corr.reshape(B * H * W, 1, H, W)
        self.pyramid: List[torch.Tensor] = [corr]
        for _ in range(levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.pyramid.append(corr)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)
        B, H, W, _ = coords.shape
        d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        # (dy, dx) stacked and added to (x, y): the x offset is the outer
        # index of each window's (2r+1)² channels, as published
        delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)
        delta = delta.view(1, 2 * r + 1, 2 * r + 1, 2)
        out = []
        for i, corr in enumerate(self.pyramid):
            centroid = coords.reshape(B * H * W, 1, 1, 2) / 2 ** i
            sampled = bilinear_sampler(corr, centroid + delta)
            out.append(sampled.view(B, H, W, -1))
        return torch.cat(out, -1).permute(0, 3, 1, 2).contiguous().float()


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    H, W = flow.shape[-2:]
    return 8 * F.interpolate(flow, size=(8 * H, 8 * W), mode="bilinear",
                             align_corners=True)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, 2, H, W) flow, (B, 576, H, W) mask -> (B, 2, 8H, 8W): each fine
    pixel a softmax-weighted combination of its coarse 3x3 neighbourhood."""
    B, _, H, W = flow.shape
    mask = torch.softmax(mask.view(B, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(B, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(B, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    """``arch``: a configuration's ``architecture`` block (``small``,
    ``hidden_dim``, ``context_dim``, ``fnet_dim``, ``cnet_dim``, which
    splits into the hidden and context features, ``corr_levels``,
    ``corr_radius``; the norms and update block follow ``small``, as in
    the published code). ``quantize`` rounds every convolution's operands and
    the correlation's features (the control); None computes in float32."""

    def __init__(self, arch: dict, quantize: Quantize = None):
        super().__init__()
        self.small = bool(arch["small"])
        self.hdim, self.cdim = arch["hidden_dim"], arch["context_dim"]
        self.levels, self.radius = arch["corr_levels"], arch["corr_radius"]
        self.quantize = quantize
        planes = self.levels * (2 * self.radius + 1) ** 2
        if self.small:
            self.fnet = Encoder(arch["fnet_dim"], "instance", True)
            self.cnet = Encoder(arch["cnet_dim"], "none", True)
            self.update_block = SmallUpdateBlock(planes, self.hdim)
        else:
            self.fnet = Encoder(arch["fnet_dim"], "instance", False)
            self.cnet = Encoder(arch["cnet_dim"], "batch", False)
            self.update_block = BasicUpdateBlock(planes, self.hdim)
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
        H8, W8 = image1.shape[2] // 8, image1.shape[3] // 8
        coords0 = coords_grid(B, H8, W8, image1.device)
        coords1 = coords0.clone()
        preds = []
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net, up_mask, delta = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta
            low = coords1 - coords0
            up = (upflow8(low) if up_mask is None
                  else convex_upsample(low, up_mask))
            if not test_mode:
                preds.append(up)
        if test_mode:
            return coords1 - coords0, up
        return preds


def pad_amounts(ht: int, wd: int):
    """(left, right, top, bottom) replicate padding to multiples of 8,
    split evenly on both sides (the published ``InputPadder``'s Sintel
    mode)."""
    ph = (((ht // 8) + 1) * 8 - ht) % 8
    pw = (((wd // 8) + 1) * 8 - wd) % 8
    return pw // 2, pw - pw // 2, ph // 2, ph - ph // 2


@torch.no_grad()
def infer(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
          iters: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, H, W, 2) float32 flow: pad, run
    the test-mode forward, unpad."""
    h, w = image1.shape[1:3]
    left, right, top, bottom = pad_amounts(h, w)
    x1, x2 = (F.pad(x.permute(0, 3, 1, 2).float().contiguous(),
                    (left, right, top, bottom), mode="replicate")
              for x in (image1, image2))
    _, up = model(x1, x2, iters, test_mode=True)
    return up[:, :, top:top + h, left:left + w].permute(0, 2, 3, 1)
