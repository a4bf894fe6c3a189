"""Building-block layers, port of ``raft_tpu/models/layers.py``.

Tensors are (B, C, H, W) in PyTorch's convention, in the memory layout of
the module that holds the layer (channels-last, or NCHW in an encoder
whose instance or group norm normalises NCHW copies: ``models.encoders``);
the layers keep whatever layout PyTorch's ops propagate.

Submodule names are the reference's ``state_dict`` names
(``core/extractor.py:6-116``), so a reference ``.pth`` loads with
``strict=True``: the stride-2 blocks register their last norm twice, as
``normN`` and as ``downsample.1``, exactly as the reference does.

Norm parity notes (torch defaults the reference relies on):
- instance: ``nn.InstanceNorm2d`` — no affine, no running stats, biased
  variance, eps 1e-5.
- batch: eps 1e-5, with flax's semantics (``raft_tpu/models/layers.py``'s
  ``nn.BatchNorm(momentum=0.9)``), see :class:`BatchNorm2d`.
- group: affine, eps 1e-5, ``num_groups = planes // 8`` except where the
  reference says otherwise (the stem's 8 groups, the bottleneck's
  ``planes // 8`` on its ``planes // 4``-channel norms).

Every block's ``forward(x, use_running_average=True)`` hands the switch to
its batch norms (the JAX model's ``use_running_average``: ``True`` in test
mode and under ``freeze_bn``, ``False`` when training them).

Mixed precision follows the JAX layers' casts: each :class:`Conv2d` casts
its input, kernel and bias to its ``compute_dtype`` (bf16 under
``mixed_precision``; the parameters stay fp32), the batch and group norms
compute in fp32 and return fp32, and the instance norm computes in fp32
and returns its input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from raft_tpu_torch.parallel.halo import all_sum, conv_halo, halo

#: flax ``BatchNorm(momentum=0.9)``: new = 0.9·running + 0.1·batch
BN_MOMENTUM = 0.9


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d``'s parameters and buffers with flax's semantics.

    ``use_running_average=True`` normalizes with the running statistics
    whatever the module's ``training`` flag. ``False`` normalizes with the
    batch's mean and BIASED variance (gradients flow through both) and
    updates the buffers as flax does: ``running = 0.9·running + 0.1·batch``
    for the mean and for the biased variance. ``nn.BatchNorm2d`` in train
    mode would update the variance with the unbiased one.

    With a ``process_group`` (:func:`set_process_group`: the ``data`` axis
    of a data-parallel run), the batch is the GLOBAL one, as XLA computes
    it for the sharded JAX step: one all-reduce of (Σx, Σx², count) per
    call gives the mean and the biased variance E[x²]−E[x]², and its
    adjoint sums the cotangents across the ranks in the backward
    (``nn.SyncBatchNorm`` would update the variance with the unbiased
    one). Without one, the statistics are the local batch's.
    """

    #: the process group the statistics are summed over (None: this
    #: process's batch alone)
    process_group = None

    def forward(self, x: torch.Tensor,
                use_running_average: bool = True) -> torch.Tensor:
        if use_running_average:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.process_group is not None:
            return self._global_batch(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
            self._update_running(mean, var)
        return out

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
            buf.copy_(BN_MOMENTUM * buf + (1.0 - BN_MOMENTUM) * stat)
        self.num_batches_tracked += 1

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        n = x.new_full((1,), float(x.numel() // c))
        stats = all_sum(
            torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)), n]),
            self.process_group)
        mean = stats[:c] / stats[-1]
        var = (stats[c:2 * c] / stats[-1] - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self._update_running(mean, var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def apply_norm(norm: nn.Module, x: torch.Tensor,
               use_running_average: bool) -> torch.Tensor:
    """``norm(x)``, handing the switch to a batch norm (the other norms
    have no running statistics), in the JAX layers' dtypes: batch and group
    norms fp32 out, instance norm in fp32 and back to ``x``'s dtype."""
    if isinstance(norm, BatchNorm2d):
        return norm(x.float(), use_running_average)
    sp = getattr(norm, "spatial", None)
    if isinstance(norm, nn.GroupNorm):
        if sp is not None:
            return _group_norm_band(norm, x.float(), sp)
        return norm(x.float())
    if isinstance(norm, nn.InstanceNorm2d):
        if sp is not None:
            return _band_normalize(x.float().unsqueeze(2), norm.eps,
                                   sp).squeeze(2).to(x.dtype)
        return norm(x.float()).to(x.dtype)
    return norm(x)


def _band_normalize(x: torch.Tensor, eps: float, sp) -> torch.Tensor:
    """``(x − mean) / sqrt(var + eps)`` per (sample, group) of ``x`` (B, G,
    C/G, h, W), the statistics over every band of the ``spatial`` group
    (biased variance). Two passes, each one all-reduce: the mean, then the
    mean square deviation from it (E[x²]−E[x]² loses digits the
    recurrence amplifies)."""
    dims = (2, 3, 4)
    n = x[0, 0].numel() * sp.size
    mean = all_sum(x.sum(dims, keepdim=True), sp.group) / n
    d = x - mean
    var = all_sum((d * d).sum(dims, keepdim=True), sp.group) / n
    return d * torch.rsqrt(var + eps)


def _group_norm_band(norm: nn.GroupNorm, x: torch.Tensor,
                     sp) -> torch.Tensor:
    """``nn.GroupNorm`` over a band, its statistics over the whole image."""
    B, C, h, W = x.shape
    y = _band_normalize(x.reshape(B, norm.num_groups, -1, h, W), norm.eps,
                        sp).reshape(B, C, h, W)
    return y * norm.weight[:, None, None] + norm.bias[:, None, None]


def norm_layer(norm_fn: str, features: int,
               num_groups: Optional[int] = None) -> nn.Module:
    """The reference's four norm options (``extractor.py:16-38``)."""
    if norm_fn == "group":
        groups = num_groups if num_groups else features // 8
        return nn.GroupNorm(groups, features, eps=1e-5)
    if norm_fn == "batch":
        return BatchNorm2d(features, eps=1e-5)
    if norm_fn == "instance":
        return nn.InstanceNorm2d(features, eps=1e-5)
    if norm_fn == "none":
        return nn.Sequential()
    raise ValueError(f"norm_fn={norm_fn!r}: choose group, batch, instance "
                     "or none")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (the JAX ``TorchConv``'s
    ``dtype``): input, kernel and bias cast to it, fp32 parameters kept.

    Under a ``spatial`` context (:func:`set_spatial`) the input is a band
    of the image's rows: the conv takes the rows of the bands above and
    below that its kernel, stride and padding read (:meth:`halo_rows`,
    zeros past the image's edges) and pads only the width."""

    compute_dtype = torch.float32
    #: the ``spatial`` axis this conv's input is a band of (None: whole)
    spatial = None

    def halo_rows(self):
        """Rows above and below a band that this conv reads."""
        return conv_halo(self.kernel_size[0], self.stride[0],
                         self.padding[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.spatial is None:
            return self._conv_forward(x.to(dt), self.weight.to(dt), bias)
        return F.conv2d(halo(x.to(dt), *self.halo_rows(), self.spatial),
                        self.weight.to(dt), bias, self.stride,
                        (0, self.padding[1]), self.dilation, self.groups)


def set_process_group(module: nn.Module, group) -> None:
    """Every :class:`BatchNorm2d` under ``module`` takes its training
    statistics over the ranks of ``group`` (None: its own batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group


def set_spatial(module: nn.Module, sp) -> None:
    """Every layer under ``module`` that reads across rows (the convs, the
    instance and group norms, and a model's own ops: ``RAFT.spatial``)
    takes its input as a band of the ``spatial`` axis ``sp``
    (``parallel.halo.Spatial``); None: whole images, the layers' own code
    bit for bit. Batch norms take their group from
    :func:`set_process_group`."""
    for m in module.modules():
        if isinstance(m, (nn.InstanceNorm2d, nn.GroupNorm)) \
                or hasattr(type(m), "spatial"):
            m.spatial = sp


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every :class:`Conv2d` under ``module`` computes in ``dtype``."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = dtype


def conv(cin: int, cout: int, kernel, stride=1, padding=0,
         bias: bool = True) -> Conv2d:
    """torch ``Conv2d``: symmetric padding, as the JAX ``TorchConv`` mimics."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                  bias=bias)


class ResidualBlock(nn.Module):
    """Two 3x3 convs + skip (extractor.py:6-56)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride, 1)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.relu = nn.ReLU()
        self.norm1 = norm_layer(norm_fn, planes)
        self.norm2 = norm_layer(norm_fn, planes)
        if stride == 1:
            self.downsample = None
        else:
            self.norm3 = norm_layer(norm_fn, planes)
            self.downsample = nn.Sequential(
                conv(in_planes, planes, 1, stride, 0), self.norm3)

    def forward(self, x: torch.Tensor,
                use_running_average: bool = True) -> torch.Tensor:
        ura = use_running_average
        y = self.relu(apply_norm(self.norm1, self.conv1(x), ura))
        y = self.relu(apply_norm(self.norm2, self.conv2(y), ura))
        if self.downsample is not None:
            x = apply_norm(self.norm3, self.downsample[0](x), ura)
        return self.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck + skip (extractor.py:60-116)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        p4 = planes // 4
        # the reference's num_groups = planes // 8 for ALL norms in the
        # block, including the planes//4-channel ones (extractor.py:69-74)
        g = planes // 8
        self.conv1 = conv(in_planes, p4, 1, 1, 0)
        self.conv2 = conv(p4, p4, 3, stride, 1)
        self.conv3 = conv(p4, planes, 1, 1, 0)
        self.relu = nn.ReLU()
        self.norm1 = norm_layer(norm_fn, p4, g)
        self.norm2 = norm_layer(norm_fn, p4, g)
        self.norm3 = norm_layer(norm_fn, planes, g)
        if stride == 1:
            self.downsample = None
        else:
            self.norm4 = norm_layer(norm_fn, planes, g)
            self.downsample = nn.Sequential(
                conv(in_planes, planes, 1, stride, 0), self.norm4)

    def forward(self, x: torch.Tensor,
                use_running_average: bool = True) -> torch.Tensor:
        ura = use_running_average
        y = self.relu(apply_norm(self.norm1, self.conv1(x), ura))
        y = self.relu(apply_norm(self.norm2, self.conv2(y), ura))
        y = self.relu(apply_norm(self.norm3, self.conv3(y), ura))
        if self.downsample is not None:
            x = apply_norm(self.norm4, self.downsample[0](x), ura)
        return self.relu(x + y)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init, drawn from ``generator``: conv kernels
    Kaiming-normal (fan_out, relu; extractor.py:150-157), conv biases
    U(±1/sqrt(fan_in)) as torch's ``Conv2d`` default, norm scales 1 and
    shifts 0, running statistics (0, 1)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            if m.bias is not None:
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
