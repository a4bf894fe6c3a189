"""Seeded GMA weights, made on the device under ``flowbench.weights``'s
rules for everything GMA shares with RAFT basic.

princeton-vl/RAFT's initialisation, which GMA keeps: the encoders'
convolution kernels Kaiming-normal (fan-out, ReLU gain), norm scales 1 and
shifts 0; every other convolution and bias PyTorch's default, uniform in
±1/sqrt(fan-in). GMA's own parameters (zacjiang/GMA ``core/gma.py``):

- ``att.to_qk.weight``: PyTorch's default times :data:`QK_GAIN`. At the
  default, the 1080p grid's 32,640 logits of a row are nearly equal and
  the attention nearly uniform, under which a wrong attention (a
  transposed one) is invisible; the gain peaks the rows (the measured
  figure is in ``flowbench/configs/gma.json``).
- ``update_block.aggregator.to_v.weight``: PyTorch's default.
- ``update_block.aggregator.gamma``: published at 0, which switches the
  aggregation off; drawn from the seed, uniform in :data:`GAMMA`, where
  ``γ·A v`` is comparable to the motion features it is added to.
- ``att.pos_emb.rel_height`` and ``rel_width``: N(0, 1), ``nn.Embedding``'s
  default (unread under content-only attention); ``rel_ind`` as the
  published buffer holds it.

The draws come from one generator on the device, seeded from the run's
seed, in two calls (one normal, one uniform), cut and scaled into each
tensor, as ``flowbench.weights`` draws RAFT's. The system under test and
the reference load the same state dict.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from flowbench.reference.gma import GMA
from flowbench.weights import derive_seed

#: ``att.to_qk``'s kernel, in units of PyTorch's default bound 1/sqrt(fan-in)
QK_GAIN = 12.0
#: the interval γ is drawn from
GAMMA = (0.5, 1.5)


def make_weights(arch: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict (the published code's names) of the configuration's
    ``architecture`` block, drawn from ``seed`` on ``device``."""
    with torch.device("meta"):
        model = GMA(arch)
    rule = {}       # id(tensor) -> ("normal" | "uniform", scale, offset)
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1]
            fan_in, fan_out = m.in_channels * k, m.out_channels * k
            if name.startswith(("fnet.", "cnet.")):
                rule[id(m.weight)] = ("normal", math.sqrt(2.0 / fan_out), 0.0)
            else:
                gain = QK_GAIN if name == "att.to_qk" else 1.0
                rule[id(m.weight)] = ("uniform", gain / math.sqrt(fan_in),
                                      0.0)
            if m.bias is not None:
                rule[id(m.bias)] = ("uniform", 1.0 / math.sqrt(fan_in), 0.0)
        elif isinstance(m, nn.Embedding):
            rule[id(m.weight)] = ("normal", 1.0, 0.0)
    gamma = model.update_block.aggregator.gamma
    rule[id(gamma)] = ("uniform", (GAMMA[1] - GAMMA[0]) / 2,
                       (GAMMA[1] + GAMMA[0]) / 2)
    state = model.state_dict(keep_vars=True)
    unique = {}
    for key, t in state.items():
        unique.setdefault(id(t), (key, t))
    sizes = {"normal": 0, "uniform": 0}
    for tid, (_, t) in unique.items():
        if tid in rule:
            sizes[rule[tid][0]] += t.numel()
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 1))
    draws = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device) * 2.0 - 1.0}
    offset = {"normal": 0, "uniform": 0}
    made = {}
    for tid, (key, t) in unique.items():
        if tid in rule:
            kind, scale, shift = rule[tid]
            o = offset[kind]
            made[tid] = (draws[kind][o:o + t.numel()] * scale
                         + shift).view(t.shape)
            offset[kind] = o + t.numel()
        elif key.endswith("num_batches_tracked"):
            made[tid] = torch.zeros((), dtype=torch.long, device=device)
        elif key.endswith("rel_ind"):
            made[tid] = _relative_index(t.shape[0], device)
        elif key.endswith(("running_var", "weight")):
            made[tid] = torch.ones(t.shape, device=device)
        else:            # norm shifts and running means
            made[tid] = torch.zeros(t.shape, device=device)
    return {key: made[id(t)] for key, t in state.items()}


def _relative_index(size: int, device) -> torch.Tensor:
    pos = torch.arange(size, device=device)
    return pos.view(1, -1) - pos.view(-1, 1) + size - 1
