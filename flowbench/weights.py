"""Seeded weights with the published initialisation, made on the device.

princeton-vl/RAFT initialises only its encoders by hand (``extractor.py``:
Kaiming-normal convolution kernels, fan-out, ReLU gain; norm scales 1 and
shifts 0); every other convolution, and every convolution bias, keeps
PyTorch's default, uniform in ±1/sqrt(fan-in). The draws come from one
generator on the device, seeded from the run's seed, in two calls (one
normal, one uniform), and are cut and scaled into each tensor. Both the
system under test and the reference load the same state dict.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from flowbench.reference.raft import RAFT


def derive_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream ``tag`` of the run's ``seed``."""
    return int(np.random.SeedSequence([int(seed), tag]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def make_weights(arch: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict (the published code's names) of the configuration's
    ``architecture`` block, drawn from ``seed`` on ``device``."""
    with torch.device("meta"):
        model = RAFT(arch)
    rule = {}            # id(tensor) -> ("normal" | "uniform", scale)
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1]
            fan_in, fan_out = m.in_channels * k, m.out_channels * k
            if name.startswith(("fnet.", "cnet.")):
                rule[id(m.weight)] = ("normal", math.sqrt(2.0 / fan_out))
            else:
                rule[id(m.weight)] = ("uniform", 1.0 / math.sqrt(fan_in))
            rule[id(m.bias)] = ("uniform", 1.0 / math.sqrt(fan_in))
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
            kind, scale = rule[tid]
            o = offset[kind]
            made[tid] = (draws[kind][o:o + t.numel()] * scale).view(t.shape)
            offset[kind] = o + t.numel()
        elif key.endswith("num_batches_tracked"):
            made[tid] = torch.zeros((), dtype=torch.long, device=device)
        elif key.endswith(("running_var", "weight")):
            made[tid] = torch.ones(t.shape, device=device)
        else:            # norm shifts and running means
            made[tid] = torch.zeros(t.shape, device=device)
    return {key: made[id(t)] for key, t in state.items()}
