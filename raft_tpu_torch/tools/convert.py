"""Weights carried across: JAX variables and reference ``.pth`` files into
the port's ``state_dict``.

The port's submodule names are the reference's ``state_dict`` names, so a
reference ``.pth`` loads directly (:func:`load_pth`). JAX variables map
across through :func:`state_dict_from_flax`, this package's own copy of the
key mapping of ``raft_tpu/tools/convert.py`` (lines 34-57) run in reverse:

- conv kernels HWIO -> OIHW (``transpose(3, 2, 0, 1)``),
- norm ``scale`` -> ``weight``, ``batch_stats`` mean/var ->
  ``running_mean``/``running_var``, ``num_batches_tracked`` filled in,
- the stride-2 blocks' downsample norm is written a second time under
  ``downsample.1`` (torch registers the one module under both names,
  extractor.py:44-45,103-104).

:func:`save_pth` writes the port's weights back out in the reference's
format, which ``load_pth`` here and ``raft_tpu.tools.convert.load_pth``
read.

``.msgpack`` files need flax's serialization, which the port may not
import; loading them is queued in ROADMAP.md.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT


def _flax_path_to_torch_key(path: Tuple[str, ...], collection: str) -> str:
    """('fnet','layer1_0','conv1','kernel') -> 'fnet.layer1.0.conv1.weight'."""
    parts = []
    for comp in path[:-1]:
        m = re.fullmatch(r"layer(\d)_(\d)", comp)
        if m:
            parts.append(f"layer{m.group(1)}.{m.group(2)}")
        elif comp == "downsample_conv":
            parts.append("downsample.0")
        elif comp == "mask_conv1":
            parts.append("mask.0")
        elif comp == "mask_conv2":
            parts.append("mask.2")
        elif comp == "norm":
            continue  # flax Norm wrapper level, absent in torch
        else:
            parts.append(comp)
    leaf = path[-1]
    if collection == "batch_stats":
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
    else:
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    return ".".join(parts + [leaf])


def _leaves(tree: Mapping, prefix=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for JAX variables given as nested dicts of
    numpy arrays (``{"params": ..., "batch_stats": ...}``). Works for the
    whole model or any submodule's subtree."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            value = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                value = value.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            sd[_flax_path_to_torch_key(path, collection)] = torch.tensor(
                value)
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(
            0, dtype=torch.long)
    for key in [k for k in sd if k.endswith("downsample.0.weight")]:
        block = key[:-len("downsample.0.weight")]
        # the downsample norm is the bottleneck's norm4, the residual's norm3
        norm = "norm4." if block + "conv3.weight" in sd else "norm3."
        for k in [k for k in sd if k.startswith(block + norm)]:
            sd[block + "downsample.1." + k[len(block + norm):]] = sd[k]
    return sd


def load_pth(path: str, config: RAFTConfig) -> RAFT:
    """A reference ``.pth`` (``module.`` prefixes stripped) loaded into a
    CPU ``RAFT`` with ``strict=True``."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = {k.removeprefix("module."): v for k, v in state_dict.items()}
    model = RAFT(config)
    model.load_state_dict(state_dict, strict=True)
    return model


def save_pth(model: RAFT, path: str) -> None:
    """``model``'s weights as a reference-format ``.pth``: its
    ``state_dict`` (the reference's key names) on the CPU, written to a
    temporary file and renamed into place."""
    state_dict = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state_dict, tmp)
    os.replace(tmp, path)


def load_weights(path: str, config: RAFTConfig) -> RAFT:
    """Weights by file type, as the JAX package's ``load_weights``."""
    if path.endswith(".pth"):
        return load_pth(path, config)
    raise NotImplementedError(
        f"{path}: the port loads reference .pth files; .msgpack loading "
        "needs flax serialization and is queued in ROADMAP.md")
