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
read: atomically (a temporary file, fsync'd, then ``os.replace``; the fault
site ``ckpt.msgpack_write`` sits between the two) with a sidecar sha256
manifest (``<path>.sha256``, ``<sha256hex>  <nbytes>``, the
JAX package's format, raft_tpu/tools/convert.py:151-193) that
:func:`load_pth` checks before it unpickles anything.

The JAX trainer's flax ``.msgpack`` files go both ways through the port's
own codec (``tools.msgpack``; flax is not imported): :func:`load_msgpack`
checks the manifest, decodes and maps the tree through
:func:`state_dict_from_flax`; :func:`flax_from_state_dict` is the inverse
(OIHW -> HWIO, ``weight`` -> ``scale``, running statistics into
``batch_stats``, ``num_batches_tracked`` and the ``downsample.1`` copies
dropped), and :func:`save_converted` writes its tree as the JAX package's
``save_converted`` does, which ``raft_tpu.tools.convert.load_converted``
reads. ``python -m raft_tpu_torch.tools.convert in.pth out.msgpack
[--small]`` converts a reference ``.pth``.
"""

from __future__ import annotations

import hashlib
import io
import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.testing import faults
from raft_tpu_torch.tools import msgpack
from raft_tpu_torch.tools.msgpack import CorruptCheckpointError


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


def _torch_key_to_flax_path(key: str) -> Tuple[str, Tuple[str, ...]]:
    """'cnet.layer1.0.norm1.weight' -> ('params', ('cnet', 'layer1_0',
    'norm1', 'norm', 'scale')): :func:`_flax_path_to_torch_key` reversed."""
    parts = key.split(".")
    *mods, leaf = parts
    path = []
    i = 0
    while i < len(mods):
        comp = mods[i]
        nxt = mods[i + 1] if i + 1 < len(mods) else None
        if re.fullmatch(r"layer\d", comp) and nxt is not None:
            path.append(f"{comp}_{nxt}")
            i += 2
            continue
        pair = {("downsample", "0"): "downsample_conv",
                ("mask", "0"): "mask_conv1", ("mask", "2"): "mask_conv2"}
        if (comp, nxt) in pair:
            path.append(pair[comp, nxt])
            i += 2
            continue
        path.append(comp)
        i += 1
    if re.fullmatch(r"norm\d*", path[-1]):
        path.append("norm")      # the flax Norm wrapper's level
        if leaf in ("running_mean", "running_var"):
            return "batch_stats", tuple(path) + (leaf[len("running_"):],)
        return "params", tuple(path) + ({"weight": "scale"}.get(leaf, leaf),)
    return "params", tuple(path) + ({"weight": "kernel"}.get(leaf, leaf),)


def flax_from_state_dict(state_dict: Mapping) -> Dict[str, Dict]:
    """The JAX variable tree (``{"params": ..., "batch_stats": ...}`` of
    nested dicts of fp32 numpy arrays; no ``batch_stats`` without batch
    norms) of a port or reference ``state_dict``: conv kernels OIHW ->
    HWIO, norm ``weight`` -> ``scale``, running statistics -> ``mean`` and
    ``var``; ``num_batches_tracked`` and the ``downsample.1`` copies (the
    same tensors as the block's last norm) dropped. The inverse of
    :func:`state_dict_from_flax`."""
    out: Dict[str, Dict] = {}
    for key in sorted(state_dict):
        k = key.removeprefix("module.")
        if k.endswith("num_batches_tracked") or ".downsample.1." in k:
            continue
        value = state_dict[key]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().float().numpy()
        value = np.asarray(value, dtype=np.float32)
        collection, path = _torch_key_to_flax_path(k)
        if path[-1] == "kernel":
            value = value.transpose(2, 3, 1, 0)              # OIHW -> HWIO
        node = out.setdefault(collection, {})
        for comp in path[:-1]:
            node = node.setdefault(comp, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return out


def manifest_path(path: str) -> str:
    return path + ".sha256"


def _write_atomic(path: str, data: bytes, mode: str = "wb",
                  site: Optional[str] = None) -> None:
    """``data`` under a temporary name, fsync'd, then renamed to ``path``:
    a crash leaves the old file or the new one, never a torn one. ``site``
    names the fault site armed in the window between the two."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if site is not None:
            faults.fault_point(site)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_manifest(path: str, data: bytes) -> None:
    """Atomic sidecar integrity manifest: ``<sha256hex>  <nbytes>``."""
    line = f"{hashlib.sha256(data).hexdigest()}  {len(data)}\n"
    _write_atomic(manifest_path(path), line, "w")


def verify_manifest(path: str, data: bytes) -> None:
    """Raise :class:`CorruptCheckpointError` when ``path``'s sidecar
    manifest mismatches ``data`` (flipped bytes, truncation, or a stale
    manifest from an interrupted save). A missing sidecar passes: reference
    ``.pth`` files have none."""
    try:
        with open(manifest_path(path), encoding="utf-8") as f:
            want_digest, want_size = f.read().split()
    except FileNotFoundError:
        return
    except ValueError as e:
        raise CorruptCheckpointError(
            f"unparsable integrity manifest {manifest_path(path)}: "
            f"{e}") from e
    got = hashlib.sha256(data).hexdigest()
    if got != want_digest or len(data) != int(want_size):
        raise CorruptCheckpointError(
            f"{path} failed its integrity check (manifest "
            f"{want_digest[:12]}…/{want_size}B vs actual "
            f"{got[:12]}…/{len(data)}B): the file is corrupt or torn; "
            "refusing to load it")


def _save_bytes(data: bytes, path: str, site: Optional[str]) -> None:
    """``data`` to ``path`` atomically, then its manifest. ``site`` names a
    fault site: a point in the window before the rename, and a corruption
    of the finished file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write_atomic(path, data, site=site)
    write_manifest(path, data)
    if site is not None:
        faults.fault_file(site, path)


def save_verified(obj, path: str, site: Optional[str] = None) -> None:
    """``torch.save(obj)`` to ``path`` atomically, then its manifest
    (:func:`_save_bytes`)."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    _save_bytes(buf.getvalue(), path, site)


def load_verified(path: str):
    """``torch.load(path, weights_only=True)`` on the CPU after the bytes
    pass their manifest (:func:`verify_manifest`)."""
    with open(path, "rb") as f:
        data = f.read()
    verify_manifest(path, data)
    return torch.load(io.BytesIO(data), map_location="cpu",
                      weights_only=True)


def load_pth(path: str, config: RAFTConfig) -> RAFT:
    """A reference ``.pth`` (``module.`` prefixes stripped) loaded into a
    CPU ``RAFT`` with ``strict=True``, after its manifest where it has
    one. A GMA checkpoint (zacjiang/GMA's names) loads the same way into
    ``config`` with ``gma_heads=1``."""
    state_dict = load_verified(path)
    state_dict = {k.removeprefix("module."): v for k, v in state_dict.items()}
    model = RAFT(config)
    model.load_state_dict(state_dict, strict=True)
    return model


def save_pth(model: RAFT, path: str) -> None:
    """``model``'s weights as a reference-format ``.pth``: its
    ``state_dict`` (the reference's key names) on the CPU, written
    atomically with its sha256 manifest."""
    save_verified({k: v.detach().cpu() for k, v in model.state_dict().items()},
                  path, site="ckpt.msgpack_write")


def save_converted(variables: Mapping, path: str) -> None:
    """A JAX variable tree (:func:`flax_from_state_dict`) as flax
    ``.msgpack`` bytes, written as the JAX package's ``save_converted``
    writes them (raft_tpu/tools/convert.py:193-226): a temporary file,
    fsync'd, the ``ckpt.msgpack_write`` fault site, the atomic rename, the
    sha256 manifest, then the site's corruption of the finished file."""
    _save_bytes(msgpack.packb(variables), path, "ckpt.msgpack_write")


def load_msgpack(path: str, config: RAFTConfig) -> RAFT:
    """A flax ``.msgpack`` (the JAX trainer's weights, or
    :func:`save_converted`'s) loaded into a CPU ``RAFT`` with
    ``strict=True``: the bytes pass their manifest first, then decode
    whole (``tools.msgpack``; :class:`CorruptCheckpointError` otherwise)
    and map through :func:`state_dict_from_flax`."""
    with open(path, "rb") as f:
        data = f.read()
    verify_manifest(path, data)
    tree = msgpack.unpackb(data)
    if not isinstance(tree, dict) or "params" not in tree:
        raise CorruptCheckpointError(
            f"{path} holds no flax variable tree (no 'params')")
    tree = {c: tree[c] for c in ("params", "batch_stats") if c in tree}
    model = RAFT(config)
    model.load_state_dict(state_dict_from_flax(_as_numpy(tree)), strict=True)
    return model


def _as_numpy(tree):
    """Tensor leaves (bfloat16 ones decode as tensors) as fp32 numpy."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def load_weights(path: str, config: RAFTConfig) -> RAFT:
    """Weights by file type, as the JAX package's ``load_weights``: a
    reference ``.pth``, else a flax ``.msgpack``."""
    if path.endswith(".pth"):
        return load_pth(path, config)
    return load_msgpack(path, config)


def main(argv=None) -> None:
    """The convert CLI: a reference ``.pth`` to flax ``.msgpack``
    (raft_tpu/tools/convert.py:242-255)."""
    import argparse

    p = argparse.ArgumentParser(
        description="Convert reference RAFT .pth checkpoints to flax msgpack")
    p.add_argument("input", help="path to .pth file")
    p.add_argument("output", help="path to write .msgpack")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    model = load_pth(args.input, RAFTConfig(small=args.small))
    save_converted(flax_from_state_dict(model.state_dict()), args.output)
    print(f"converted {args.input} -> {args.output}")


if __name__ == "__main__":
    main()
