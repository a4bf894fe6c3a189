"""The partitioner: the one owner of the sharding decisions, port of
``raft_tpu/parallel/partitioner.py``.

Which value rides which mesh axis (``mesh.PARTITION_RULES``), the grain a
bucket must divide, and when a config needs the mesh-safe encoder path
are decided here for every consumer: the serving engine's ``mesh=``
(``validate_bucket``, ``round_bucket``, ``validate_extent``, and the
store's partition fingerprint over ``declared_specs``) and the trainer
(``mesh_model_config``). The JAX ``sharding`` returns a
``NamedSharding``; here it returns what the port applies to a tensor:
this rank's block of a sharded value (its rows of the ``data`` axis, its
band of the ``spatial`` axis) on its device, or the whole value on its
device for a replicated one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.parallel.mesh import (PARTITION_RULES, Mesh, block,
                                          validate_spatial_extent)


class Partitioner:
    """Sharding decisions for one ``(data, spatial)`` mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.data = mesh.shape.get("data", 1)
        self.spatial = mesh.shape.get("spatial", 1)

    # -- specs ------------------------------------------------------------

    def spec(self, kind: str) -> Tuple[Optional[str], ...]:
        """The axis of each dim of a value of ``kind``."""
        return tuple(PARTITION_RULES[kind])

    def sharding(self, kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
        """What the port does to a value of ``kind``: a sharded value gives
        this rank its block (:meth:`block`) on its device; a replicated one
        goes whole to its device."""
        dev = self.mesh.device
        return lambda t: self.block(kind, t).to(dev)

    def block(self, kind: str, v):
        """This rank's block of a global value of ``kind`` (numpy or
        tensor, a view): its rows of dim 0 over ``data`` and its band of
        dim 1 over ``spatial``, as the kind's spec says; a replicated kind
        whole."""
        if not self.spec(kind):
            return v
        return block(kind, v, self.mesh)

    @property
    def replicated(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return self.sharding("weights")

    # -- geometry ---------------------------------------------------------

    def grain(self) -> Tuple[int, int]:
        """(batch grain, height grain) a bucket must divide: whole
        examples per 'data' shard, whole ÷8 feature rows per 'spatial'
        shard."""
        return self.data, 8 * self.spatial

    def validate_extent(self, image_h: int) -> None:
        """The spatial fence (``mesh.validate_spatial_extent``)."""
        validate_spatial_extent(image_h, self.mesh)

    def validate_bucket(self, shape: Tuple[int, int, int]) -> None:
        """Raise unless a ``(B, H, W)`` bucket divides the mesh grain."""
        b, h, _ = shape
        bg, hg = self.grain()
        if b % bg or h % hg:
            raise ValueError(
                f"bucket {shape} is not mesh-divisible: batch must "
                f"be a multiple of data={bg} and height a "
                f"multiple of 8*spatial={hg}")

    def round_bucket(self, b: int, hp: int) -> Tuple[int, int]:
        """Round a build-on-miss ``(batch, padded height)`` up to the mesh
        grain (the bucket's zero fill and the output crop absorb it)."""
        bg, hg = self.grain()
        return -(-b // bg) * bg, -(-hp // hg) * hg

    # -- declarations -----------------------------------------------------

    def declared_specs(self) -> Tuple[Tuple[str, Tuple[Optional[str], ...]],
                                      ...]:
        """``(value kind, axis names per dim)`` pairs: the spec table the
        store's partition fingerprint hashes."""
        return tuple((k, tuple(v)) for k, v in PARTITION_RULES.items())

    def shard_geometry(self, bucket: Tuple[int, int, int],
                       row_bytes: int = 4,
                       feature_dim: int = 256) -> Tuple[dict, ...]:
        """Derived shard extents of a ``(B, H, W)`` bucket: each entry's
        ``extent`` must divide its mesh ``axis`` or the trailing shard is
        padded (``row_bytes`` per padded element row). The feature grid
        (H/8) is the one a boundary-even bucket can still break: H
        divisible by ``spatial`` does not imply H/8 is. ``feature_dim``
        sizes a feature row's channels (the basic fnet's 256)."""
        b, h, w = bucket
        return (
            {"name": f"batch {b}", "extent": b, "axis": "data",
             "row_bytes": h * w * 3 * row_bytes},
            {"name": f"image-height {h}", "extent": h, "axis": "spatial",
             "row_bytes": b * w * 3 * row_bytes},
            {"name": f"feature-height {h}//8", "extent": h // 8,
             "axis": "spatial",
             "row_bytes": b * (w // 8) * feature_dim * row_bytes},
        )


def mesh_model_config(config, mesh: Mesh):
    """The mesh-safe model config: a ``data`` axis over 1 turns on
    ``split_encode`` (two fnet calls; exact per sample, fnet being
    instance-norm), as the JAX package does; the train step's per-rank
    draws of the encoders' dropout need it (``models.encoders``). A
    one-wide data axis keeps the config as it is."""
    if mesh.shape.get("data", 1) > 1 and not config.split_encode:
        return dataclasses.replace(config, split_encode=True)
    return config
