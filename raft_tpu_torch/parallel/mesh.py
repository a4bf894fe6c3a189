"""The device mesh of a data-parallel run, port of
``raft_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with two
axes, ``data`` (the batch, split across devices; XLA inserts the gradient
sum) and ``spatial`` (image height, with conv halo exchanges and a
query-sharded correlation volume). Here each process drives one device, so
the mesh is the ``torch.distributed`` processes laid out as ``(data,
spatial)``: rank ``r`` sits at ``(r // spatial, r % spatial)``. A
:class:`Mesh` carries the JAX names the partitioner reads (``axis_names``,
``shape`` as a mapping, ``devices`` as a ``(data, spatial)`` array of
device names), this rank's coordinates and device, the process group of
its ``data`` axis and that of its ``spatial`` axis.

The ``spatial`` axis cuts the image height: the ranks of one ``spatial``
group hold the bands of the same images (:meth:`Mesh.band`), their convs
exchange halos and their norms sum statistics over the group, and fmap2
is gathered whole so each rank holds its band's queries of the volume
(``parallel.halo``, ``models.layers.set_spatial``). The train step then
sums gradients and batch-norm statistics over every rank of the mesh
(:attr:`Mesh.world_group`).

Engines that serve side by side (a primary and its replicas, each on its
own scheduler lane) must not share process groups: gloo requires every
rank to issue a group's collectives in one order, and two lanes'
dispatches interleave. :meth:`Mesh.sibling` gives a replica the same
layout over groups of its own. Every mesh over more than one rank also
carries the run's control group (:attr:`Mesh.control_group`, gloo, CPU
tensors): the channel over which follower ranks receive the primary's
engine calls (``parallel.follow``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch.parallel import distributed
from raft_tpu_torch.parallel.halo import Spatial

# The JAX package found XLA's in-loop conv halo exchange wrong when a
# shard holds no more feature rows (H/8) than the largest halo inside the
# refinement loop: the 7x7 motion-encoder conv, halo 3. The port keeps the
# fence, so a layout the reference refuses is refused here too.
MAX_FEATURE_HALO = 3

#: logical value -> mesh axis per dim (None = unsharded), the JAX
#: package's one table: ``frames`` (B, H, W, 3) batch over 'data', height
#: over 'spatial'; ``flow_init``/``flow`` the same; ``valid`` (B, H, W);
#: ``weights`` replicated on every device
PARTITION_RULES = {
    "frames": ("data", "spatial", None, None),
    "flow_init": ("data", "spatial", None, None),
    "flow": ("data", "spatial", None, None),
    "valid": ("data", "spatial", None),
    "weights": (),
}


class Mesh:
    """The ``(data, spatial)`` layout of the run's processes, from this
    rank's side."""

    axis_names = ("data", "spatial")

    def __init__(self, devices: np.ndarray, rank: int, device: torch.device,
                 group=None, spatial_group=None, world=None, control=None):
        data, spatial = devices.shape
        #: device names, one per rank, shaped (data, spatial)
        self.devices = devices
        self.shape: Dict[str, int] = {"data": int(data),
                                      "spatial": int(spatial)}
        self.rank = int(rank)
        #: this rank's (data, spatial) coordinates
        self.coords = divmod(self.rank, int(spatial))
        self.device = torch.device(device)
        #: the process group of this rank's 'data' axis (None when the
        #: axis is one device wide: nothing to sum over)
        self.group = group
        #: the process group of this rank's 'spatial' axis: the ranks
        #: holding the other bands of its images (None when one wide)
        self.spatial_group = spatial_group
        #: the group of every rank of the mesh, when it is not the default
        #: group (a sibling's; see :attr:`world_group`)
        self._world = world
        #: every rank of the run, gloo whatever the data backend is: the
        #: follower ranks' op channel (None on one rank)
        self.control_group = control

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def world_group(self):
        """The group of every rank of the mesh (None on one device): the
        train step's gradient and batch-norm sums, the serving engine's
        output gather."""
        if self.size == 1:
            return None
        if self._world is not None:
            return self._world
        import torch.distributed as tdist

        return tdist.group.WORLD

    def sibling(self) -> "Mesh":
        """The same layout and coordinates over process groups of its own
        (its world, its ``data`` and ``spatial`` axes; the control group
        is shared): a replica's mesh, so its collectives never interleave
        with this mesh's on one group. A mesh of more than one rank; every
        rank must call it, in one order, as :func:`make_mesh`."""
        world, group, spatial_group = _make_groups(
            self.shape["data"], self.shape["spatial"], self.rank, True)
        return Mesh(self.devices, self.rank, self.device, group,
                    spatial_group, world, self.control_group)

    def band(self, image_h: int) -> Dict[str, int]:
        """This rank's rows of ``image_h``-high images (the whole height
        on a one-wide ``spatial`` axis): first row and row count at image
        resolution (``start``, ``rows``) and at 1/8 (``start8``,
        ``rows8``)."""
        spatial = self.shape["spatial"]
        rows = image_h // spatial
        s = self.coords[1]
        return {"start": s * rows, "rows": rows,
                "start8": s * (rows // 8), "rows8": rows // 8}

    def spatial_context(self) -> Optional[Spatial]:
        """The ``spatial`` axis as the model's layers take it
        (``models.layers.set_spatial``); None when one wide."""
        if self.shape["spatial"] == 1:
            return None
        return Spatial(self.spatial_group, self.coords[1],
                       self.shape["spatial"])

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, "
                f"spatial={self.shape['spatial']}, rank={self.rank}, "
                f"device={self.device})")


def validate_spatial_extent(image_h: int, mesh: Mesh) -> None:
    """Refuse a ``spatial`` layout of ``image_h``-high images the JAX
    package refuses: feature rows (H/8) that the axis does not divide, or
    a shard of no more than :data:`MAX_FEATURE_HALO` of them."""
    spatial = mesh.shape.get("spatial", 1)
    if spatial <= 1:
        return
    h_feat = image_h // 8
    if h_feat % spatial != 0:
        raise ValueError(
            f"spatial={spatial} does not evenly divide the feature height "
            f"{h_feat} (= H{image_h}//8); pick H with H/8 divisible by the "
            "'spatial' axis.")
    if (h_feat // spatial) <= MAX_FEATURE_HALO:
        raise ValueError(
            f"spatial={spatial} sharding of H={image_h} images gives "
            f"{h_feat // spatial} feature rows per shard; the update "
            f"block's 7x7 conv (halo {MAX_FEATURE_HALO}) needs > "
            f"{MAX_FEATURE_HALO} rows per shard — use taller images or a "
            "smaller 'spatial' axis.")


def make_mesh(n_devices: Optional[int] = None, spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of ``(data = n / spatial, spatial)`` over every process
    of the run. ``devices``: each rank's device in rank order (one a
    process); None gathers every rank's ``distributed.local_device()``
    (one collective). ``n_devices`` must be the world size: a process
    drives one device, and a mesh over some of them would need ranks
    that take no part."""
    world = distributed.world_size()
    if devices is None:
        devices = distributed.gather_devices(distributed.local_device())
    n = len(devices) if n_devices is None else int(n_devices)
    if n != world or len(devices) != world:
        raise ValueError(f"a mesh of {n} devices ({len(devices)} named) in "
                         f"a run of {world} processes: one device a process")
    if spatial < 1 or n % spatial:
        raise ValueError(f"spatial={spatial} does not divide {n} devices")
    grid = np.asarray([str(d) for d in devices], dtype=object).reshape(
        n // spatial, spatial)
    rank = distributed.rank()
    groups, control = (None, None, None), None
    if n > 1:
        import torch.distributed as tdist

        groups = _make_groups(n // spatial, spatial, rank, False)
        control = tdist.new_group(backend="gloo")
    whole, group, spatial_group = groups
    return Mesh(grid, rank, torch.device(grid.reshape(-1)[rank]), group,
                spatial_group, whole, control)


def _make_groups(data: int, spatial: int, rank: int, fresh: bool):
    """``(world, data group, spatial group)`` of ``rank`` on a ``(data,
    spatial)`` mesh of more than one rank; every rank creates every
    group, in one order. ``fresh``: new groups throughout, where
    :func:`make_mesh` takes the default group for an axis (or the world)
    that spans every rank (world None: the default group)."""
    import torch.distributed as tdist

    world = group = spatial_group = None
    if fresh:
        world = tdist.new_group(list(range(data * spatial)))
    if data > 1:
        if spatial == 1:
            group = world if fresh else tdist.group.WORLD
        else:
            for s in range(spatial):
                g = tdist.new_group([d * spatial + s for d in range(data)])
                if s == rank % spatial:
                    group = g
    if spatial > 1:
        if data == 1:
            spatial_group = world if fresh else tdist.group.WORLD
        else:
            for d in range(data):
                g = tdist.new_group([d * spatial + s for s in range(spatial)])
                if d == rank // spatial:
                    spatial_group = g
    return world, group, spatial_group


def validate_batch_extent(batch: dict, mesh: Mesh) -> None:
    """The spatial fence on a batch dict: the first image entry's height
    decides (all 4-d entries share H). One definition for every batch
    path (:func:`shard_batch`, ``distributed.host_local_batch``)."""
    for v in batch.values():
        if v.ndim == 4:
            validate_spatial_extent(v.shape[1], mesh)
            break


def _to_device(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(device, non_blocking=True)


def block(name: str, v, mesh: Mesh, coords=None):
    """This rank's block of a global value with a batch dim and a height
    dim (``(B, H, ...)``, the ``("data", "spatial", ...)`` kinds of
    :data:`PARTITION_RULES`): its rows of the ``data`` axis and its band
    of the ``spatial`` axis; a view, numpy or tensor. ``coords``: another
    rank's ``(data, spatial)`` coordinates, whose block is cut instead.
    ``name`` is for the error a dim the axis does not divide raises."""
    coords = mesh.coords if coords is None else coords
    for dim, axis in enumerate(("data", "spatial")):
        n = mesh.shape[axis]
        if n == 1:
            continue
        per, rem = divmod(v.shape[dim], n)
        if rem:
            what = "a batch" if dim == 0 else "a height"
            raise ValueError(f"{name}: {what} of {v.shape[dim]} does not "
                             f"split over {axis}={n}")
        start = coords[dim] * per
        v = v[start:start + per] if dim == 0 else v[:, start:start + per]
    return v


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """A global batch dict as this rank's share on its device: every
    entry with a batch and a height dim (3-d and 4-d, the ``("data",
    "spatial", ...)`` kinds of :data:`PARTITION_RULES`) cut to this rank's
    rows of the ``data`` axis and its band of the ``spatial`` axis
    (:func:`block`), after the extent fence; the rest moved whole. On a
    one-device mesh, a move."""
    validate_batch_extent(batch, mesh)
    return {k: _to_device(block(k, v, mesh) if v.ndim in (3, 4) else v,
                          mesh.device)
            for k, v in batch.items()}
