"""Processes of one data-parallel run, port of
``raft_tpu/parallel/distributed.py``.

The JAX package wires its multi-host runtime with
``jax.distributed.initialize`` and feeds each host its rows of the global
batch. Here one process drives one device, and ``torch.distributed``
joins the processes: ``torchrun --nproc_per_node=N`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``, or a
caller passes the address, the world size and the rank. The backend is
NCCL on the card and gloo for CPU tensors (``backend=`` picks another:
gloo also carries CUDA tensors, which two ranks on one card need, since
NCCL refuses two ranks on one device).

Typical use (the same code in every process):

    from raft_tpu_torch.parallel import distributed as dist
    dist.initialize()                  # a no-op in a lone process
    mesh = make_mesh()                 # every process's device
    rows = dist.process_batch_slice(global_batch)
    batch = dist.host_local_batch(loader_batch_rows, mesh)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.distributed as tdist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` for this process.

    ``coordinator_address``: ``host:port`` (``tcp://`` is added) or an
    init URL (``tcp://...``, ``file://...``); with it, ``num_processes``
    and ``process_id`` are the world size and this process's rank. Without
    arguments, a torchrun environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``) joins through ``env://``; with neither this is a
    no-op and the run is one process (the JAX auto-detect's single host).
    Explicit arguments or a torchrun environment make any failure fatal.
    Already initialized: a no-op. ``backend``: ``"nccl"`` where a card is,
    else ``"gloo"``, unless given."""
    if tdist.is_available() and tdist.is_initialized():
        return
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    if not explicit and not any(os.environ.get(k) for k in _ENV):
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if not explicit:
        tdist.init_process_group(backend, init_method="env://")
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: give coordinator_address, "
                         "num_processes and process_id together")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    tdist.init_process_group(backend, init_method=url,
                             world_size=int(num_processes),
                             rank=int(process_id))


def world_size() -> int:
    """Processes in the run (1 without ``initialize``)."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank (0 without ``initialize``)."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


def local_device(device: Optional[str] = None) -> torch.device:
    """This process's device: ``"cuda"`` without an index is
    ``cuda:<LOCAL_RANK>`` (torchrun's one card a process), any other name
    as given; None is the card where there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def gather_devices(device) -> List[str]:
    """Every rank's device name, in rank order (one collective)."""
    name = str(torch.device(device))
    if world_size() == 1:
        return [name]
    out: List[Optional[str]] = [None] * world_size()
    tdist.all_gather_object(out, name)
    return [str(d) for d in out]


def barrier() -> None:
    """Wait for every rank (nothing in a lone process)."""
    if world_size() > 1:
        tdist.barrier()


def process_batch_slice(global_batch: int) -> slice:
    """Which rows of the global batch this process loads."""
    per = global_batch // world_size()
    start = rank() * per
    return slice(start, start + per)


def host_local_batch(batch: Dict, mesh) -> Dict[str, torch.Tensor]:
    """This process's rows (the ones :func:`process_batch_slice` names)
    on its device, after the extent fence every batch path applies
    (``mesh.validate_batch_extent``). numpy arrays or tensors in, tensors
    out."""
    from raft_tpu_torch.parallel.mesh import _to_device, validate_batch_extent

    validate_batch_extent(batch, mesh)
    return {k: _to_device(v, mesh.device) for k, v in batch.items()}
