"""Faults planted in GMA's aggregation, to show that the GMA cell's
``correct`` catches them: each patches the system under test for the
length of a ``with`` block (the CPU tests use them, and
``flowbench.calibrate_gma`` reads their numbers on the card).

- ``gma.transposed``: every step aggregates over the transposed attention,
  ``Aᵀ v`` in place of ``A v`` (a kernel that swaps its row and column
  strides);
- ``gma.gamma0``: every step aggregates with γ = 0, the published
  initialisation, under which GMA is RAFT with a wider GRU input.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("gma.transposed", "gma.gamma0")


@contextlib.contextmanager
def planted(kind: str):
    import raft_tpu_torch.models.gma as gma_mod

    if kind not in KINDS:
        raise ValueError(f"fault {kind!r}: choose one of {KINDS}")
    real = gma_mod.gma_aggregate

    def broken(attn, v, m, gamma):
        if kind == "gma.transposed":
            return real(attn.transpose(1, 2), v, m, gamma)
        return real(attn, v, m, torch.zeros_like(gamma))

    gma_mod.gma_aggregate = broken
    try:
        yield
    finally:
        gma_mod.gma_aggregate = real
