"""Hand-written CUDA kernels for Hopper, the successors of the JAX
package's Pallas TPU kernels, and the kernels of GMA's attention
(``kernels.gma``: K6, K7), which have no TPU predecessor.

CUDA sources live in ``raft_tpu_torch/csrc/`` and are built at first use
by ``kernels._build`` (nothing is built or imported from a GPU toolchain
when this package is imported). Each wrapper counts its launches in its
module's ``launches`` dict of plain integers; :func:`launch_counts` reads
them, :func:`launch_dtypes` the same counts by operand dtype,
:func:`launch_layouts` the GRU kernels' by operand layout, and
:func:`reset_launch_counts` sets all three to 0.

Importing this package also registers the serving forward kernels as
``torch.library`` operators in the namespace ``raft_tpu_torch``
(``corr_lookup``, ``gru_gates``, ``gru_blend``, ``alt_corr_lookup``,
``gma_attention``, ``gma_aggregate``), each
with a fake implementation for tracing: a program that ``torch.export``
traced through the wrappers holds them, and a process that loads it
imports this package first.
"""

from raft_tpu_torch.kernels import _build, corr_alt, corr_lookup, gma, gru
from raft_tpu_torch.kernels.corr_alt import (  # noqa: F401
    AltCorrLookup, alt_corr_lookup_cuda)
from raft_tpu_torch.kernels.corr_lookup import (  # noqa: F401
    CorrLookup, corr_lookup_bwd_plain, corr_lookup_cuda, corr_scatter_cuda)
from raft_tpu_torch.kernels.gma import (  # noqa: F401
    gma_aggregate, gma_aggregate_plain, gma_attention, gma_attention_plain)
from raft_tpu_torch.kernels.gru import (  # noqa: F401
    GruBlend, GruGates, gru_blend, gru_blend_bwd, gru_blend_bwd_plain,
    gru_blend_plain, gru_gates, gru_gates_bwd, gru_gates_bwd_plain,
    gru_gates_plain)

_COUNTS = (corr_lookup.launches, gru.launches, corr_alt.launches,
           gma.launches)


def launch_counts() -> dict:
    """Launches of each kernel since the counts were last set to 0."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def launch_dtypes() -> dict:
    """``{kernel: {dtype: launches}}`` since the counts were last set to 0
    (the dtype of the operands each launch read: the volume for the
    lookup and its scatter, the fmaps for K5, the GRU tensors, q and v
    for K6 and K7)."""
    out: dict = {}
    for (name, dtype), n in _build.dtype_launches.items():
        out.setdefault(name, {})[dtype] = n
    return out


def launch_layouts() -> dict:
    """``{kernel: {"channels_last": n, "contiguous": n}}`` for K2 and K4
    (the GRU kernels, ``gru.ROUTES``) since the counts were last set to 0:
    the layout of the operands each launch read in place."""
    return {name: {route: _build.layout_launches.get((name, route), 0)
                   for route in sorted(gru.ROUTES)}
            for name in gru.launches}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0
    _build.dtype_launches.clear()
    _build.layout_launches.clear()
