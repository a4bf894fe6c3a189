"""Hand-written CUDA kernels for Hopper, the successors of the JAX
package's Pallas TPU kernels.

Sources live in ``raft_tpu_torch/csrc/`` and are built at first use by
``kernels._build`` (nothing is built or imported from a GPU toolchain when
this package is imported). Each wrapper counts its launches in a plain
integer; :func:`launch_counts` reads them and :func:`reset_launch_counts`
sets them to 0.
"""

from raft_tpu_torch.kernels import corr_lookup, gru
from raft_tpu_torch.kernels.corr_lookup import corr_lookup_cuda  # noqa: F401
from raft_tpu_torch.kernels.gru import (gru_blend, gru_blend_plain,  # noqa: F401
                                        gru_gates, gru_gates_plain)


def launch_counts() -> dict:
    """Launches of each kernel since the counts were last set to 0."""
    return {"corr_lookup": corr_lookup.launches,
            "gru_gates": gru.gates_launches,
            "gru_blend": gru.blend_launches}


def reset_launch_counts() -> None:
    corr_lookup.launches = 0
    gru.gates_launches = 0
    gru.blend_launches = 0
