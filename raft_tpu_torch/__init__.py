"""raft_tpu_torch: the PyTorch and CUDA port of raft_tpu for NVIDIA Hopper.

A second package beside ``raft_tpu`` (the JAX reference, which stays as it
is). It imports ``torch`` and never ``jax``, ``flax`` or ``raft_tpu``, keeps
the JAX package's module layout and names, and replaces each Pallas TPU
kernel on its path with a CUDA kernel written for ``sm_90a``
(``raft_tpu_torch/csrc``). Entry points run on the card unless the caller
asks for the CPU.
"""

from raft_tpu_torch.config import RAFTConfig  # noqa: F401
