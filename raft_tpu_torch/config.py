"""Typed configuration for raft_tpu_torch.

The port's own copy of ``raft_tpu/config.py``'s ``RAFTConfig``,
``TrainConfig``, stage presets and constants: the same fields, defaults and
validation, so flags and configs carry over between the two packages.
What a field selects differs where the hardware differs:

- ``corr_impl``: ``"gather"`` runs the plain 4-corner gather lookup
  (``models.corr.corr_lookup_gather``). Every other name (``onehot``,
  ``onehot_t``, ``softsel``, ``softsel_t``, ``pallas``) selects the
  hand-written CUDA lookup kernel (``kernels.corr_lookup``) on a CUDA
  tensor. The four XLA names are formulations that exist only to avoid
  gathers on the TPU; a GPU gathers natively, so they share the kernel.
  With ``alternate_corr=True`` the same rule picks the on-the-fly lookup:
  ``"gather"`` runs the plain ``models.corr.alt_corr_lookup``, every other
  name the CUDA kernel of ``kernels.corr_alt`` (K5). The JAX package routes
  only ``"pallas"`` to its kernel and the rest to its XLA formulation; the
  two compute the same function within 1e-5.
- ``gru_impl``: ``"fused"`` runs the SepConvGRU's gate and blend tails in
  the CUDA kernels of ``kernels.gru``; ``"xla"`` runs the plain
  elementwise PyTorch math.

- ``gma_heads``: 0 runs RAFT; 1 runs GMA (Jiang et al., ICCV 2021): RAFT
  basic with attention over the 1/8 grid's positions, formed once a pair
  from the context features, and every step's motion features aggregated
  over it (``models.gma``, the Triton kernels of ``kernels.gma``: K6, K7).
  It has no counterpart in the JAX package. The small model, a
  ``spatial`` mesh axis, ragged and cached serving, and training refuse
  it.

On a CPU tensor every choice runs the plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """Architecture hyper-parameters (see ``raft_tpu.config.RAFTConfig``).

    basic: hdim=cdim=128, corr_levels=4, corr_radius=4, fnet 256ch instance
    norm, cnet 256ch batch norm; small: hdim=96, cdim=64, radius=3, fnet 128
    instance, cnet 160 no-norm.
    """

    small: bool = False
    dropout: float = 0.0
    alternate_corr: bool = False
    mixed_precision: bool = False
    corr_levels: int = 4
    corr_impl: str = "onehot"
    # storage dtype of the materialized correlation pyramid; the all-pairs
    # product always runs fp32 and the lookup lerps in fp32
    corr_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "full"
    gru_impl: str = "xla"
    # accepted for config compatibility; the port's refinement loop is a
    # Python loop, so there is nothing to unroll
    scan_unroll: int = 1
    # two fnet calls instead of one batch-concat call: identical values
    # (fnet is instance-norm, per-sample statistics)
    split_encode: bool = False
    # GMA's attention heads: 0 is RAFT, 1 GMA's published single head
    gma_heads: int = 0

    def __post_init__(self):
        if not (isinstance(self.scan_unroll, int)
                and not isinstance(self.scan_unroll, bool)
                and self.scan_unroll >= 1):
            raise ValueError(
                f"scan_unroll={self.scan_unroll!r}: must be an int >= 1")
        if self.corr_impl not in ("gather", "onehot", "onehot_t", "softsel",
                                  "softsel_t", "pallas"):
            raise ValueError(
                f"corr_impl={self.corr_impl!r}: choose gather, onehot, "
                "onehot_t, softsel, softsel_t, or pallas (the "
                "memory-efficient alternate path is selected by "
                "alternate_corr=True, with corr_impl picking its "
                "XLA/pallas backend)")
        if self.gru_impl not in ("xla", "fused"):
            raise ValueError(
                f"gru_impl={self.gru_impl!r}: choose 'xla' (plain "
                "elementwise GRU tails) or 'fused' (the gate/blend "
                "kernels)")
        if self.gru_impl == "fused" and self.small:
            raise ValueError(
                "gru_impl='fused' covers the basic model's "
                "BasicMotionEncoder + SepConvGRU; the small model's "
                "3x3 ConvGRU has no fused path — drop one of the two "
                "settings")
        if (not isinstance(self.gma_heads, int)
                or isinstance(self.gma_heads, bool)
                or self.gma_heads not in (0, 1)):
            raise ValueError(
                f"gma_heads={self.gma_heads!r}: 0 (RAFT) or 1 (GMA's "
                "published single head); more heads are not built")
        if self.gma_heads and self.small:
            raise ValueError(
                "gma_heads=1 with small=True: GMA is built on RAFT basic "
                "(its attention spans the basic model's 128 context "
                "channels); the small model has no GMA")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy={self.remat_policy!r}: choose 'full' or "
                "'dots'")
        if self.corr_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"corr_dtype={self.corr_dtype!r}: choose 'float32' "
                "(bit-level reference parity) or 'bfloat16' (halved "
                "volume traffic; see the corr_dtype comment)")
        if self.alternate_corr and self.corr_dtype != "float32":
            raise ValueError(
                "corr_dtype applies to the materialized correlation "
                "pyramid only; alternate_corr never builds one, so "
                f"corr_dtype={self.corr_dtype!r} would silently do "
                "nothing — remove one of the two settings.")

    @property
    def hidden_dim(self) -> int:
        return 96 if self.small else 128

    @property
    def context_dim(self) -> int:
        return 64 if self.small else 128

    @property
    def corr_radius(self) -> int:
        return 3 if self.small else 4

    @property
    def fnet_dim(self) -> int:
        return 128 if self.small else 256

    @property
    def cnet_dim(self) -> int:
        return self.hidden_dim + self.context_dim

    @property
    def fnet_norm(self) -> str:
        return "instance"

    @property
    def cnet_norm(self) -> str:
        return "none" if self.small else "batch"

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32


# Iteration counts per use-site: train 12, demo 20, eval sintel 32 /
# kitti 24 / chairs 24, export bakes 20.
ITERS_TRAIN = 12
ITERS_DEMO = 20
ITERS_EVAL = {"sintel": 32, "kitti": 24, "chairs": 24}
ITERS_EXPORT = 20


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One curriculum stage (see ``raft_tpu.config.TrainConfig``). Defaults
    follow the reference's ``train.py:217-239``.
    """

    name: str = "raft"
    stage: str = "chairs"
    restore_ckpt: Optional[str] = None
    lr: float = 4e-4
    num_steps: int = 100000
    batch_size: int = 10
    image_size: Tuple[int, int] = (368, 496)
    wdecay: float = 1e-4
    epsilon: float = 1e-8
    clip: float = 1.0
    gamma: float = 0.8
    iters: int = 12
    add_noise: bool = False
    seed: int = 1234
    val_freq: int = 5000
    sum_freq: int = 100
    validation: Tuple[str, ...] = ()
    num_workers: int = 4
    checkpoint_dir: str = "checkpoints"
    data_root: str = "datasets"
    log_dir: str = "runs"
    # (start, stop): trace these step indices into log_dir
    profile_steps: Optional[Tuple[int, int]] = None
    # the sequence loss in the convex upsampler's subpixel domain (basic
    # model): identical values without the (T,B,8H,8W,2) prediction stack.
    # None = auto (fused for the basic model, standard for the small one,
    # silently); True = requested (warns for the small model); False = the
    # standard loss
    fused_loss: Optional[bool] = None
    # no-progress watchdog deadline in seconds; 0 disables. It must cover the
    # longest gap between beats: one step (the first with the loader's first
    # batch and cuDNN's set-up; the kernels' build comes before the watch),
    # and a checkpoint save with its validation pass
    hang_s: float = 0.0
    on_bad_sample: str = "raise"
    stall_s: float = 0.0


# Stage presets mirroring train_standard.sh:3-6 (2-GPU fp32 recipe).
STANDARD_STAGES = {
    "chairs": dict(stage="chairs", lr=4e-4, num_steps=100000, batch_size=10,
                   image_size=(368, 496), wdecay=1e-4, gamma=0.8,
                   validation=("chairs",)),
    "things": dict(stage="things", lr=1.25e-4, num_steps=100000, batch_size=6,
                   image_size=(400, 720), wdecay=1e-4, gamma=0.8,
                   validation=("sintel",)),
    "sintel": dict(stage="sintel", lr=1.25e-4, num_steps=100000, batch_size=6,
                   image_size=(368, 768), wdecay=1e-5, gamma=0.85,
                   validation=("sintel",)),
    "kitti": dict(stage="kitti", lr=1e-4, num_steps=50000, batch_size=6,
                  image_size=(288, 960), wdecay=1e-5, gamma=0.85,
                  validation=("kitti",)),
}

# Stage presets mirroring train_mixed.sh:3-6 (1-GPU mixed-precision recipe).
MIXED_STAGES = {
    "chairs": dict(stage="chairs", lr=2.5e-4, num_steps=120000, batch_size=8,
                   image_size=(368, 496), wdecay=1e-4, gamma=0.8,
                   validation=("chairs",)),
    "things": dict(stage="things", lr=1e-4, num_steps=120000, batch_size=5,
                   image_size=(400, 720), wdecay=1e-4, gamma=0.8,
                   validation=("sintel",)),
    "sintel": dict(stage="sintel", lr=1e-4, num_steps=120000, batch_size=5,
                   image_size=(368, 768), wdecay=1e-5, gamma=0.85,
                   validation=("sintel",)),
    "kitti": dict(stage="kitti", lr=1e-4, num_steps=50000, batch_size=5,
                  image_size=(288, 960), wdecay=1e-5, gamma=0.85,
                  validation=("kitti",)),
}

MAX_FLOW = 400.0  # train.py:42: displacements at or above it leave the loss


def stage_config(stage: str, mixed: bool = False, **overrides) -> TrainConfig:
    """The stage's preset (``MIXED_STAGES`` when ``mixed``) with
    ``overrides`` applied."""
    presets = MIXED_STAGES if mixed else STANDARD_STAGES
    kw = dict(presets[stage])
    kw.update(overrides)
    return TrainConfig(**kw)
