"""Ragged-batch correlation: one program for mixed spatial shapes, port of
``raft_tpu/kernels/corr_ragged_pallas.py`` (which reaches no
``pallas_call``: it carries masks and descriptors, not a kernel).

A ragged micro-batch packs requests of DIFFERENT ``(h, w)`` into one
``(B, Hcap, Wcap)`` capacity box; each row's descriptor says how much of
the box is real. On the card the serving engine captures one CUDA graph per
capacity class, and the descriptor's extents are tensors among the graph's
static inputs, so every shape mix replays the same graph.

**Self-masking.** Both lookups (the plain gather and K1) implement
grid_sample's ``padding_mode='zeros'``: window taps outside the volume read
zeros. Once the per-row feature tails are zeroed (:func:`mask_features`),
the correlation volume of row *i* is exactly the row's own ``(h_i/8,
w_i/8)`` volume zero-padded to the capacity box, and a window that drifts
past the row's valid extent reads the same zeros an out-of-bounds tap reads
on the row's own volume. So no new kernel is needed: the ragged path rides
K1 (or K5 under ``alternate_corr``).

Masked-tail semantics:

- target pixels past a row's valid extent contribute nothing to any
  query's window (their correlation entries are exactly 0.0);
- query pixels past the valid extent give garbage rows that the serving
  layer crops away;
- a full-extent row's mask is the identity (``torch.where`` on an all-true
  mask returns the operand's bits), so a request whose padded shape equals
  the capacity box is bitwise the bucketed path.

The descriptor also carries the flat-view bookkeeping (``hw_offset``,
``valid_len``): row *i* of the flattened ``(B·HW_cap,)`` buffer starts at
``i * Hcap/8 * Wcap/8`` and its first ``h8_i * Wcap/8`` lanes hold its
valid rows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from raft_tpu_torch.models.corr import build_corr_pyramid, corr_lookup


class RaggedDescriptor(NamedTuple):
    """Per-row validity of one ragged micro-batch at 1/8 feature
    resolution, inside a shared ``(Hcap/8, Wcap/8)`` capacity box.

    ``h8``/``w8``: (B,) int32 valid extents (``hp_i/8``, ``wp_i/8`` of the
    row's ÷8-padded request; 0 for batch-fill rows, which masks the whole
    row). ``hw_offset``/``valid_len``: (B,) int32 flat-view bookkeeping —
    where row *i* starts in the flattened ``(B·HW_cap,)`` lane order and
    how many of its ``HW_cap`` entries are real.
    """

    h8: torch.Tensor
    w8: torch.Tensor
    hw_offset: torch.Tensor
    valid_len: torch.Tensor


def make_descriptor(shapes8: Sequence[Tuple[int, int]],
                    cap_hw8: Tuple[int, int], batch: int,
                    device=None) -> RaggedDescriptor:
    """The descriptor for ``len(shapes8)`` real rows padded to ``batch``
    rows of a ``cap_hw8 = (Hcap/8, Wcap/8)`` box, as int32 tensors on
    ``device``. Every extent must fit the box: raising here beats a mask
    that silently zeroes a real request's features."""
    ch, cw = cap_hw8
    if len(shapes8) > batch:
        raise ValueError(f"{len(shapes8)} rows > batch {batch}")
    h8: List[int] = [0] * batch
    w8: List[int] = [0] * batch
    for i, (h, w) in enumerate(shapes8):
        if h > ch or w > cw:
            raise ValueError(
                f"row {i} extent ({h}, {w}) exceeds the capacity box "
                f"({ch}, {cw})")
        h8[i], w8[i] = int(h), int(w)
    hw = ch * cw

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=device)

    return RaggedDescriptor(h8=i32(h8), w8=i32(w8),
                            hw_offset=i32([i * hw for i in range(batch)]),
                            valid_len=i32([h8[i] * cw for i in range(batch)]))


def mask_features(fmap: torch.Tensor, valid_h: torch.Tensor,
                  valid_w: torch.Tensor) -> torch.Tensor:
    """Zero a (B, H, W, C) feature map past each row's valid extent.

    ``valid_h``/``valid_w``: (B,) int32 tensors on ``fmap``'s device. An
    exact select against ``arange`` masks, with no host synchronisation, so
    it can be captured in a CUDA graph with the extents as static inputs;
    an all-true mask returns the operand's bits unchanged."""
    B, H, W, _ = fmap.shape
    ih = torch.arange(H, device=fmap.device, dtype=torch.int32)
    iw = torch.arange(W, device=fmap.device, dtype=torch.int32)
    valid = ((ih[None, :, None] < valid_h[:, None, None])
             & (iw[None, None, :] < valid_w[:, None, None]))
    return torch.where(valid[..., None], fmap, fmap.new_zeros(()))


def build_corr_pyramid_ragged(fmap1: torch.Tensor, fmap2: torch.Tensor,
                              valid_h: torch.Tensor, valid_w: torch.Tensor,
                              num_levels: int = 4) -> List[torch.Tensor]:
    """Masked all-pairs pyramid: each row's volume is its own smaller volume
    zero-embedded in the capacity box. Masking both maps makes tail targets
    contribute exact zeros to every window (fmap2) and tail queries give
    zero rows (fmap1). Pooled cells straddling the valid boundary average
    real values against zeros, the zeros semantics of the row's own volume
    at its boundary."""
    return build_corr_pyramid(mask_features(fmap1, valid_h, valid_w),
                              mask_features(fmap2, valid_h, valid_w),
                              num_levels)


def corr_lookup_ragged(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int, impl: str = "gather") -> torch.Tensor:
    """Window lookup over a masked pyramid, ragged by self-masking. Dispatches
    on ``impl`` as ``RAFT._corr_setup`` does on ``corr_impl``: ``"gather"``
    is the plain lookup, every other name K1 (on a CUDA tensor; its plain
    version on a CPU one)."""
    return corr_lookup(pyramid, coords, radius, impl)
