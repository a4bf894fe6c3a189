"""What decides ``correct``: the numbers compared with the reference, the
limits they are held to, and the lower precisions the controls compute in.

Each cell's limits are in ``flowbench/limits/<cell>.json``, each number's
limit set from two readings on the card (``PERF.md`` gives them): the
largest the program gave over a dozen seeds or more, and the smallest its
control gave, the reference computed in the next precision below the one
the configuration states.

- Serving: the worst sampled request's mean endpoint distance between its
  served flow and the float32 reference's, in pixels.
- Training: each of the first three steps' loss, the norm of each leaf of
  the first step's clipped gradient (as AdamW holds it after one step) and
  of each leaf's change over the three steps, against the reference's, each
  as the gap of the two norms over the larger of the reference's norm of
  that leaf and of the median leaf. Leaves whose reference gradient is
  under a thousandth of the median leaf's are left out.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: the least share of the median leaf's gradient norm a leaf must have to
#: count in the training comparison
LEAF_FLOOR = 1e-3


def set_precision(flags: Dict) -> None:
    """Set cuDNN's and cuBLAS's TF32 switches (the configuration's
    ``precision`` block)."""
    torch.backends.cudnn.allow_tf32 = bool(flags["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(flags["matmul_allow_tf32"])


@contextlib.contextmanager
def reference_precision():
    """The reference's arithmetic: float32 with TF32 off in cuDNN and
    cuBLAS. cuDNN benchmarks its algorithms for each shape here: its
    heuristics pick FFT tilings for some float32 convolutions on this card
    that launch over a million small kernels for four pairs (18 s against
    well under one). The switches are restored afterwards, so a program
    that runs later in the process sees its own."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark)
    set_precision({"cudnn_allow_tf32": False, "matmul_allow_tf32": False})
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


def limits(cell: str, root: str = os.path.dirname(HERE)) -> Dict[str, float]:
    with open(os.path.join(root, "flowbench", "limits", f"{cell}.json"),
              encoding="utf-8") as f:
        return json.load(f)["limits"]


def epe(got: np.ndarray, want: np.ndarray) -> float:
    """Mean endpoint distance between two (H, W, 2) flows, in pixels."""
    return float(np.sqrt(((np.asarray(got, np.float64)
                           - np.asarray(want, np.float64)) ** 2)
                         .sum(-1)).mean())


def rounding(dtype: str):
    """A function that rounds a tensor to ``dtype`` and back: bfloat16, or
    float8_e4m3fn scaled per tensor so its largest magnitude maps to
    448."""
    if dtype == "bfloat16":
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    if dtype == "float8_e4m3fn":
        def fp8(t: torch.Tensor) -> torch.Tensor:
            scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
            return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return fp8
    raise ValueError(f"no rounding to {dtype!r}")


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf, over the leaves in ``keep``."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``loss`` (three floats), ``grad`` and
    ``change`` (leaf name -> norm). Returns the three compared numbers."""
    med = float(np.median(list(ref["grad"].values())))
    keep = sorted(k for k, v in ref["grad"].items() if v >= LEAF_FLOOR * med)
    return {
        "loss_rel": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_leaf_rel": leaf_gaps(prog["grad"], ref["grad"], keep),
        "change_leaf_rel": leaf_gaps(prog["change"], ref["change"], keep),
    }


def judged(numbers: Dict[str, float], limit: Dict[str, float]
           ) -> List[Tuple[str, float, float]]:
    return [(k, float(numbers[k]), float(limit[k])) for k in limit]
