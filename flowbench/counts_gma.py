"""Frozen operation and byte counts of GMA, beside ``flowbench.counts``'s
of RAFT, and the readers' arithmetic for the GMA kernels.

- :func:`attention_cost` (K6) and :func:`aggregate_cost` (K7): one pair's
  launch at a grid of ``n`` positions, as ``(bytes, operations)``: each
  input byte read once, each output byte written once.
- :func:`gma_forward_flops`: one pair's forward, RAFT basic's count
  (``counts.forward_flops``) plus what GMA adds: the GRU's wider input (128
  more channels into each of the six gate convs), ``W_qk`` once, and every
  step ``W_v`` and the aggregation ``A v``, and the attention's product
  ``q kᵀ`` once (two operations a multiply-add).
- :func:`least_s`: a launch's least time on the card, the larger of bytes
  over the HBM bandwidth and operations over the dense TF32 rate: no
  implementation to float32 accuracy, on the CUDA cores or in split TF32
  on the tensor cores, can beat it.
- :data:`KERNELS` and :func:`events`: the device events of K6 and K7,
  found by their kernel names (``flowbench.trace.PORT_KERNELS`` is frozen
  and names neither).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from flowbench import counts, trace

#: the GMA kernels' names in the device trace (``kernels/gma.py``)
KERNELS = {"k6": re.compile(r"\bgma_attention"),
           "k7": re.compile(r"\bgma_aggregate")}


def attention_cost(n: int, dim: int = 128) -> Tuple[float, float]:
    """K6 at a grid of ``n``: q and k read, A written; ``q kᵀ``."""
    return float(2 * n * dim * 4 + n * n * 4), float(2 * n * n * dim)


def aggregate_cost(n: int, dim: int = 128) -> Tuple[float, float]:
    """K7 at a grid of ``n``: A, v and m read, g written; ``A v``."""
    return float(n * n * 4 + 3 * n * dim * 4), float(2 * n * n * dim)


def gma_forward_flops(arch: Dict, hw: Tuple[int, int], iters: int) -> int:
    """One pair's GMA forward at the ÷8-padded size ``hw``."""
    n = (hw[0] // 8) * (hw[1] // 8)
    hdim, cdim = arch["hidden_dim"], arch["context_dim"]
    inner = arch["gma_heads"] * arch["dim_head"]
    gru_extra = 6 * 2 * 128 * hdim * 5 * n      # six 1x5 / 5x1 gate convs
    w_qk = 2 * cdim * 2 * inner * n
    w_v = 2 * 128 * inner * n
    product = 2 * n * n * inner                 # q kᵀ, and each A v
    return (counts.forward_flops(arch, hw, iters) + w_qk + product
            + iters * (gru_extra + w_v + product))


def least_s(cost: Tuple[float, float]) -> float:
    """The least time of a launch moving ``cost`` (bytes, operations) at
    the data sheet's HBM bandwidth and dense TF32 rate."""
    return counts.bound_s(cost, counts.PEAKS["tf32_flops"])


def launch_bounds(bucket_dispatches: Dict[Tuple[int, int, int], int],
                  iters: int, dim: int = 128) -> Dict[str, List]:
    """(launches, least seconds of one) of K6 and K7 for each bucket the
    slice dispatched: one K6 launch a replay, ``iters`` K7 launches, each
    over the bucket's batch."""
    out: Dict[str, list] = {"k6": [], "k7": []}
    for (b, h, w), runs in bucket_dispatches.items():
        n = (h // 8) * (w // 8)
        k6, k7 = attention_cost(n, dim), aggregate_cost(n, dim)
        out["k6"].append((runs, least_s((b * k6[0], b * k6[1]))))
        out["k7"].append((runs * iters, least_s((b * k7[0], b * k7[1]))))
    return out


def events(ctx: Dict, kernel: str) -> List[trace.Event]:
    """The slice's device events of ``kernel`` (``k6``, ``k7``)."""
    pat = KERNELS[kernel]
    return [e for e in ctx["events"] if pat.search(e[0])]


def roofline(ctx: Dict, kernel: str) -> Optional[float]:
    """Percent of its roofline K6 or K7 reaches: the launches' least
    times, weighted by the launches the dispatches imply, over the mean
    recorded launch time (``trace.roofline``'s rule)."""
    bounds = ctx.get("gma_launch_bounds", {}).get(kernel)
    found = events(ctx, kernel) if ctx.get("events") else []
    if not bounds or not found:
        return None
    launches = sum(n for n, _ in bounds)
    least = sum(n * b for n, b in bounds) / launches
    spent = sum(b - a for _, a, b in found) / len(found)
    return 100.0 * least / spent


def share(ctx: Dict) -> Optional[float]:
    """Percent of the device's busy time in K6 and K7."""
    if not ctx.get("events"):
        return None
    found = events(ctx, "k6") + events(ctx, "k7")
    if not found:
        return None
    return 100.0 * trace.union_s(found) / ctx["busy_s"]
