"""An open loop: Poisson arrivals at the mix's ``rate`` pairs a second,
each request sent when it is due whether or not earlier ones resolved.

The arrivals are the same set of gaps in every run (``rate·seconds``
exponential gaps drawn from the mix's own ``arrival_seed``, scaled to sum
to the window), in an order drawn from the run's seed, so every seed
offers the same work."""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np

from flowbench.weights import derive_seed


def arrivals(traffic: Dict, seconds: float, seed: int) -> np.ndarray:
    """Each request's due time, in seconds after the window's start."""
    n = max(1, int(round(traffic["rate"] * seconds)))
    gaps = np.random.default_rng(traffic["arrival_seed"]).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    np.random.default_rng(derive_seed(seed, 6)).shuffle(gaps)
    return np.cumsum(gaps)


def offer(load, traffic: Dict, seconds: float, seed: int
          ) -> Tuple[float, float, Dict]:
    """The notes say how late the sender ran behind a due time at most."""
    offsets = arrivals(traffic, seconds, seed)
    t0 = time.perf_counter()
    late = 0.0
    for off in offsets:
        due = t0 + float(off)
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - due)
        load.send(due)
    for _ in offsets:
        load.events.get(timeout=120.0)
    return t0, t0 + float(offsets[-1]), {"generator_late_s": late}
