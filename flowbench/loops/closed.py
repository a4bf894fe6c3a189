"""A closed loop: ``clients`` callers (the mix's ``clients``), each sending
its next pair as soon as its last one resolves, until the window ends."""

from __future__ import annotations

import time
from typing import Dict, Tuple


def offer(load, traffic: Dict, seconds: float, seed: int
          ) -> Tuple[float, float, Dict]:
    clients = int(traffic["clients"])
    t0 = time.perf_counter()
    t_end = t0 + seconds
    for c in range(clients):
        load.send(t0, c)
    out = clients
    while out:
        c = load.events.get(timeout=120.0)
        out -= 1
        now = time.perf_counter()
        if now < t_end:
            load.send(now, c)
            out += 1
    return t0, t_end, {}
