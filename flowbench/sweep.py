"""The rate sweep that fixes an open-loop cell's rate (the benchmark's own
runs never run this): one engine and scheduler built and warmed as the
cell builds them, then for each offered rate a window of Poisson arrivals
at it, each request timed from when it was due.

    python3 -m flowbench.sweep --workload basic-sintel-serve-open \\
        --seconds 20 --rates 30 40 45 50 55 60

Prints one JSON line a rate: pairs completed a second, the latency's
median, 95th and 99th percentiles, and the backlog's trend (the median
latency of the window's last quarter of arrivals over its first
quarter's: near 1 where the system keeps up, growing with the window
where it does not). The highest rate it sustains is the highest whose
95th percentile stays bounded and whose trend stays near 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from flowbench import run
from flowbench.kinds import serve
from flowbench.loops import poisson
from flowbench.spec import Cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=int, default=20)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        run.fail("no CUDA device")
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    sched, _, _, pool, order = serve.build(cell, args.seed, device, {},
                                           time.perf_counter())
    for rate in args.rates:
        tr = dict(cell.traffic, rate=rate)
        load = serve.Load(sched, pool, order, 0, args.seed)
        offered = len(poisson.arrivals(tr, args.seconds, args.seed))
        t0, _, notes = poisson.offer(load, tr, args.seconds, args.seed)
        done = sorted(load.done)
        lat = np.array([1e3 * (d[2] - d[1]) for d in done if d[3]])
        q = max(1, len(lat) // 4)
        ends = max(d[2] for d in done)
        print(json.dumps({
            "rate": rate, "offered": offered,
            "failed": sum(1 for d in done if not d[3]),
            "completed_per_s": len(lat) / (ends - t0),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "trend": float(np.median(lat[-q:]) / np.median(lat[:q])),
            **notes}), flush=True)
    sched.close(drain=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
