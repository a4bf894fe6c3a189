#!/usr/bin/env python3
"""Where the device time of a 1080x1920 pair goes, on one CUDA card.

    python3 profile_hd_pair.py

The basic model with ``alternate_corr`` (``pallas``+``fused``, seeded
random weights, TF32 off) on one pair of ``chip_smoke.py``'s synthetic
1080x1920 frames at iters=20, after one warm-up pair, under
``torch.profiler``: the pair's wall time, the device's busy time (the union
of its kernel intervals) and the ten device ops that take the most time,
with the card's name and power limit. A diagnosis, not a check; the
profiler's processing of the pair's ~700,000 device events takes minutes.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from chip_smoke import (HD_HW, HD_ITERS, device_busy_ms, device_events,
                        run_pairs, synthetic_frames)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_hd_pair: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = RAFTConfig(alternate_corr=True, corr_impl="pallas", gru_impl="fused")
    model = RAFT(cfg, torch.Generator().manual_seed(0)).cuda()
    frames = synthetic_frames(3, 2, HD_HW)
    run_pairs(model, cfg, frames, HD_ITERS)                 # warm-up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pairs(model, cfg, frames, HD_ITERS)
        wall = (time.perf_counter() - t0) * 1e3
    evs = device_events(prof)
    print(f"one 1080x1920 pair, alternate, iters={HD_ITERS}, under the "
          f"profiler: wall {wall:.2f} ms, device busy {device_busy_ms(prof):.2f}"
          f" ms; top device time; {smi}")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
