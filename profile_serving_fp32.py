#!/usr/bin/env python3
"""Whether a captured fp32 bucket at batch 4 replays what eager computes,
on one CUDA card.

    python3 profile_serving_fp32.py

``chip_smoke.py`` phase 17 serves batch 4 with TF32 convolutions: in fp32
(TF32 off) cuDNN takes FFT convolutions at the encoders' batch of 8, about
11 s and 27 GB a forward. This diagnosis runs phase 17's engine A in fp32
(the basic model, seeded weights, ``pallas``+``fused``, iters 20, u8
wire, warm start) on phase 5's four 436x1024 pairs at batch 4 and compares,
bitwise or by the largest gap:

1. two eager forwards before any capture in the process;
2. the engine's buckets (1, 440, 1024) and (4, 440, 1024) and ragged class
   (4, 440, 1024) captured into one pool: the batch-4 replay against the
   eager forward before the captures and against one after them;
3. a fresh engine with the batch-4 bucket alone: its replay against the
   first engine's and against the eager forward after the captures.

The basic model's 20-step recurrence at random weights is chaotic (one ulp
of input moves the flow by hundreds of px), so a convolution that runs
another cuDNN algorithm shows as a gap of that size. Free device memory is
printed before each capture and eager forward. A diagnosis, not a check:
it prints and exits 0 (about 3 minutes).
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import (PAIRS, SERVE_CLASS, SERVE_ENVELOPE, bucket_u8,
                        synthetic_frames)


def free_gib() -> float:
    return torch.cuda.mem_get_info()[0] / 2 ** 30


def gap(a, b) -> str:
    return "bitwise" if np.array_equal(a, b) else f"{np.abs(a - b).max():.3e} px"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serving_fp32: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.config import ITERS_EXPORT, RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import RAFTEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()

    def log(msg):
        print(f"{msg} (+{time.perf_counter() - t_start:.1f} s)", flush=True)

    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    weights = RAFT(cfg, torch.Generator().manual_seed(0)).state_dict()
    frames = synthetic_frames(0, PAIRS + 1)
    f1, f2 = np.stack(frames[:PAIRS]), np.stack(frames[1:])
    bucket = (4, 440, 1024)
    zero = torch.zeros((4, 55, 128, 2), device="cuda")

    def eager(model):
        i1, i2 = bucket_u8(f1, f2, bucket)
        log(f"  eager forward: {free_gib():.1f} GiB free before it")
        with torch.no_grad():
            out = model(i1, i2, iters=ITERS_EXPORT, flow_init=zero)[1]
        return out[:, 2:438].cpu().numpy()

    log(f"fp32 (TF32 off), cuDNN deterministic "
        f"{torch.backends.cudnn.deterministic}; {smi}")
    eng = RAFTEngine(weights, cfg, iters=ITERS_EXPORT,
                     envelope=SERVE_ENVELOPE, precompile=False, wire="u8",
                     warm_start=True, ragged=True,
                     capacity_classes=[SERVE_CLASS])
    pre = eager(eng.model)
    log(f"1. before any capture, eager vs eager {gap(pre, eager(eng.model))}")
    for b, h, w in SERVE_ENVELOPE:
        log(f"capture {b}x{h}x{w}: {free_gib():.1f} GiB free before it")
        eng.ensure_bucket(b, h, w)
    log(f"capture the ragged class: {free_gib():.1f} GiB free before it")
    eng.ensure_bucket(*SERVE_CLASS, kind="ragged")
    log(f"captured (seconds): {eng.capture_seconds}")
    replay = eng.infer_batch(f1, f2)
    post = eager(eng.model)
    log(f"2. batch-4 replay vs eager before the captures {gap(replay, pre)}; "
        f"vs eager after them {gap(replay, post)}; eager before vs after "
        f"{gap(pre, post)}; replay vs replay "
        f"{gap(replay, eng.infer_batch(f1, f2))}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    fresh = RAFTEngine(weights, cfg, iters=ITERS_EXPORT, envelope=[bucket],
                       wire="u8", warm_start=True)
    alone = fresh.infer_batch(f1, f2)
    log(f"3. fresh engine, the batch-4 bucket alone: replay vs the first "
        f"engine's {gap(alone, replay)}; vs eager after the captures "
        f"{gap(alone, post)}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
