#!/usr/bin/env python3
"""Which convolutions a training step's device time belongs to, on one CUDA
card.

    python3 profile_train_convs.py

One train step of the basic model on the chairs recipe (batch 10, 368x496,
iters 12, fp32, TF32 off, ``pallas``+``fused``, seeded random weights and
the synthetic batch of ``chip_smoke.py``), after one warm-up step, under
``torch.profiler`` with host ops and their input shapes recorded. Prints
the ten convolutions (forward ``aten::cudnn_convolution`` with (input,
weight, bias) shapes, backward ``aten::convolution_backward`` with
(grad_output, input, weight)) that take the most device time in the step,
and the card's name and power limit. A diagnosis, not a check.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from chip_smoke import train_batch, train_config


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train_convs: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    tc = train_config(num_steps=2)
    state = create_train_state(
        RAFT(cfg, torch.Generator().manual_seed(0)).cuda(), tc)
    step_fn = make_train_step(cfg, tc)
    step_fn(state, train_batch(0))
    batch = train_batch(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::cudnn_convolution",
                          "aten::convolution_backward")]
    print(f"one train step's convolutions by device time; {smi}")
    for e in sorted(convs, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[6:]:<20s} {e.input_shapes[:3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
