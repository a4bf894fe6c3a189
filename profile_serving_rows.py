#!/usr/bin/env python3
"""Whether the rows of one batch-4 forward interact, on one CUDA card.

    python3 profile_serving_rows.py

A micro-batch carries other requests in its other rows, and ``chip_smoke.py``
phase 19 holds each future to its variant's direct ``infer_batch``. With
TF32 convolutions the basic model's row 3 of a full batch-4 forward at
440x1024 comes out other than the same pair alone in row 0. This diagnosis
runs eager forwards of the basic model (seeded weights) on four seeded
uint8 pairs, one refinement step, and prints for each configuration the
largest gap between row 3 of the batch and that pair alone in row 0
(zeros in the other rows):

1. the port's kernels (``pallas`` + ``fused``) with TF32 convolutions;
2. the plain configuration (``gather`` + ``xla``) with TF32 convolutions,
   and ``gather`` + ``fused``: no port kernel on the lookup, then none at
   all;
3. the kernels at 368x496 with TF32 convolutions;
4. the kernels at 440x1024 in fp32 (TF32 off).

The small trained fixture at 20 steps, and the basic model at 20 steps
(where random weights make the recurrence chaotic: a rounding difference
grows to hundreds of px), run through a captured engine bucket (4, 440,
1024) with TF32 convolutions: each pair alone against the four together,
and pair 0 moved to row 2. A diagnosis, not a check: it prints one JSON
line last and exits 0 (about half a minute).
"""

from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import torch

from chip_smoke import synthetic_frames


def _eager_rows(cfg, x1, x2, dev) -> dict:
    """Row 3 of the batch against the same pair alone in row 0."""
    from raft_tpu_torch.models import RAFT

    model = RAFT(cfg, torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        a1, a2 = (torch.from_numpy(x).to(dev) for x in (x1, x2))
        low4, up4 = model(a1, a2, iters=1, test_mode=True)
        z1, z2 = torch.zeros_like(a1), torch.zeros_like(a2)
        z1[0], z2[0] = a1[3], a2[3]
        low1, up1 = model(z1, z2, iters=1, test_mode=True)
    return {"flow_up": float((up4[3] - up1[0]).abs().max()),
            "flow_low": float((low4[3] - low1[0]).abs().max())}


def _engine_rows(weights, cfg, iters, pairs) -> dict:
    """Through a captured bucket: each pair alone against the four
    together, twice together, and pair 0 in row 2 among zeros."""
    from raft_tpu_torch.serving import RAFTEngine

    eng = RAFTEngine(weights, cfg, iters=iters, envelope=[(4, 440, 1024)],
                     warm_start=True, wire="u8")
    i1 = np.stack([a for a, _ in pairs])
    i2 = np.stack([b for _, b in pairs])
    together = eng.infer_batch(i1, i2)
    again = eng.infer_batch(i1, i2)
    alone = [eng.infer_batch(a[None], b[None])[0] for a, b in pairs]
    z1, z2 = np.zeros_like(i1), np.zeros_like(i2)
    z1[2], z2[2] = i1[0], i2[0]
    row2 = eng.infer_batch(z1, z2)[2]
    return {"together_vs_alone": [float(np.abs(together[k] - alone[k]).max())
                                  for k in range(4)],
            "together_twice": float(np.abs(together - again).max()),
            "row2_vs_row0": float(np.abs(row2 - alone[0]).max())}


def main() -> int:
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.tools.convert import load_pth

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving_rows: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(3)
    x1 = (rng.rand(4, 440, 1024, 3) * 255).astype(np.uint8)
    x2 = (rng.rand(4, 440, 1024, 3) * 255).astype(np.uint8)
    kernels = dict(corr_impl="pallas", gru_impl="fused")
    out = {"card": smi, "eager_one_step": {}}
    for tag, kw, tf32, hw in (
            ("kernels_tf32", kernels, True, (440, 1024)),
            ("plain_tf32", dict(corr_impl="gather", gru_impl="xla"), True,
             (440, 1024)),
            ("gather_fused_tf32", dict(corr_impl="gather", gru_impl="fused"),
             True, (440, 1024)),
            ("kernels_tf32_368x496", kernels, True, (368, 496)),
            ("kernels_fp32", kernels, False, (440, 1024))):
        torch.backends.cudnn.allow_tf32 = tf32
        h, w = hw
        out["eager_one_step"][tag] = _eager_rows(
            RAFTConfig(**kw), x1[:, :h, :w].copy(), x2[:, :h, :w].copy(),
            dev)
        print(tag, out["eager_one_step"][tag], flush=True)
    torch.backends.cudnn.allow_tf32 = True
    f = synthetic_frames(0, 5, (440, 1024))
    pairs = [(f[k], f[k + 1]) for k in range(4)]
    basic = RAFTConfig(**kernels)
    small = RAFTConfig(small=True, corr_impl="pallas")
    out["engine_20_steps"] = {
        "basic": _engine_rows(
            RAFT(basic, torch.Generator().manual_seed(0)).state_dict(),
            basic, 20, pairs),
        "small_fixture": _engine_rows(
            load_pth(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "fixtures",
                                  "raft-small-cputrained.pth"),
                     small).state_dict(), small, 20, pairs)}
    print(json.dumps({"serving_rows": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
