"""Inference throughput, port of ``raft_tpu/cli/infer_bench.py``: ms a pair
of the test-mode forward (``evaluation.evaluate.make_forward``, what the
demo and the validators run), the reference's ``test_trt.py:74-97`` harness
with synchronise fences.

The basic (or ``--small``) model with seeded random weights (no trained
basic weights are in the repository; the time does not depend on them)
runs ``--reps`` forwards of a ``--batch`` of ``--hw`` frames at ``--iters``
refinement steps, after one warm-up forward, timed by CUDA events on the
card. The JAX package's ``chain_timed`` scheme works around its remote TPU
backend and has no counterpart here.

    python -m raft_tpu_torch.cli.infer_bench --hw 440 1024 \\
        --corr_impl pallas --gru_impl fused [--alternate_corr]

Prints one JSON line: ms per forward and per pair, pairs/s, peak device
memory and the kernels' launches per forward.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from raft_tpu_torch.cli._args import add_corr_args, corr_overrides
from raft_tpu_torch.cli._measure import device_info, elapsed_ms, sync


def main(argv=None) -> dict:
    """Run the benchmark; returns the numbers of the JSON line."""
    p = argparse.ArgumentParser(description="test-mode forward throughput")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--hw", type=int, nargs=2, default=[440, 1024],
                   help="input H W (divisible by 8); the default is the "
                        "Sintel frame padded to a multiple of 8")
    p.add_argument("--iters", type=int, default=20,
                   help="refinement iterations (the demo's 20)")
    p.add_argument("--reps", type=int, default=10,
                   help="timed forwards after one warm-up")
    p.add_argument("--small", action="store_true")
    p.add_argument("--alternate_corr", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    add_corr_args(p)
    args = p.parse_args(argv)

    from raft_tpu_torch import kernels
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.evaluation.evaluate import make_forward, resolve_device
    from raft_tpu_torch.models import RAFT

    dev = resolve_device(args.device)
    H, W = args.hw
    if H % 8 or W % 8:
        raise SystemExit(f"--hw {H} {W}: both must be divisible by 8")
    cfg = RAFTConfig(small=args.small, alternate_corr=args.alternate_corr,
                     **corr_overrides(args))
    model = RAFT(cfg, torch.Generator().manual_seed(args.seed)).to(dev)
    rng = np.random.RandomState(args.seed)
    img1, img2 = (torch.from_numpy(
        rng.rand(args.batch, H, W, 3).astype(np.float32) * 255).to(dev)
        for _ in range(2))
    fwd, _ = make_forward(cfg, args.iters, device=str(dev))
    fwd(model, img1, img2)                                 # warm-up
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    ms = elapsed_ms(lambda: fwd(model, img1, img2), args.reps, dev, warmup=0)
    launches = {k: v / args.reps
                for k, v in kernels.launch_counts().items() if v}
    out = {"metric": f"raft_{'small' if args.small else 'basic'}_infer_"
                     f"{H}x{W}_b{args.batch}_iters{args.iters}",
           **device_info(dev), "batch": args.batch, "hw": [H, W],
           "iters": args.iters, "reps": args.reps,
           "corr_impl": cfg.corr_impl, "gru_impl": cfg.gru_impl,
           "alternate_corr": cfg.alternate_corr,
           "ms_per_forward": ms, "ms_per_pair": ms / args.batch,
           "pairs_per_s": args.batch / ms * 1e3,
           "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                        if dev.type == "cuda" else None),
           "launches_per_forward": launches}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
