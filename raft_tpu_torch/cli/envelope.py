"""The card's measured limits, port of ``raft_tpu/cli/envelope.py``.

Every bound in ``PERF.md`` needs a memory rate and a peak rate of
operations. This measures them on the card, instead of taking the data
sheet's (3.35 TB/s, 67 TFLOP/s fp32, 495 TF32, 989 bf16 for an H100 SXM):

- the matmul peak of an ``n``x``n``x``n`` product (``torch.matmul``, cuBLAS:
  this measures the card, it is not the port of a kernel) in bf16, in fp32
  with TF32 off, and in fp32 with TF32 on;
- the device-memory copy bandwidth: ``dst.copy_(src)`` over buffers far
  larger than the 50 MB L2, each byte read once and written once;
- the time per launch of a one-element elementwise kernel, back to back
  (the issue rate a loop of small kernels meets), and one such launch with
  the device synchronised after it (the round trip).

Every time is fenced by CUDA events, the device synchronised around them.

    python -m raft_tpu_torch.cli.envelope [--n 8192] [--copy-mib 2048] \\
        [--reps 20]

Prints one line per measurement and, last, one JSON line. Runs on the card
only: there is no envelope of a CPU to report here.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from raft_tpu_torch.cli._measure import device_info, elapsed_ms


def matmul_tflops(n: int, dtype: torch.dtype, tf32: bool, reps: int,
                  dev: torch.device) -> float:
    """TFLOP/s of ``a @ b`` (2n³ operations) in ``dtype``, with
    ``allow_tf32`` as given for the call."""
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=dev).to(dtype)
    b = torch.randn((n, n), generator=gen, device=dev).to(dtype)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        ms = elapsed_ms(lambda: torch.matmul(a, b), reps, dev, warmup=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return 2.0 * n ** 3 / (ms * 1e-3) / 1e12


def copy_gbps(mib: int, reps: int, dev: torch.device) -> float:
    """GB/s (1e9 bytes) of a device-to-device copy of ``mib`` MiB: each byte
    read once and written once."""
    src = torch.empty(mib * 2 ** 20, dtype=torch.uint8, device=dev)
    src.random_(0, 256)
    dst = torch.empty_like(src)
    ms = elapsed_ms(lambda: dst.copy_(src), reps, dev, warmup=3)
    return 2.0 * src.numel() / (ms * 1e-3) / 1e9


def launch_us(launches: int, dev: torch.device) -> tuple:
    """(µs per launch back to back, median µs of one launch and a
    synchronise) of a one-element ``add_``."""
    x = torch.zeros(1, device=dev)
    back_to_back = elapsed_ms(lambda: x.add_(1.0), launches, dev,
                              warmup=100) * 1e3
    rounds = []
    for _ in range(100):
        t0 = time.perf_counter()
        x.add_(1.0)
        torch.cuda.synchronize(dev)
        rounds.append((time.perf_counter() - t0) * 1e6)
    return back_to_back, float(np.median(rounds))


def main(argv=None) -> dict:
    """Measure; returns the numbers of the JSON line."""
    p = argparse.ArgumentParser(description="the card's measured limits")
    p.add_argument("--n", type=int, default=8192,
                   help="matmul size (n x n times n x n)")
    p.add_argument("--copy-mib", type=int, default=2048,
                   help="copy buffer size in MiB (far above the 50 MB L2)")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--launches", type=int, default=1000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the envelope is measured on the "
                           "card")
    dev = torch.device("cuda")
    out = {"metric": "envelope", **device_info(dev), "n": args.n,
           "copy_mib": args.copy_mib, "reps": args.reps}
    out["matmul_tflops"] = {
        name: matmul_tflops(args.n, dtype, tf32, args.reps, dev)
        for name, dtype, tf32 in (("bf16", torch.bfloat16, False),
                                  ("fp32", torch.float32, False),
                                  ("tf32", torch.float32, True))}
    for name, v in out["matmul_tflops"].items():
        print(f"matmul {args.n}^3 {name}: {v:.2f} TFLOP/s", flush=True)
    out["copy_gbps"] = copy_gbps(args.copy_mib, args.reps, dev)
    print(f"device-memory copy of {args.copy_mib} MiB: "
          f"{out['copy_gbps']:.1f} GB/s (read + write)", flush=True)
    out["launch_us"], out["launch_sync_us"] = launch_us(args.launches, dev)
    print(f"one-element kernel: {out['launch_us']:.2f} us a launch back to "
          f"back, {out['launch_sync_us']:.2f} us launch + synchronise "
          "(median of 100)", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
