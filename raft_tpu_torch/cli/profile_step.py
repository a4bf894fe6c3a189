"""One train step under the profiler, port of
``raft_tpu/cli/profile_step.py``.

Runs warm-up steps and then ``--steps`` timed steps of the chairs-recipe
train step (basic model, ``train_standard.sh`` stage 1's loss and
optimizer) on one seeded synthetic batch, the device synchronised around
each step, then one more step under ``torch.profiler``: the device time by
op, the device's busy time (the union of its kernels' and copies'
intervals) and the idle share of that step's wall time, and the peak device
memory of the timed steps. bf16 mixed precision unless ``--fp32``, as in
the JAX package.

    python -m raft_tpu_torch.cli.profile_step --batch 8 \\
        --corr_impl pallas --gru_impl fused [--remat [--remat_policy dots]] \\
        [--no-fused-loss] [--fp32] [--trace-dir runs/profile]

``--remat_policy`` and ``--fused_loss`` feed ``RAFTConfig.remat_policy`` and
``TrainConfig.fused_loss`` as in the JAX CLI; ``--small`` profiles the small
model, which has no fused loss, so ``--small --fused_loss`` raises rather
than trace the standard loss in its place.

``--trace-dir`` also writes the profiled step's chrome trace there
(``*.pt.trace.json``), which ``cli/trace_summary`` reads. Prints a table of
the top ops and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from raft_tpu_torch.cli._args import add_corr_args, corr_overrides
from raft_tpu_torch.cli._measure import device_info, sync


def busy_ms(events) -> float:
    """Milliseconds in which at least one of ``events`` (profiler events
    with a ``time_range`` in µs) ran: the union of their intervals, so
    kernels that overlap on cuDNN's own streams count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile_one(step, dev: torch.device, top: int):
    """One call of ``step`` under ``torch.profiler``: (the profiler, wall
    ms, device busy ms or None on the CPU, the top ops as dicts)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    if dev.type == "cuda":
        cuda = torch.autograd.DeviceType.CUDA
        busy = busy_ms([e for e in prof.events() if e.device_type == cuda])
        ops = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages() if e.device_type == cuda]
    else:
        busy = None
        ops = [(e.key, e.self_cpu_time_total, e.count)
               for e in prof.key_averages()]
    ops = sorted(ops, key=lambda o: -o[1])[:top]
    return prof, wall, busy, [{"name": k, "ms": us / 1e3, "count": n}
                              for k, us, n in ops]


def main(argv=None) -> dict:
    """Run the profile; returns the numbers of the JSON line."""
    p = argparse.ArgumentParser(description="profile the train step")
    p.add_argument("--batch", type=int, default=6)
    p.add_argument("--hw", type=int, nargs=2, default=[368, 496])
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--top", type=int, default=15,
                   help="ops in the table, by device time")
    add_corr_args(p)
    p.add_argument("--small", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat_policy", "--remat-policy", default=None,
                   choices=["full", "dots"],
                   help="remat granularity (with --remat)")
    p.add_argument("--fused_loss", "--fused-loss",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="loss path to trace; default None = the config's "
                        "auto (fused for the basic model), as default "
                        "training runs; --no-fused-loss traces the "
                        "full-resolution sequence loss")
    p.add_argument("--fp32", action="store_true",
                   help="disable bf16 mixed precision")
    p.add_argument("--trace-dir", default=None,
                   help="write the profiled step's chrome trace here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    args = p.parse_args(argv)
    args.warmup, args.steps = max(1, args.warmup), max(1, args.steps)
    if args.fused_loss and args.small:
        raise ValueError("--fused_loss with --small: the small model has no "
                         "fused loss (its upsampling is a plain 8x "
                         "interpolate), so the step would trace the standard "
                         "loss instead")

    from raft_tpu_torch import kernels
    from raft_tpu_torch.config import RAFTConfig, stage_config
    from raft_tpu_torch.evaluation.evaluate import resolve_device
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    dev = resolve_device(args.device)
    overrides = corr_overrides(args)
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy
    model_cfg = RAFTConfig(small=args.small, mixed_precision=not args.fp32,
                           remat=args.remat, **overrides)
    train_cfg = stage_config("chairs", batch_size=args.batch,
                             iters=args.iters, validation=(),
                             fused_loss=args.fused_loss)
    h, w = args.hw
    t0 = time.perf_counter()
    model = RAFT(model_cfg, torch.Generator().manual_seed(args.seed))
    state = create_train_state(model.to(dev), train_cfg)
    step = make_train_step(model_cfg, train_cfg)
    rng = np.random.RandomState(args.seed)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "image1": rng.rand(args.batch, h, w, 3).astype(np.float32) * 255,
        "image2": rng.rand(args.batch, h, w, 3).astype(np.float32) * 255,
        "flow": rng.randn(args.batch, h, w, 2).astype(np.float32),
        "valid": np.ones((args.batch, h, w), np.float32)}.items()}
    print(f"device={dev} batch={args.batch} hw={h}x{w} iters={args.iters} "
          f"bf16={not args.fp32} remat={args.remat} "
          f"remat_policy={model_cfg.remat_policy} fused_loss="
          f"{'auto' if args.fused_loss is None else args.fused_loss} "
          f"corr_impl={model_cfg.corr_impl} gru_impl={model_cfg.gru_impl}; "
          f"set-up {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    for _ in range(args.warmup):
        step(state, batch)
    sync(dev)
    print(f"warm-up ({args.warmup} steps): {time.perf_counter() - t0:.1f}s",
          flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    ms = []
    for _ in range(args.steps):
        sync(dev)
        t0 = time.perf_counter()
        metrics = step(state, batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v / args.steps
                for k, v in kernels.launch_counts().items() if v}
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
            if dev.type == "cuda" else None)
    med = float(np.median(ms))
    print(f"steps: median {med:.2f} ms of {args.steps} ({args.batch / med * 1e3:.2f}"
          f" pairs/s), loss {float(metrics['loss']):.4f}", flush=True)

    prof, wall, busy, top = profile_one(lambda: step(state, batch), dev,
                                        args.top)
    trace = None
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        trace = os.path.join(args.trace_dir,
                             f"profile_step.{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(trace)
        print(f"trace written to {trace}", flush=True)
    idle = None if busy is None else 1.0 - busy / wall
    print(f"one step profiled: wall {wall:.2f} ms, device busy "
          f"{'not measured (CPU)' if busy is None else f'{busy:.2f} ms'}, "
          f"idle share {'n/a' if idle is None else f'{idle:.3f}'}; top ops "
          f"by {'device' if busy is not None else 'CPU'} time:", flush=True)
    for op in top:
        print(f"  {op['ms']:9.3f} ms  x{op['count']:<5d} {op['name'][:100]}",
              flush=True)
    out = {"metric": "profile_step", **device_info(dev),
           "batch": args.batch, "hw": [h, w], "iters": args.iters,
           "bf16": not args.fp32, "small": args.small,
           "remat": args.remat, "remat_policy": model_cfg.remat_policy,
           "fused_loss": args.fused_loss,
           "corr_impl": model_cfg.corr_impl, "gru_impl": model_cfg.gru_impl,
           "ms_per_step": med, "ms_steps": ms,
           "pairs_per_s": args.batch / med * 1e3, "peak_mib": peak,
           "profiled_wall_ms": wall, "device_busy_ms": busy,
           "idle_share": idle, "launches_per_step": launches,
           "top_ops": top, "trace": trace}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
