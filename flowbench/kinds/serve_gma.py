"""The GMA serving cells: ``flowbench.kinds.serve``'s load, window and
sample, with GMA's weights (``flowbench.weights_gma``), its plain reference
(``flowbench.reference.gma``) and its counts (``flowbench.counts_gma``).

A traffic mix of kind ``serve_gma`` names what a ``serve`` mix names
(``frames``, ``buckets``, ``max_batch``, ``pipeline_depth``,
``max_queue``, ``loop`` and its parameters); its configuration's
``architecture`` block carries ``gma_heads``. The engine and the scheduler
are the port's own (``RAFTEngine`` with ``RAFTConfig(gma_heads=...)``,
``MicroBatchScheduler``), every bucket captured in set-up. The reference
runs one pair at a time: at 1080p a pair's attention and correlation
volume take about 16 GB.

The traced context adds to ``serve``'s keys ``gma_launch_bounds`` (K6 and
K7, for ``flowbench.counts_gma``'s readers); ``flops_per_pair`` counts
GMA's forward.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from flowbench import check, counts, counts_gma, frames, spec, trace
from flowbench.kinds import serve
from flowbench.reference import gma as ref_gma
from flowbench.reference.raft import Conv
from flowbench.weights import derive_seed
from flowbench.weights_gma import make_weights

#: the pairs the reference runs at once (its memory, not the load)
CHECK_BATCH = 1


def build(cell, seed: int, device, stages: Dict, t_process: float):
    """The system under test for one run, warmed, as ``serve.build`` makes
    it. Returns (scheduler, engine, weights, pool, order)."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.serving.engine import RAFTEngine
    from raft_tpu_torch.serving.scheduler import MicroBatchScheduler

    cfg, tr = cell.config, cell.traffic
    arch = cfg["architecture"]
    # first, before anything is made: a port without GMA raises TypeError
    config = RAFTConfig(small=arch["small"], gma_heads=arch["gma_heads"],
                        mixed_precision=cfg["serve"]["mixed_precision"],
                        **cfg["program"])
    stages["import_port"] = time.perf_counter() - t_process
    check.set_precision(cfg["serve"]["precision"])
    hp, wp = serve.padded(tr["frames"])
    weights = make_weights(arch, seed, device)
    stages["weights"] = time.perf_counter() - t_process
    pool = frames.serve_pool(frames.sintel_frames(), tuple(tr["frames"]),
                             serve.POOL, seed, device)
    stages["inputs"] = time.perf_counter() - t_process
    order = np.random.default_rng(derive_seed(seed, 3)).integers(
        0, len(pool), size=4096)
    engine = RAFTEngine(weights, config=config, iters=cfg["serve"]["iters"],
                        envelope=[(b, hp, wp) for b in tr["buckets"]],
                        wire="u8", precompile=True, device=str(device))
    sched = MicroBatchScheduler(engine, max_queue=tr["max_queue"],
                                max_batch=tr["max_batch"],
                                pipeline_depth=tr["pipeline_depth"])
    stages["engine"] = time.perf_counter() - t_process
    warm = serve.Load(sched, pool, order, 0, seed)
    for burst in (1, 2, tr["max_batch"] * 2, tr["max_batch"] * 2):
        for _ in range(burst):
            warm.send(0.0)
        for _ in range(burst):
            warm.events.get(timeout=600.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stages["warm"] = time.perf_counter() - t_process
    return sched, engine, weights, pool, order


def run(cell, seed: int, seconds: int, traced: bool, device,
        t_process: float, stages: Dict) -> Dict:
    """One serving run; see :mod:`flowbench.kinds` for what it returns."""
    cfg, tr = cell.config, cell.traffic
    arch, serve_cfg = cfg["architecture"], cfg["serve"]
    loop = spec.find("loops", tr["loop"])
    hp, wp = serve.padded(tr["frames"])
    sched, engine, weights, pool, order = build(cell, seed, device, stages,
                                                t_process)
    setup_s = time.perf_counter() - t_process

    window = serve.TRACE_SECONDS if traced else seconds
    load = serve.Load(sched, pool, order, serve.SAMPLE, seed)
    before = sched.metrics.snapshot()
    with trace.Slice(device, traced) as sl:
        t0, t1, notes = loop.offer(load, tr, window, seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    after = sched.metrics.snapshot()
    stages["window"] = time.perf_counter() - t_process
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    done = sorted(load.done)
    ok = [d for d in done if d[3]]
    in_window = sum(1 for d in ok if t0 <= d[2] <= t1)
    out = {"setup_s": setup_s, "attempted": len(done),
           "failed": len(done) - len(ok), "peak_bytes": peak,
           "notes": dict(notes, window_s=t1 - t0, in_window=in_window)}
    if ok and not traced:
        lat = [1e3 * (d[2] - d[1]) for d in ok]
        out["e2e"] = {"pairs_per_s": in_window / (t1 - t0),
                      "latency_p95_ms": float(np.percentile(lat, 95))}
    if traced:
        dispatched = serve._bucket_counts(before, after)
        filled = (after["occupancy"]["filled"]
                  - before["occupancy"]["filled"])
        slots = (after["occupancy"]["capacity"]
                 - before["occupancy"]["capacity"])
        out["ctx"] = {
            "events": sl.events, "window_s": sl.window_s,
            "busy_s": trace.union_s(sl.events),
            "occupancy": 100.0 * filled / slots if slots else None,
            "pairs": len(ok),
            "flops_per_pair": counts_gma.gma_forward_flops(
                arch, (hp, wp), serve_cfg["iters"]),
            "peak_flops": counts.PEAKS[serve_cfg["peak"]],
            "launch_bounds": serve.launch_bounds(arch, dispatched,
                                                 serve_cfg["iters"]),
            "gma_launch_bounds": counts_gma.launch_bounds(
                dispatched, serve_cfg["iters"], arch["dim_head"]),
        }
    kept = sorted(load.kept)
    sched.close(drain=True)
    del sched, engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pairs = [pool[order[i % len(order)]] for i, _ in kept]
    numbers = reference_numbers(cell, weights, pairs,
                                [f for _, f in kept], device)
    stages["reference"] = time.perf_counter() - t_process
    for name in ("worst_pair_epe_px", "worst_pair_over_witness"):
        out["notes"][name] = numbers[name]
    out["checks"] = check.judged(numbers, check.limits(cell.name, cell.root))
    return out


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (float32 with a 10-bit mantissa, to nearest,
    ties away from zero), as TF32 convolutions read their operands."""
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def reference_flows(cell, weights, pairs, device, quantize=None,
                    conv_quantize=None) -> List[np.ndarray]:
    """The reference's flow of each pair, float32 with TF32 off (or with
    ``quantize`` rounding its operands, or ``conv_quantize`` the
    convolutions' alone), :data:`CHECK_BATCH` pairs at a time."""
    cfg = cell.config
    flows = []
    with check.reference_precision():
        model = ref_gma.GMA(cfg["architecture"], quantize).to(device).eval()
        if conv_quantize is not None:
            for m in model.modules():
                if isinstance(m, Conv):
                    m.quantize = conv_quantize
        model.load_state_dict(weights)
        for j in range(0, len(pairs), CHECK_BATCH):
            block = pairs[j:j + CHECK_BATCH]
            im1 = torch.from_numpy(np.stack([p[0] for p in block]))
            im2 = torch.from_numpy(np.stack([p[1] for p in block]))
            flows += list(ref_gma.infer(model, im1.to(device), im2.to(device),
                                        cfg["serve"]["iters"]).cpu().numpy())
        del model
    return flows


def witness_ratio(flows, want, witness) -> float:
    """The summed mean endpoint distance of ``flows`` from ``want`` over
    that of ``witness`` from ``want``."""
    gaps = sum(check.epe(f, w) for f, w in zip(flows, want))
    spread = sum(check.epe(t, w) for t, w in zip(witness, want))
    return gaps / spread if spread > 0 else float("inf")


def worst_pair_ratio(flows, want, witness) -> float:
    """The endpoint distance of the pair of ``flows`` farthest from
    ``want`` over that same pair's distance of ``witness`` from ``want``."""
    gaps = [check.epe(f, w) for f, w in zip(flows, want)]
    i = int(np.argmax(gaps))
    spread = check.epe(witness[i], want[i])
    return gaps[i] / spread if spread > 0 else float("inf")


def reference_numbers(cell, weights, pairs, flows, device) -> Dict:
    """The served flows against the float32 reference's (TF32 off):

    - ``worst_pair_epe_px``: the worst pair's mean endpoint distance;
    - ``epe_over_witness``: the pairs' mean endpoint distances summed, over
      the same sum for the witness: the reference with every
      convolution's operands rounded to TF32, the precision the
      configuration states for them (:func:`tf32`, the same on any
      device). GMA's sharp attention passes the rounding of its logits on
      into every step, and how far the 20 steps carry it apart depends on
      the seed's weights (the absolute distance spread 27-fold over 12
      seeds, more than the float32 program stands from its bfloat16
      path); the witness rounds at the stated precision on the same
      weights and pairs, so the ratio holds the program to that
      precision whatever the seed;
    - ``worst_pair_over_witness``: the worst pair's distance over that
      pair's witness distance (:func:`worst_pair_ratio`): the seed's
      normalisation without the sum, which would thin an error that only
      one pair or slot of a batch shows about sixteen times.
    """
    if not pairs:
        return {"worst_pair_epe_px": float("inf"),
                "epe_over_witness": float("inf"),
                "worst_pair_over_witness": float("inf")}
    want = reference_flows(cell, weights, pairs, device)
    witness = reference_flows(cell, weights, pairs, device,
                              conv_quantize=tf32)
    return {"worst_pair_epe_px": max(check.epe(f, w)
                                     for f, w in zip(flows, want)),
            "epe_over_witness": witness_ratio(flows, want, witness),
            "worst_pair_over_witness": worst_pair_ratio(flows, want, witness)}
