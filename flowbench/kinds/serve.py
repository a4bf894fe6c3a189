"""The serving cells: frame pairs offered to ``MicroBatchScheduler.submit``
by the mix's loop (``flowbench/loops/<loop>.py``), the window timed by the
host clock, and a sample of the finished futures' flows held against the
reference.

A traffic mix of kind ``serve`` names (all read from its file):

- ``frames``: ``[H, W]``, the request's frame size (Sintel's frames resized
  to it where it differs);
- ``buckets``: the engine's batch sizes at the ÷8-padded frame size, all
  captured in set-up; ``max_batch``, ``pipeline_depth``, ``max_queue``:
  the scheduler's;
- ``loop``: the module that offers the requests, and that module's own
  parameters (``clients`` for ``closed``; ``rate`` and ``arrival_seed``
  for ``poisson``).

Every serving run reports ``pairs_per_s`` (the pairs whose futures resolved
in the window over its seconds) and ``latency_p95_ms`` (over every finished
request, from the time it was due to the resolution of its future); a cell
reports those of the two that ``BENCHMARK.json`` lists for it.
"""

from __future__ import annotations

import gc
import queue
import random
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from flowbench import check, counts, frames, spec, trace
from flowbench.reference import raft as ref_raft
from flowbench.weights import derive_seed, make_weights

#: the pairs, drawn from the seed, that requests cycle through
POOL = 64
#: the finished requests the reference checks: a sample drawn from the seed
SAMPLE = 16
#: the pairs the reference runs at once (its memory, not the load)
CHECK_BATCH = 4
#: the seconds of load a traced run profiles
TRACE_SECONDS = 4


def padded(size) -> Tuple[int, int]:
    return tuple(-(-s // 8) * 8 for s in size)


class Load:
    """Offers a mix's requests to the scheduler and records each one's
    due time, resolution time, outcome and (for a reservoir sample drawn
    from the seed) its flow."""

    def __init__(self, sched, pool, order, sample: int, seed: int):
        self.sched, self.pool, self.order = sched, pool, order
        self.k = sample
        self.rng = random.Random(derive_seed(seed, 5))
        self.lock = threading.Lock()
        self.done: List[Tuple[int, float, float, bool]] = []
        self.kept: List[Tuple[int, np.ndarray]] = []
        self.seen = 0
        self.sent = 0
        self.events: "queue.SimpleQueue" = queue.SimpleQueue()

    def send(self, due: float, tag=None) -> None:
        i = self.sent
        self.sent += 1
        im1, im2 = self.pool[self.order[i % len(self.order)]]
        try:
            fut = self.sched.submit(im1, im2)
        except Exception as exc:           # refused at intake
            self._record(i, due, time.perf_counter(), exc, tag)
            return
        fut.add_done_callback(
            lambda f: self._record(i, due, time.perf_counter(), f, tag))

    def _record(self, i, due, t_done, fut, tag) -> None:
        ok = not isinstance(fut, Exception) and fut.exception() is None
        with self.lock:
            self.done.append((i, due, t_done, ok))
            if ok:
                self.seen += 1
                # reservoir sampling (algorithm R) over the finished pairs
                if len(self.kept) < self.k:
                    self.kept.append((i, fut.result().flow))
                else:
                    j = self.rng.randrange(self.seen)
                    if j < self.k:
                        self.kept[j] = (i, fut.result().flow)
        self.events.put(tag)


def launch_bounds(arch: Dict, bucket_dispatches: Dict[Tuple[int, int, int],
                                                      int], iters: int):
    """(launches, least seconds of one) of K1 and K2 for each bucket the
    slice dispatched: ``iters`` K1 launches a replay, and the basic
    model's two GRU halves each a gates and a blend launch a step."""
    out: Dict[str, list] = {"k1": [], "k2": []}
    for (b, h, w), n in bucket_dispatches.items():
        hw8 = (h // 8, w // 8)
        k1 = counts.lookup_cost(b, hw8, arch["corr_levels"],
                                arch["corr_radius"])
        out["k1"].append((n * iters, trace.kernel_bound(k1)))
        if not arch["small"]:
            g = trace.kernel_bound(counts.gates_cost(b, arch["hidden_dim"],
                                                     hw8))
            bl = trace.kernel_bound(counts.blend_cost(b, arch["hidden_dim"],
                                                      hw8))
            out["k2"].append((2 * n * iters, g))
            out["k2"].append((2 * n * iters, bl))
    return out


def _bucket_counts(before: Dict, after: Dict) -> Dict:
    out = {}
    for label, b in after["buckets"].items():
        n = b["dispatches"] - before["buckets"].get(label, {}).get(
            "dispatches", 0)
        if n:
            out[tuple(int(x) for x in label.split("x"))] = n
    return out


def build(cell, seed: int, device, stages: Dict, t_process: float):
    """The system under test for one run, warmed: the weights and the
    pool drawn from ``seed``, the engine with every bucket captured, the
    scheduler, and a warm-up of each bucket's replay through it. Returns
    (scheduler, engine, weights, pool, order)."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.serving.engine import RAFTEngine
    from raft_tpu_torch.serving.scheduler import MicroBatchScheduler

    stages["import_port"] = time.perf_counter() - t_process
    cfg, tr = cell.config, cell.traffic
    arch, prog = cfg["architecture"], cfg["program"]
    check.set_precision(cfg["serve"]["precision"])
    size = tuple(tr["frames"])
    hp, wp = padded(size)
    weights = make_weights(arch, seed, device)
    stages["weights"] = time.perf_counter() - t_process
    pool = frames.serve_pool(frames.sintel_frames(), size, POOL, seed, device)
    stages["inputs"] = time.perf_counter() - t_process
    order = np.random.default_rng(derive_seed(seed, 3)).integers(
        0, len(pool), size=4096)
    engine = RAFTEngine(
        weights, config=RAFTConfig(
            small=arch["small"],
            mixed_precision=cfg["serve"]["mixed_precision"], **prog),
        iters=cfg["serve"]["iters"],
        envelope=[(b, hp, wp) for b in tr["buckets"]], wire="u8",
        precompile=True, device=str(device))
    sched = MicroBatchScheduler(engine, max_queue=tr["max_queue"],
                                max_batch=tr["max_batch"],
                                pipeline_depth=tr["pipeline_depth"])
    stages["engine"] = time.perf_counter() - t_process
    warm = Load(sched, pool, order, 0, seed)
    for burst in (1, 2, 3, 4, tr["max_batch"] * 4, tr["max_batch"] * 4):
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
    hp, wp = padded(tr["frames"])
    sched, engine, weights, pool, order = build(cell, seed, device, stages,
                                                t_process)
    setup_s = time.perf_counter() - t_process

    window = TRACE_SECONDS if traced else seconds
    load = Load(sched, pool, order, SAMPLE, seed)
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
        busy = trace.union_s(sl.events)
        filled = (after["occupancy"]["filled"]
                  - before["occupancy"]["filled"])
        slots = (after["occupancy"]["capacity"]
                 - before["occupancy"]["capacity"])
        out["ctx"] = {
            "events": sl.events, "window_s": sl.window_s, "busy_s": busy,
            "occupancy": 100.0 * filled / slots if slots else None,
            "pairs": len(ok),
            "flops_per_pair": counts.forward_flops(arch, (hp, wp),
                                                   serve_cfg["iters"]),
            "peak_flops": counts.PEAKS[serve_cfg["peak"]],
            "launch_bounds": launch_bounds(
                arch, _bucket_counts(before, after), serve_cfg["iters"]),
        }
    kept = sorted(load.kept)
    sched.close(drain=True)
    del sched, engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pairs = [pool[order[i % len(order)]] for i, _ in kept]
    gaps = reference_gaps(cell, weights, pairs, [f for _, f in kept], device)
    stages["reference"] = time.perf_counter() - t_process
    worst = max(gaps) if gaps else float("inf")
    out["checks"] = check.judged({"worst_pair_epe_px": worst},
                                 check.limits(cell.name, cell.root))
    return out


def reference_gaps(cell, weights, pairs, flows, device) -> List[float]:
    """Each pair's served flow against the reference's, as the mean
    endpoint distance in pixels. The reference runs in float32 with TF32
    off, in blocks of :data:`CHECK_BATCH` pairs."""
    cfg = cell.config
    step = CHECK_BATCH
    gaps = []
    with check.reference_precision():
        model = ref_raft.RAFT(cfg["architecture"]).to(device).eval()
        model.load_state_dict(weights)
        for j in range(0, len(pairs), step):
            im1 = torch.from_numpy(np.stack([p[0] for p in pairs[j:j + step]]))
            im2 = torch.from_numpy(np.stack([p[1] for p in pairs[j:j + step]]))
            want = ref_raft.infer(model, im1.to(device), im2.to(device),
                                  cfg["serve"]["iters"]).cpu().numpy()
            gaps += [check.epe(g, w) for g, w in zip(flows[j:j + step], want)]
        del model
    return gaps
