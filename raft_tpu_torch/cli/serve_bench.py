"""Synthetic ragged-traffic drill for the serving front-end; port of
``raft_tpu/cli/serve_bench.py``'s single-model drills.

Drives ``MicroBatchScheduler`` + a warm-start ``RAFTEngine`` with
mixed-shape traffic from concurrent submitter threads (plus optional
per-stream video sessions) and prints ONE JSON summary line last, with
the JAX package's keys for the same flags. The request mix is
deliberately ragged: per-shape totals that don't divide the bucket
batch leave a tail the scheduler must batch-fill into the SAME programs
the full micro-batches used. On the card every micro-batch is one
replay of its bucket's captured CUDA graph.

On the card (the basic model at full width with weights seeded from
``--seed``, cvt2trt-ish shapes)::

    python -m raft_tpu_torch.cli.serve_bench --shapes 440x1024,368x496 \\
        --requests 48 --submitters 2 --bucket-batch 4 --wire u8 \\
        --gru_impl fused

and on the CPU at tiny shapes (``--device cpu``)::

    python -m raft_tpu_torch.cli.serve_bench --device cpu --small \\
        --shapes 64x64,48x48 --requests 8 --iters 2

``--wire u8`` / ``--pipeline-depth 2`` / ``--device-state`` arm the
zero-copy hot path (uint8 wire, pipelined dispatch, device-resident
session state); the summary line then carries the A/B surface —
``h2d_bytes_per_req``, ``dispatch_gap_{mean,p50,p99}_ms``,
``overlap_ratio`` — against a baseline run of the same traffic.

``--feature-cache`` arms the cross-frame device feature cache
(serving/feature_cache): video sessions serve through the CACHED
bucket signature — steady-state pairs cost ONE encoder pass and ship
ONE frame of H2D — and the summary grows ``warm_pairs_per_s``,
``cache_hit_rate``, ``cache_evictions``. The video-heavy traffic mode
is ``--requests 0 --sessions M --session-frames N``; run the SAME line
with and without the flag for the A/B.

``--ragged`` (+ ``--capacity-classes HxW,...``) serves the SAME mixed
traffic through ONE capacity-class program instead of one bucket per
distinct HxW: the ragged descriptor (serving/ragged) masks each row to
its own extent and the scheduler coalesces across shapes. The summary
grows ``capacity_fill``/``cross_shape_coalesce_rate``/
``padding_waste_ratio`` and the A/B against the bucketed baseline is
``executables`` (O(1) vs O(shapes)) on identical traffic.

``--chaos N`` instead runs N rounds of randomized fault plans
(raise/hang at ``serve.request`` / ``serve.dispatch_exec`` /
``engine.compile``, seeded probabilities and nth-call scoping) through
the full resilience stack — dispatch watchdog, per-bucket breakers,
engine drop + recapture — and asserts the drill invariants after every
round: every accepted future settled (zero stranded), the accounting
identity submitted == completed + failed + deadline_missed + cancelled,
abandoned_inflight == 0, and health() consistent with the breaker
board. A final fault-free round proves recovery: health back to
healthy and the executable count back at the documented bucket count.

``--trace-path`` (+ ``--trace-sample R``) arms request-scoped tracing
(serving/trace.py): every accepted request's span appends to the
given spans.jsonl (tail exemplars and failures always kept), the
summary line grows a ``tail_exemplars`` block (top-bucket span refs +
the serve_trace phase attribution over them), and under ``--chaos``
the drill additionally pins ZERO orphan spans. Read the file back with
``python -m raft_tpu_torch.cli.serve_trace``.

The multi-model flags (``--models``, ``--canary``, ``--guardian``,
``--slo``, ``--bake-ms``, ``--admission-*``), the fleet flags
(``--replicas``, ``--replica-ceiling``, ``--hosts``,
``--hosts-kill-one``) and ``--aot-cache`` parse as in the JAX package
and exit naming ROADMAP M11b, where the layers they drive are queued.
"""


from __future__ import annotations

import argparse
import json
import os
import random
import threading
import time
from concurrent.futures import wait as futures_wait

import numpy as np
import torch


def _ceil8(x: int) -> int:
    return -(-x // 8) * 8


#: the chaos sites the randomized plans draw from — the serving path's
#: three distinct hang/failure surfaces (device call, executor worker,
#: graph capture)
CHAOS_SITES = ("serve.request", "serve.dispatch_exec", "engine.compile")
#: at pipeline_depth > 1 the blocking fetch moves to the completion
#: stage — its own hang surface, so pipelined chaos draws it too
CHAOS_SITES_PIPELINED = CHAOS_SITES + ("serve.fetch",)

def chaos_plan(rng: random.Random, hang_s: float = 0.5,
               sites=CHAOS_SITES) -> dict:
    """One randomized-but-deterministic fault plan: per site, maybe an
    entry with randomized kind (raise/hang), first eligible occurrence
    (``at``), fire budget (``count``) and per-call probability
    (``p``). ``crash`` is deliberately excluded here — an in-process
    drill can't assert anything after ``os._exit``; the crash class is
    the training supervisor's drill."""
    faults = []
    for site in sites:
        if rng.random() < 0.25:
            continue  # site spared this round
        faults.append({
            "site": site,
            "kind": "hang" if rng.random() < 0.4 else "raise",
            "at": rng.randint(1, 3),
            "count": rng.randint(1, 3),
            "p": round(rng.uniform(0.3, 0.9), 3),
            "hang_s": hang_s,
        })
    return {"seed": rng.randrange(1 << 16), "faults": faults}


def _trace_file_view(trace_path):
    """The serve_trace read-back over one spans file — the
    whole-file phase attribution + top-bucket membership every drill
    summary assembles the same way."""
    from raft_tpu_torch.cli.serve_trace import (load_spans,
                                                phase_attribution,
                                                top_bucket_membership)
    spans = (load_spans(trace_path)
             if trace_path and os.path.exists(trace_path) else [])
    return {"phase_attribution": phase_attribution(spans),
            "top_bucket": top_bucket_membership(spans)}


def _fresh_trace_file(trace_path):
    """Start a drill's spans file FRESH. The summary reads the whole
    file back, and a new ledger restarts its trace ids at r-1 — a
    reused --trace-path would mix a previous run's spans into this
    run's attribution AND duplicate ids (metrics.jsonl appends by
    convention; spans.jsonl is per-run evidence)."""
    if trace_path and os.path.exists(trace_path):
        os.remove(trace_path)


def _capacity_envelope(shapes, capacity_classes, bucket_batch):
    """The ragged engine's class list: the explicit ``--capacity-classes``
    boxes, or one box covering every drill shape (one program for the
    whole mix)."""
    if capacity_classes:
        return sorted({(bucket_batch, _ceil8(h), _ceil8(w))
                       for h, w in capacity_classes})
    return [(bucket_batch, max(_ceil8(h) for h, _ in shapes),
             max(_ceil8(w) for _, w in shapes))]


def run_drill(weights, cfg, *, shapes, requests=32, submitters=2,
              bucket_batch=4, iters=2, sessions=0, session_frames=4,
              deadline_s=None, max_queue=64, gather_window_s=0.005,
              dispatch_timeout_s=None, breaker_failures=0,
              breaker_backoff_s=0.25, breaker_backoff_max_s=30.0,
              wire="f32", pipeline_depth=1, session_device_state=False,
              feature_cache=False, cache_capacity=256,
              ragged=False, capacity_classes=None,
              fault_plan=None, recover_s=0.0,
              metrics_path=None, trace_path=None, trace_sample=1.0,
              tracer=None, seed=0, engine=None, device="cuda"):
    """The drill as a library call (tests reuse it, and may pass a
    prebuilt warm-start ``engine`` to share captures across drills).
    Returns the summary dict the CLI prints. ``weights``: a ``RAFT``
    module or its state dict; the engine runs on ``device`` (the card
    unless ``"cpu"`` is asked for).

    ``fault_plan`` arms the fault harness for this drill only (disarmed
    in a finally). ``recover_s`` > 0 runs a post-traffic recovery
    phase: per shape, retry probes until one serves or the budget runs
    out — the half-open probe path that closes an opened breaker and
    lazily recaptures a dropped bucket.

    ``feature_cache=True`` arms the cross-frame device feature cache
    (engine cached signature + scheduler pool of ``cache_capacity``
    slots) and runs every video session through it — the video-warm
    A/B: same traffic with the flag off is the baseline the
    ``warm_pairs_per_s``/``cache_hit_rate`` summary fields compare
    against.

    ``ragged=True`` captures ONE capacity-class program
    (``capacity_classes`` boxes, default: one box covering every drill
    shape) instead of one bucket per distinct HxW, and the scheduler
    coalesces ACROSS shapes into it — the A/B against the same traffic
    without the flag compares ``executables`` (O(1) vs O(shapes)),
    ``capacity_fill``, ``cross_shape_coalesce_rate`` and
    ``padding_waste_ratio``.

    ``trace_path`` arms request-scoped tracing (serving/trace.py):
    spans append there under ``trace_sample`` with always-keep-tail
    exemplars, and the summary grows a ``tail_exemplars`` block (the
    top-bucket span refs + the serve_trace phase attribution over
    them + the ledger counters). ``tracer`` injects a prebuilt ledger
    (the chaos harness shares ONE across rounds so trace ids stay
    unique in the shared file). Default off: summary byte-identical
    to the untraced drill."""
    from raft_tpu_torch.ops.interp import forward_interpolate_device
    from raft_tpu_torch.serving.engine import RAFTEngine
    from raft_tpu_torch.serving.feature_cache import FeatureCacheMiss
    from raft_tpu_torch.serving.resilience import (CircuitOpen,
                                                   DispatchWedged)
    from raft_tpu_torch.serving.scheduler import (BackpressureError,
                                                  DeadlineExceeded,
                                                  MicroBatchScheduler)
    from raft_tpu_torch.serving.session import VideoSession
    from raft_tpu_torch.testing import faults

    if ragged and feature_cache:
        raise ValueError("--ragged with --feature-cache is not "
                         "supported yet (the cached signature keeps "
                         "per-shape buckets)")
    if engine is None:
        if ragged:
            # ONE documented program per capacity class — the whole
            # mixed-shape drill rides it
            engine = RAFTEngine(
                weights, cfg, iters=iters, precompile=True,
                warm_start=True, wire=wire, ragged=True,
                capacity_classes=_capacity_envelope(
                    shapes, capacity_classes, bucket_batch),
                device=device)
        else:
            # one documented bucket per distinct ÷8-padded request shape
            envelope = sorted({(bucket_batch, _ceil8(h), _ceil8(w))
                               for h, w in shapes})
            engine = RAFTEngine(weights, cfg, iters=iters,
                                envelope=envelope, precompile=True,
                                warm_start=True, wire=wire,
                                feature_cache=feature_cache,
                                device=device)
    _n_exec = getattr(engine, "executable_count",
                      lambda: len(engine._compiled))
    documented = _n_exec()
    own_ledger = tracer is None and bool(trace_path)
    if own_ledger:
        from raft_tpu_torch.serving.trace import TraceLedger
        _fresh_trace_file(trace_path)
        tracer = TraceLedger(trace_path, sample_rate=trace_sample)
    sched = MicroBatchScheduler(engine, max_queue=max_queue,
                                max_batch=bucket_batch,
                                gather_window_s=gather_window_s,
                                dispatch_timeout_s=dispatch_timeout_s,
                                breaker_failures=breaker_failures,
                                breaker_backoff_s=breaker_backoff_s,
                                breaker_backoff_max_s=breaker_backoff_max_s,
                                breaker_rng=random.Random(seed),
                                pipeline_depth=pipeline_depth,
                                feature_cache=feature_cache,
                                feature_cache_capacity=cache_capacity,
                                ragged=ragged,
                                metrics_path=metrics_path,
                                tracer=tracer)
    if feature_cache and sessions:
        # warm-outside-the-measurement discipline (the engine's
        # envelope precompile, one layer up): the device forward warp's
        # first call per 1/8-res shape pays its one-off set-up here,
        # not inside the timed window the A/B compares
        for h, w in shapes:
            forward_interpolate_device(torch.zeros(
                (_ceil8(h) // 8, _ceil8(w) // 8, 2),
                device=getattr(engine, "device", "cpu")))
    futures = [[] for _ in range(submitters)]
    shed = [0] * submitters
    rejected = [0] * submitters
    session_stats = {"pairs": 0, "warm": 0, "errors": 0}
    recovery = {"probes": 0, "recovered": 0}

    def submit_loop(sid):
        rng = np.random.RandomState(seed + sid)
        per = requests // submitters + (1 if sid < requests % submitters
                                        else 0)
        for k in range(per):
            h, w = shapes[(sid + k) % len(shapes)]
            i1 = rng.rand(h, w, 3).astype(np.float32) * 255
            i2 = rng.rand(h, w, 3).astype(np.float32) * 255
            try:
                futures[sid].append(
                    sched.submit(i1, i2, deadline_s=deadline_s))
            except BackpressureError:
                shed[sid] += 1
            except CircuitOpen:
                rejected[sid] += 1

    def session_loop(sid):
        rng = np.random.RandomState(seed + 1000 + sid)
        h, w = shapes[sid % len(shapes)]
        sess = VideoSession(sched, deadline_s=deadline_s,
                            device_state=session_device_state,
                            feature_cache=feature_cache)
        futs = []
        for _ in range(session_frames + 1):
            try:
                futs.append(sess.submit_frame(
                    rng.rand(h, w, 3).astype(np.float32) * 255))
            except (BackpressureError, CircuitOpen,
                    FeatureCacheMiss):
                # a FeatureCacheMiss here is a failed re-prime (under
                # injected faults) or sustained capacity churn past
                # the session's bounded re-prime retries — counted
                # like any other lost pair
                session_stats["errors"] += 1
        for f in futs:
            if f is None:
                continue
            try:
                f.result(timeout=600)
                session_stats["pairs"] += 1
            except Exception:
                session_stats["errors"] += 1
        session_stats["warm"] += sess.warm_submits

    def recover_loop():
        """Per shape: probe until one request serves (the breaker's
        half-open round-trip + the dropped bucket's lazy recapture) or
        the budget expires."""
        rng = np.random.RandomState(seed + 5000)
        for h, w in shapes:
            t_end = time.monotonic() + recover_s
            while time.monotonic() < t_end:
                try:
                    fut = sched.submit(
                        rng.rand(h, w, 3).astype(np.float32) * 255,
                        rng.rand(h, w, 3).astype(np.float32) * 255)
                    recovery["probes"] += 1
                    fut.result(timeout=max(recover_s, 30.0))
                    recovery["recovered"] += 1
                    break
                except Exception:
                    time.sleep(0.05)

    threads = ([threading.Thread(target=submit_loop, args=(s,))
                for s in range(submitters)]
               + [threading.Thread(target=session_loop, args=(s,))
                  for s in range(sessions)])
    if fault_plan is not None:
        faults.arm(fault_plan)
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if recover_s > 0:
            recover_loop()
        # settle traffic before reading health: submit threads join as
        # soon as the queue has everything, and a health snapshot taken
        # mid-dispatch would report the PRE-outcome state (a wedge that
        # hasn't happened yet reads healthy — observed on a live drive)
        futures_wait([f for fl in futures for f in fl], timeout=600)
        health = sched.health()         # before close: live liveness
        sched.close(drain=True)         # settles every accepted request
    finally:
        if fault_plan is not None:
            faults.disarm()
    wall = time.perf_counter() - t0

    served = deadline_missed = wedged = circuit = errors = stranded = 0
    for fl in futures:
        for fut in fl:
            if not fut.done():
                stranded += 1   # close(drain=True) settles everything:
                continue        # nonzero == a stranded-future bug
            try:
                fut.result(timeout=0)
                served += 1
            except DeadlineExceeded:
                deadline_missed += 1
            except DispatchWedged:
                wedged += 1
            except CircuitOpen:
                circuit += 1
            except Exception:
                errors += 1
    rec = sched.metrics.snapshot(executables=_n_exec())
    total_served = served + session_stats["pairs"]
    occ = rec["occupancy"]
    rag = rec["ragged"]
    waste = rec["padding_waste"]
    accounted = (rec["completed"] + rec["failed"]
                 + rec["deadline_missed"] + rec["cancelled"])
    open_buckets = sum(1 for b in health["buckets"].values()
                       if b["state"] != "closed")
    hot = rec["hot_path"]
    fc = rec.get("feature_cache") or {}
    summary = {
        "wire": getattr(engine, "wire", "f32"),
        "pipeline_depth": pipeline_depth,
        "submitted": rec["submitted"],
        "accepted": sum(len(fl) for fl in futures),
        "served": served,
        "shed": sum(shed),
        "circuit_rejected": sum(rejected),
        "deadline_missed": deadline_missed,
        "errors": errors + session_stats["errors"],
        "failed_wedged": wedged,
        "failed_circuit": circuit,
        "stranded": stranded,
        "accounting_ok": rec["submitted"] == accounted,
        "abandoned_inflight": rec["abandoned_inflight"],
        "dispatches": rec["dispatches"],
        "executables": _n_exec(),
        "documented_buckets": documented,
        "mean_occupancy": occ["mean"],
        "baseline_occupancy": occ["one_per_dispatch_baseline"],
        # ragged A/B surface: ONE program per capacity class vs one
        # per shape, box fill, how often a dispatch mixed shapes, and
        # the padding waste both paths report comparably
        "ragged": bool(ragged),
        "capacity_fill": rag["capacity_fill"],
        "cross_shape_coalesce_rate": rag["cross_shape_coalesce_rate"],
        "padding_waste_ratio": waste["waste_ratio"],
        "session_pairs": session_stats["pairs"],
        "warm_submits": session_stats["warm"],
        "recovery_probes": recovery["probes"],
        "recovered_shapes": recovery["recovered"],
        "health_state": health["state"],
        "open_buckets": open_buckets,
        "wedged_dispatches": rec["resilience"]["wedged"],
        "quarantined_threads": rec["resilience"]["quarantined_threads"],
        "breaker_transitions": rec["resilience"]["breaker_transitions"],
        "p50_ms": rec["latency"]["p50_ms"],
        "p99_ms": rec["latency"]["p99_ms"],
        # hot-path A/B surface: wire bytes + dispatch-gap percentiles
        # (the --wire / --pipeline-depth rungs compare THESE lines)
        "h2d_bytes_per_req": hot["h2d_bytes_per_req"],
        "dispatch_gap_mean_ms": hot["dispatch_gap"]["mean_ms"],
        "dispatch_gap_p50_ms": hot["dispatch_gap"]["p50_ms"],
        "dispatch_gap_p99_ms": hot["dispatch_gap"]["p99_ms"],
        "overlap_ratio": hot["assembly"]["overlap_ratio"],
        # video-warm A/B surface (feature cache): warm throughput +
        # the pool's truth about whether streams actually stayed warm
        "feature_cache": bool(feature_cache),
        "warm_pairs_per_s": (round(session_stats["warm"] / wall, 2)
                             if wall else 0.0),
        "cache_hit_rate": fc.get("hit_rate", 0.0),
        "cache_evictions": fc.get("evictions", 0),
        "cache_occupancy": fc.get("occupancy", 0),
        "wall_s": round(wall, 3),
        "pairs_per_s": round(total_served / wall, 2) if wall else 0.0,
    }
    if tracer is not None:
        # request-tracing surface (key absent when tracing is off —
        # the summary stays byte-identical to the untraced drill):
        # top-bucket span refs from this run's metrics snapshot + its
        # raw accounting counters (the numbers the span classes must
        # reconcile against bucket-for-bucket; recovery probes
        # included — summary["served"] is not)
        summary["tail_exemplars"] = {
            "refs": (rec.get("tail_exemplars") or {}).get("refs", []),
            "accounting": {k: rec[k] for k in
                           ("submitted", "completed", "failed",
                            "deadline_missed", "cancelled")},
        }
        if own_ledger:
            # the ledger and spans file belong to this run alone:
            # counters and the serve_trace read-back are THIS run's.
            # Under a SHARED ledger (chaos rounds) both are
            # cumulative across rounds — the caller owns that view;
            # mixing it into a per-round block would sit cumulative
            # numbers next to per-round counters.
            summary["tail_exemplars"]["ledger"] = tracer.snapshot()
            summary["tail_exemplars"].update(
                _trace_file_view(tracer.path))
    return summary


def _round_violations(s: dict) -> list:
    """The chaos-drill invariants, checked after every round."""
    v = []
    if s["stranded"]:
        v.append(f"stranded futures: {s['stranded']}")
    if not s["accounting_ok"]:
        v.append("submitted != completed+failed+deadline_missed"
                 "+cancelled")
    if s["abandoned_inflight"]:
        v.append(f"abandoned_inflight: {s['abandoned_inflight']}")
    # injected FaultInjected raises land in "errors": settled futures,
    # accounted — not a violation, the drill injected them on purpose
    if s["health_state"] == "healthy" and s["open_buckets"]:
        v.append("health says healthy with open breakers")
    if s["health_state"] == "degraded" and not s["open_buckets"]:
        v.append("health says degraded with all breakers closed")
    return v


def run_chaos_drill(weights, cfg, *, shapes, rounds=3, requests=12,
                    submitters=2, bucket_batch=3, iters=1,
                    dispatch_timeout_s=0.4, hang_s=0.8,
                    breaker_failures=2, breaker_backoff_s=0.15,
                    breaker_backoff_max_s=0.6, recover_s=8.0,
                    gather_window_s=0.0, max_queue=64,
                    wire="f32", pipeline_depth=1, sessions=0,
                    session_frames=4, session_device_state=False,
                    feature_cache=False, cache_capacity=256,
                    ragged=False, capacity_classes=None,
                    deadline_s=None, seed=0, metrics_path=None,
                    trace_path=None, trace_sample=1.0, engine=None,
                    device="cuda"):
    """``rounds`` randomized fault rounds + one clean recovery round
    over ONE shared engine (dropped buckets recapture lazily across
    rounds), asserting the invariants after each. Returns the summary
    dict; ``violations`` is empty iff every invariant held.

    The engine runs ``exact_shapes=True`` so recovery is honest: a
    dropped bucket must recapture (it can't hide behind a spatially
    larger healthy bucket), pinning the documented program count
    after the final clean round. With ``ragged=True`` the wedge/drop/
    recapture cycle runs against the capacity-class table instead —
    the chaos passthrough the ragged path must survive unchanged.

    ``trace_path`` arms request tracing across EVERY round through
    ONE shared ledger (trace ids stay unique in the shared file), and
    the chaos invariants grow the span/accounting identity: zero open
    spans after the drill (every accepted request closed exactly one
    span) — the wedge/eviction/deadline outcome tags the test layer
    reconciles bucket-for-bucket.
"""
    from raft_tpu_torch.serving.engine import RAFTEngine

    if ragged and feature_cache:
        # same boundary as run_drill's: fail before the engine below
        # spends seconds capturing capacity classes
        raise ValueError("ragged=True with feature_cache=True is not "
                         "supported yet (see ROADMAP 'Ragged serving, "
                         "next bricks' (a))")
    rng = random.Random(seed)
    if engine is None:
        if ragged:
            classes = _capacity_envelope(shapes, capacity_classes,
                                         bucket_batch)
            if len(classes) > 1:
                # the recovery pin (executables == documented after
                # the clean round) needs every wedge-dropped class to
                # honestly recapture — with a spatially larger sibling
                # class, dropped-class traffic re-routes there and the
                # drop never restores (the ragged analog of why the
                # bucketed chaos branch forces exact_shapes=True)
                raise ValueError(
                    "--chaos --ragged needs a SINGLE capacity class "
                    "(the default one-covering-box, or one explicit "
                    f"--capacity-classes entry); got {classes}")
            cmax = classes[0]
            bad = [s for s in shapes if _ceil8(s[0]) > cmax[1]
                   or _ceil8(s[1]) > cmax[2]]
            if bad:
                # a shape outside the class would capture-on-miss a
                # new box AFTER the documented-count snapshot, failing
                # the same pin from the other direction
                raise ValueError(
                    f"--chaos --ragged: shapes {bad} exceed the "
                    f"capacity class {cmax}")
            engine = RAFTEngine(
                weights, cfg, iters=iters, precompile=True,
                warm_start=True, wire=wire, ragged=True,
                capacity_classes=classes, device=device)
        else:
            envelope = sorted({(bucket_batch, _ceil8(h), _ceil8(w))
                               for h, w in shapes})
            engine = RAFTEngine(weights, cfg, iters=iters,
                                envelope=envelope, precompile=True,
                                warm_start=True, exact_shapes=True,
                                wire=wire, feature_cache=feature_cache,
                                device=device)
    _n_exec = getattr(engine, "executable_count",
                      lambda: len(engine._compiled))
    documented = _n_exec()
    tracer = None
    if trace_path:
        from raft_tpu_torch.serving.trace import TraceLedger
        _fresh_trace_file(trace_path)
        tracer = TraceLedger(trace_path, sample_rate=trace_sample)
    per_round = []
    violations = []
    common = dict(shapes=shapes, requests=requests,
                  submitters=submitters, bucket_batch=bucket_batch,
                  iters=iters, deadline_s=deadline_s,
                  max_queue=max_queue, gather_window_s=gather_window_s,
                  dispatch_timeout_s=dispatch_timeout_s,
                  breaker_failures=breaker_failures,
                  breaker_backoff_s=breaker_backoff_s,
                  breaker_backoff_max_s=breaker_backoff_max_s,
                  pipeline_depth=pipeline_depth, sessions=sessions,
                  session_frames=session_frames,
                  session_device_state=session_device_state,
                  feature_cache=feature_cache,
                  cache_capacity=cache_capacity,
                  ragged=ragged, capacity_classes=capacity_classes,
                  recover_s=recover_s, metrics_path=metrics_path,
                  tracer=tracer, engine=engine, device=device)
    sites = (CHAOS_SITES_PIPELINED if pipeline_depth > 1
             else CHAOS_SITES)
    for r in range(rounds):
        plan = chaos_plan(rng, hang_s=hang_s, sites=sites)
        s = run_drill(weights, cfg, seed=seed + 17 * r,
                      fault_plan=plan, **common)
        s["round"] = r
        s["plan"] = plan
        per_round.append(s)
        violations += [f"round {r}: {v}" for v in _round_violations(s)]
    # the clean round: no faults — recovery must complete (health back
    # to healthy, every shape serving, executables at the documented
    # bucket count with no leaked duplicates from wedged recompiles).
    # The watchdog runs at a production-sized timeout here: the chaos
    # rounds' deliberately short deadline would verdict a legitimate
    # multi-second recapture of a dropped bucket as a wedge (the drill
    # self-heals — the quarantined thread's capture still lands via
    # first-insert-wins — but the round's traffic would fail), and the
    # clean round must prove full recovery, not re-inject noise
    clean = dict(common, dispatch_timeout_s=max(30.0,
                                                dispatch_timeout_s))
    s = run_drill(weights, cfg, seed=seed + 999, fault_plan=None,
                  **clean)
    s["round"] = "clean"
    per_round.append(s)
    violations += [f"clean round: {v}" for v in _round_violations(s)]
    if s["health_state"] != "healthy":
        violations.append(
            f"clean round: health {s['health_state']} != healthy")
    if s["served"] != s["accepted"]:
        violations.append("clean round: served != accepted traffic")
    if _n_exec() != documented:
        violations.append(
            f"executables {_n_exec()} != documented "
            f"{documented} after recovery (leaked/lost bucket)")
    if tracer is not None and tracer.open_count():
        violations.append(
            f"orphan spans: {tracer.open_count()} accepted requests "
            f"never closed a span ({tracer.open_ids()[:8]})")
    if feature_cache:
        # the pool must never leak past its bound — capacity is the
        # memory contract thousands of sessions lean on
        for p in per_round:
            if p["cache_occupancy"] > cache_capacity:
                violations.append(
                    f"round {p['round']}: cache occupancy "
                    f"{p['cache_occupancy']} > capacity "
                    f"{cache_capacity} (leaked slots)")
    totals = {k: sum(p[k] for p in per_round) for k in
              ("submitted", "served", "shed", "circuit_rejected",
               "deadline_missed", "failed_wedged", "failed_circuit",
               "errors", "wedged_dispatches", "quarantined_threads")}
    transitions = {k: sum(p["breaker_transitions"][k] for p in per_round)
                   for k in ("open", "half_open", "closed")}
    out = {
        "chaos_rounds": rounds,
        "violations": violations,
        "documented_buckets": documented,
        "executables": _n_exec(),
        "breaker_transitions": transitions,
        "totals": totals,
        "per_round": per_round,
    }
    if tracer is not None:
        # whole-drill trace view (the per-round blocks carry only
        # their OWN refs/accounting — the shared ledger counters and
        # spans file cover all rounds, so both live here, once)
        out["trace"] = tracer.snapshot()
        out["tail_exemplars"] = _trace_file_view(trace_path)
    return out




#: the JAX package's multi-model and fleet flags: they parse here and exit
#: naming ROADMAP M11b, where the layers they drive are queued
_M11B_FLAGS = ("models", "canary", "guardian", "slo", "admission_budget",
               "admission_reserve", "replicas", "replica_ceiling", "hosts",
               "hosts_kill_one", "aot_cache")


def main(argv=None):
    from raft_tpu_torch.cli._args import add_corr_args, corr_overrides

    p = argparse.ArgumentParser(
        description="serving front-end ragged-traffic drill")
    p.add_argument("--shapes", default="64x64,48x48",
                   help="comma list of HxW request shapes (the mixed "
                        "traffic); one bucket per distinct ÷8 shape")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--submitters", type=int, default=2)
    p.add_argument("--bucket-batch", type=int, default=4,
                   help="bucket batch dim = coalescing ceiling")
    p.add_argument("--sessions", type=int, default=0,
                   help="concurrent warm-start video sessions")
    p.add_argument("--session-frames", type=int, default=4)
    p.add_argument("--deadline-ms", type=float, default=0,
                   help="per-request deadline (0: none)")
    p.add_argument("--queue", type=int, default=64)
    p.add_argument("--gather-ms", type=float, default=5.0)
    p.add_argument("--iters", type=int, default=20,
                   help="refinement iterations (export bakes 20)")
    p.add_argument("--small", action="store_true")
    p.add_argument("--chaos", type=int, default=0, metavar="N",
                   help="run N randomized fault rounds + a clean "
                        "recovery round through the resilience stack "
                        "and assert the drill invariants (exit 1 on "
                        "any violation)")
    p.add_argument("--dispatch-timeout-ms", type=float, default=0,
                   help="dispatch watchdog deadline (0: off; --chaos "
                        "default 400ms)")
    p.add_argument("--breaker-failures", type=int, default=0,
                   help="consecutive failures opening a bucket's "
                        "breaker (0: off; --chaos default 2)")
    p.add_argument("--breaker-backoff-ms", type=float, default=250.0)
    p.add_argument("--breaker-backoff-max-ms", type=float,
                   default=30000.0,
                   help="backoff ceiling; size it ABOVE a real "
                        "recapture or half-open probes churn against "
                        "a bucket that can't come back yet")
    p.add_argument("--hang-ms", type=float, default=800.0,
                   help="injected hang length for --chaos plans (must "
                        "exceed the dispatch timeout to wedge)")
    p.add_argument("--recover-s", type=float, default=0.0,
                   help="per-shape recovery-probe budget after "
                        "traffic (drives the half-open probe; --chaos "
                        "default 8s)")
    p.add_argument("--wire", choices=("f32", "u8"), default="f32",
                   help="host→device wire format: u8 ships uint8 "
                        "frames and normalizes on device (~4x fewer "
                        "H2D bytes; bitwise at integer inputs)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="dispatch pipeline stages: 2 assembles+ships "
                        "batch N+1 while the device computes batch N "
                        "and moves the blocking fetch to a completion "
                        "stage (1: the synchronous path)")
    p.add_argument("--device-state", action="store_true",
                   help="video sessions keep flow_low on device "
                        "between pairs (on-device forward warp) "
                        "instead of the per-frame D2H→H2D round trip")
    p.add_argument("--feature-cache", action="store_true",
                   help="arm the cross-frame device feature cache: "
                        "video sessions serve through the cached "
                        "bucket signature — one encoder pass and ONE "
                        "frame of H2D per steady-state pair; summary "
                        "grows warm_pairs_per_s / cache_hit_rate / "
                        "cache_evictions (A/B against the same "
                        "traffic without the flag)")
    p.add_argument("--cache-capacity", type=int, default=256,
                   help="feature-cache pool slots (LRU beyond; the "
                        "per-stream device-memory bound)")
    p.add_argument("--ragged", action="store_true",
                   help="serve every shape through ONE capacity-class "
                        "program (ragged descriptor, masked-tail "
                        "correlation) and coalesce micro-batches "
                        "ACROSS shapes; the summary's capacity_fill / "
                        "cross_shape_coalesce_rate / executables are "
                        "the A/B against the same traffic without the "
                        "flag")
    p.add_argument("--capacity-classes", default=None, metavar="HxW,...",
                   help="with --ragged: explicit capacity-class boxes "
                        "(each captured at --bucket-batch rows); "
                        "default is one box covering every --shapes "
                        "entry")
    m11b = p.add_argument_group(
        "multi-model and fleet flags (ROADMAP M11b: they exit naming it)")
    m11b.add_argument("--models", default=None)
    m11b.add_argument("--canary", type=float, default=0.0, metavar="F")
    m11b.add_argument("--priority-mix", default="0:0", metavar="I:B",
                      help="with --models: interactive:batch request "
                           "counts per cycle (0:0 = priority-less)")
    m11b.add_argument("--guardian", action="store_true")
    m11b.add_argument("--slo", default=None, metavar="K:V,...")
    m11b.add_argument("--bake-ms", type=float, default=2000.0)
    m11b.add_argument("--admission-budget", type=int, default=0,
                      metavar="N")
    m11b.add_argument("--admission-reserve", type=int, default=None,
                      metavar="R")
    m11b.add_argument("--replicas", type=int, default=1, metavar="N")
    m11b.add_argument("--replica-ceiling", type=int, default=None,
                      metavar="M")
    m11b.add_argument("--hosts", type=int, default=0, metavar="N")
    m11b.add_argument("--hosts-kill-one", action="store_true")
    m11b.add_argument("--aot-cache", default=None, metavar="DIR")
    p.add_argument("--log-dir", default=None,
                   help="append the metrics snapshot to "
                        "<log-dir>/metrics.jsonl")
    p.add_argument("--trace-path", default=None, metavar="PATH",
                   help="arm request-scoped tracing: write span "
                        "records (serving/trace.py) here — the file "
                        "is started FRESH each run (per-run trace "
                        "ids; move it aside to keep old evidence); "
                        "the summary grows a tail_exemplars block and "
                        "raft_tpu_torch.cli.serve_trace reads the file "
                        "back")
    p.add_argument("--trace-sample", type=float, default=None,
                   metavar="R",
                   help="span sampling rate in [0,1] (default 1.0 "
                        "when tracing is armed); tail exemplars and "
                        "failures are always kept. Without "
                        "--trace-path, spans land beside the metrics "
                        "at <log-dir>/spans.jsonl")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the traffic and the random weights")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    add_corr_args(p)
    args = p.parse_args(argv)

    set_flags = [f for f in _M11B_FLAGS
                 if getattr(args, f) != p.get_default(f)]
    if set_flags or args.priority_mix != "0:0":
        names = ", ".join("--" + f.replace("_", "-") for f in set_flags
                          ) or "--priority-mix"
        raise SystemExit(
            f"{names}: the multi-model registry, its guardian and "
            "admission budget, the replica and host fleets and the "
            "serialized-program store are ROADMAP M11b of the port — "
            "run the single-model drill without them")

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT

    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.shapes.split(",")]
    capacity_classes = None
    if args.capacity_classes:
        capacity_classes = [tuple(int(v) for v in s.split("x"))
                            for s in args.capacity_classes.split(",")]
    if capacity_classes and not args.ragged:
        raise SystemExit("--capacity-classes needs --ragged")
    if args.ragged and args.feature_cache:
        raise SystemExit(
            "--ragged with --feature-cache is not supported yet: the "
            "cached signature keeps its per-shape bucket table. See "
            "ROADMAP 'Ragged serving, next bricks' (a) — the per-row "
            "descriptor subsuming the cached bucket matrix is the "
            "next brick. Run the two drills separately until then.")
    metrics_path = (os.path.join(args.log_dir, "metrics.jsonl")
                    if args.log_dir else None)
    trace_path = args.trace_path
    if trace_path is None and args.trace_sample is not None:
        if not args.log_dir:
            raise SystemExit("--trace-sample needs --trace-path or "
                             "--log-dir (for the default "
                             "<log-dir>/spans.jsonl)")
        trace_path = os.path.join(args.log_dir, "spans.jsonl")
    trace_sample = (args.trace_sample if args.trace_sample is not None
                    else 1.0)
    if not 0.0 <= trace_sample <= 1.0:
        raise SystemExit(f"--trace-sample {trace_sample}: must be "
                         "in [0, 1]")
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    cfg = RAFTConfig(small=args.small, **corr_overrides(args))
    # random weights seeded from --seed (no trained basic weights are in
    # the repository; the serving numbers do not depend on them)
    weights = RAFT(cfg, torch.Generator().manual_seed(args.seed))
    if args.chaos:
        summary = run_chaos_drill(
            weights, cfg, shapes=shapes, rounds=args.chaos,
            requests=args.requests, submitters=args.submitters,
            bucket_batch=args.bucket_batch, iters=args.iters,
            dispatch_timeout_s=(args.dispatch_timeout_ms / 1e3
                                if args.dispatch_timeout_ms else 0.4),
            hang_s=args.hang_ms / 1e3,
            breaker_failures=args.breaker_failures or 2,
            breaker_backoff_s=args.breaker_backoff_ms / 1e3,
            breaker_backoff_max_s=max(args.breaker_backoff_max_ms,
                                      args.breaker_backoff_ms) / 1e3,
            recover_s=args.recover_s or 8.0,
            gather_window_s=args.gather_ms / 1e3,
            deadline_s=(args.deadline_ms / 1e3 if args.deadline_ms
                        else None),
            wire=args.wire, pipeline_depth=args.pipeline_depth,
            sessions=args.sessions, session_frames=args.session_frames,
            session_device_state=args.device_state,
            feature_cache=args.feature_cache,
            cache_capacity=args.cache_capacity,
            ragged=args.ragged, capacity_classes=capacity_classes,
            max_queue=args.queue, seed=args.seed,
            metrics_path=metrics_path, trace_path=trace_path,
            trace_sample=trace_sample, device=args.device)
        print(json.dumps(summary), flush=True)
        if summary["violations"]:
            raise SystemExit(1)
        return summary
    summary = run_drill(
        weights, cfg, shapes=shapes, requests=args.requests,
        submitters=args.submitters, bucket_batch=args.bucket_batch,
        iters=args.iters, sessions=args.sessions,
        session_frames=args.session_frames,
        deadline_s=args.deadline_ms / 1e3 if args.deadline_ms else None,
        max_queue=args.queue, gather_window_s=args.gather_ms / 1e3,
        dispatch_timeout_s=(args.dispatch_timeout_ms / 1e3
                            if args.dispatch_timeout_ms else None),
        breaker_failures=args.breaker_failures,
        breaker_backoff_s=args.breaker_backoff_ms / 1e3,
        breaker_backoff_max_s=max(args.breaker_backoff_max_ms,
                                  args.breaker_backoff_ms) / 1e3,
        wire=args.wire, pipeline_depth=args.pipeline_depth,
        session_device_state=args.device_state,
        feature_cache=args.feature_cache,
        cache_capacity=args.cache_capacity,
        ragged=args.ragged, capacity_classes=capacity_classes,
        recover_s=args.recover_s,
        metrics_path=metrics_path, trace_path=trace_path,
        trace_sample=trace_sample, seed=args.seed, device=args.device)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
