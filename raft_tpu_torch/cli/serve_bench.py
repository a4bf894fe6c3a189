"""Synthetic ragged-traffic drill for the serving front-end; port of
``raft_tpu/cli/serve_bench.py`` (the single-model drills, the replica
fleet, the host fleet and program store, and the multi-model registry
drills).

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

``--replicas N`` (+ ``--replica-ceiling M``) fans the engine out into N
replica lanes on the card behind one scheduler (each replica its own
weights, stream, graph pool and captures of the primary's programs); the
summary grows a per-replica ``fleet`` block.

``--models basic,small`` runs the multi-model drill instead: each name a
live model behind one ``ModelRegistry`` (weights seeded from ``--seed``),
``--canary F`` deploys a same-arch canary of the first model (a second
seeded weight set) at that request-hash fraction and promotes it after
traffic, ``--priority-mix I:B`` tags the traffic, ``--guardian`` (+
``--slo``, ``--bake-ms``) hands the verdict to the SLO guardian, and
``--admission-budget N`` (+ ``--admission-reserve R``) arms the
registry-wide admission budget; with ``--chaos N`` the registry's fault
rounds run instead. The summary line carries per-model and per-priority
blocks.

``--hosts N`` adds N host lanes behind loopback transports (each a
``HostWorker`` over an engine spawned from the primary, which loads its
programs from the store when ``--aot-cache`` is set), admitted by push and
prewarm before traffic and heartbeat-monitored; ``--hosts-kill-one``
poisons ``h0`` mid-traffic (dead verdict, quarantine, failover, every
request settled once); the summary grows a per-host ``hosts`` block.
``--aot-cache DIR`` arms the program store (serving/aot.py): the engine
loads each bucket's program from ``DIR`` when it is there and exports and
stores it when not; the summary grows ``aot_hits``, ``aot_misses``,
``compiles`` and ``compiles_avoided`` (run the same drill twice against
one ``DIR`` for the load-against-trace A/B). With ``--chaos`` both widen
the fault plans (an ``aot.load`` corruption each round; the transport and
heartbeat sites)::

    python -m raft_tpu_torch.cli.serve_bench --device cpu --small \\
        --shapes 32x32,24x40 --requests 12 --iters 1 --hosts 2 \\
        --hosts-kill-one --aot-cache /tmp/raft_aot
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
#: registry drills add the model-variant build path: a failed canary
#: deploy must auto-roll-back without touching live traffic
CHAOS_SITES_REGISTRY = CHAOS_SITES + ("registry.load",)
#: guardian-attended drills add the decision point: a guardian that
#: raises or hangs mid-decision must strand nothing and leave routing
#: exactly as it found it (the site fires before any registry mutation)
CHAOS_SITES_GUARDIAN = CHAOS_SITES_REGISTRY + ("guardian.decide",)
#: host drills add the remote lanes' surfaces: both wire directions (a
#: corrupted or raised exchange must fail over or settle cleanly, never
#: strand), the heartbeat probe (missed beats walk the suspect -> dead
#: ladder and the verdict's consequences fire) and the worker's infer
#: itself (a host dying MID-BATCH: the failover-requeue path)
CHAOS_SITES_HOSTS = CHAOS_SITES + ("transport.send", "transport.recv",
                                   "host.heartbeat", "host.infer")

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
              tracer=None, seed=0, engine=None, aot_cache=None,
              replicas=1, replica_ceiling=None, placement=None, hosts=0,
              host_kill_one=False, on_accept=None, device="cuda"):
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
    to the untraced drill.

    ``replicas`` > 1 (or a ``replica_ceiling``) arms the replica fleet
    (parallel/placement.py): the engine fans out into N lanes, each
    replica capturing its own copy of the primary's programs, and the
    summary grows a ``fleet`` block with per-replica dispatches,
    occupancy, breaker state and queue depth. At the default
    ``replicas=1`` no fleet is built and the summary has no such
    key. ``placement`` injects a prebuilt
    :class:`~raft_tpu_torch.parallel.placement.Placement` (its engines,
    primary first, become the lanes: a caller measuring the replicas
    keeps them).

    ``aot_cache`` (a directory path) arms the program store
    (serving/aot.py): the engine's precompile LOADS any bucket whose
    program is already in the directory instead of tracing it, and
    exports and stores what it does trace. When armed the summary grows
    ``aot_hits``/``aot_misses``/``compiles``/``compiles_avoided`` (from
    ``engine.aot_stats()``); off, the summary has no such keys.

    ``hosts`` > 0 arms the host fleet (serving/hosts.py): N loopback host
    workers, each a ``HostWorker`` over an engine spawned from the primary
    (its programs loaded from the store when ``aot_cache`` is set), behind
    a ``HostFleet`` with heartbeats, breakers and the failover path,
    admitted (push and prewarm) BEFORE any traffic. ``host_kill_one``
    runs the kill-one drill: once every submitter has queued its traffic,
    host ``h0``'s transport is poisoned mid-drain; the missed-beat ladder
    must verdict it dead, its lane quarantine, its in-flight batches fail
    over, and every request still settle exactly once. The summary grows
    a ``hosts`` block (per-host state, beats, failovers, rejoins, push
    counters).

    ``on_accept(image1, image2, future)`` is called for every accepted
    one-shot request (a caller holding each future to a forward of its
    own)."""
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
                aot_cache=aot_cache, device=device)
        else:
            # one documented bucket per distinct ÷8-padded request shape
            envelope = sorted({(bucket_batch, _ceil8(h), _ceil8(w))
                               for h, w in shapes})
            engine = RAFTEngine(weights, cfg, iters=iters,
                                envelope=envelope, precompile=True,
                                warm_start=True, wire=wire,
                                feature_cache=feature_cache,
                                aot_cache=aot_cache, device=device)
    _n_exec = getattr(engine, "executable_count",
                      lambda: len(engine._compiled))
    documented = _n_exec()
    own_ledger = tracer is None and bool(trace_path)
    if own_ledger:
        from raft_tpu_torch.serving.trace import TraceLedger
        _fresh_trace_file(trace_path)
        tracer = TraceLedger(trace_path, sample_rate=trace_sample)
    host_fleet = (_loopback_fleet(engine, hosts, aot_cache, seed)
                  if hosts else None)
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
                                tracer=tracer,
                                replicas=replicas,
                                replica_ceiling=replica_ceiling,
                                placement=placement,
                                host_fleet=host_fleet)
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
                fut = sched.submit(i1, i2, deadline_s=deadline_s)
            except BackpressureError:
                shed[sid] += 1
                continue
            except CircuitOpen:
                rejected[sid] += 1
                continue
            futures[sid].append(fut)
            if on_accept is not None:
                on_accept(i1, i2, fut)

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
        if host_kill_one and host_fleet is not None:
            # every submitter has queued its traffic and the queue is
            # still draining: poisoning h0 HERE lands the dead-host
            # verdict mid-traffic, and the failover path must re-dispatch
            # its in-flight batches
            host_fleet.poison("h0")
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
    fleet = health.get("fleet")
    if fleet:
        # replica-fleet surface (key absent at replicas=1): per-replica
        # dispatch/occupancy/breaker/queue-depth blocks
        reps = rec.get("replicas") or {}
        lanes = {}
        for name, ln in sorted(fleet["lanes"].items()):
            m = reps.get(name[1:], {})
            lanes[name] = {
                "active": ln["active"],
                "quarantined": ln["quarantined"],
                "dispatches": ln["dispatches"],
                "completed": m.get("completed", 0),
                "occupancy": m.get("occupancy", 0.0),
                "queue_depth_last": m.get("queue_depth_last", 0),
                "open_breakers": sum(
                    1 for b in ln["breakers"].values()
                    if b["state"] != "closed"),
            }
        summary["fleet"] = {
            "replicas": fleet["replicas"],
            "active": fleet["active"],
            "ceiling": fleet["ceiling"],
            "concurrency_max": fleet["concurrency_max"],
            "lanes": lanes,
        }
    hf = health.get("hosts")
    if hf:
        # host-fleet surface (key absent at hosts=0): per-host liveness,
        # failover and push blocks the kill-one drill asserts against
        summary["hosts"] = {
            "state": hf["state"],
            "suspect_after": hf["suspect_after"],
            "dead_after": hf["dead_after"],
            "hosts": {
                name: {
                    "state": blk["state"],
                    "ready": blk["ready"],
                    "beats": blk["beats"],
                    "missed_beats": blk["missed_beats"],
                    "failovers": blk["failovers"],
                    "rejoins": blk["rejoins"],
                    "push_entries": blk["push_entries"],
                    "push_bytes": blk["push_bytes"],
                    "push_retries": blk["push_retries"],
                    "breaker": blk["breaker"]["state"],
                } for name, blk in sorted(hf["hosts"].items())},
        }
    aot = (engine.aot_stats() if hasattr(engine, "aot_stats")
           else {"enabled": 0})
    if aot.get("enabled"):
        # load-against-trace A/B surface (keys absent with the store
        # off): a second run against a warm store reports compiles == 0
        # and compiles_avoided == the first run's compiles
        summary["aot_hits"] = aot["aot_hits"]
        summary["aot_misses"] = aot["aot_misses"]
        summary["compiles"] = aot["compiles"]
        summary["compiles_avoided"] = aot["compiles_avoided"]
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


def _loopback_fleet(engine, hosts: int, aot_cache, seed: int):
    """``hosts`` loopback host lanes, each a ``HostWorker`` over a sibling
    spawned from ``engine`` (its programs loaded from the store when
    ``aot_cache`` is set) with its OWN store root, so the admit-time push
    ships the primary's programs there sha256-verified: the full
    protocol, though the in-process sibling builds from the shared
    store. Admitted (push and prewarm) before it is returned."""
    import tempfile

    from raft_tpu_torch.serving.aot import AOTCache
    from raft_tpu_torch.serving.hosts import HostFleet, HostWorker
    from raft_tpu_torch.serving.transport import LoopbackTransport

    spawn = getattr(engine, "spawn_replica", None)
    if spawn is None:
        raise ValueError("hosts > 0 needs an engine with spawn_replica "
                         "(the host workers wrap siblings of the primary)")
    transports = {}
    for k in range(hosts):
        root = (tempfile.mkdtemp(prefix=f"raft_host_h{k}_")
                if aot_cache else None)
        transports[f"h{k}"] = LoopbackTransport(
            HostWorker(spawn(), aot_root=root), name=f"h{k}")
    # a short ladder: the kill-one drill must verdict the poisoned host
    # DEAD well inside the drill's drain, and the long reconnect backoff
    # keeps the monitor from reviving the killed host mid-assertion
    fleet = HostFleet(
        transports, aot_cache=AOTCache(aot_cache) if aot_cache else None,
        heartbeat_s=0.05, heartbeat_timeout_s=2.0, suspect_after=1,
        dead_after=2, reconnect_backoff_s=600.0, rng=random.Random(seed))
    # admit BEFORE traffic: push and prewarm gate the lanes, and no
    # request routes to a host until its programs verified
    fleet.admit_all()
    return fleet


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
        # a quarantined fleet lane degrades health with every bucket
        # breaker closed — that's the fleet's degradation, not a
        # breaker-accounting bug
        lanes = (s.get("fleet") or {}).get("lanes", {})
        fleet_degraded = (
            s.get("hosts", {}).get("state", "healthy") != "healthy"
            or any(ln["quarantined"] or ln["open_breakers"]
                   for ln in lanes.values()))
        if not fleet_degraded:
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
                    aot_cache=None, hosts=0, device="cuda"):
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

    ``aot_cache`` arms the program store AND its fault site: every chaos
    round's plan gains an ``aot.load`` corruption, so when a wedge-dropped
    bucket is rebuilt it first reads a just-corrupted entry; the drilled
    contract is a clean miss and a rebuild from the live module (no
    stranded future, the programs back at the documented count, and the
    corrupted entry REPLACED by the re-store, which the clean round's
    loads prove).

    ``hosts`` > 0 runs every round with N loopback host lanes and widens
    the fault vocabulary with both wire directions and the heartbeat
    probe: corrupted exchanges must settle cleanly (failover or a settled
    error, never a strand), and heartbeat faults walk the missed-beat
    ladder, firing the verdict's consequences mid-round. The same
    invariants pin the outcome.
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
                capacity_classes=classes, aot_cache=aot_cache,
                device=device)
        else:
            envelope = sorted({(bucket_batch, _ceil8(h), _ceil8(w))
                               for h, w in shapes})
            engine = RAFTEngine(weights, cfg, iters=iters,
                                envelope=envelope, precompile=True,
                                warm_start=True, exact_shapes=True,
                                wire=wire, feature_cache=feature_cache,
                                aot_cache=aot_cache, device=device)
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
                  tracer=tracer, engine=engine, hosts=hosts,
                  aot_cache=aot_cache, device=device)
    sites = (CHAOS_SITES_PIPELINED if pipeline_depth > 1
             else CHAOS_SITES)
    if hosts:
        sites = sites + ("transport.send", "transport.recv",
                         "host.heartbeat")
    aot_armed = bool(getattr(engine, "aot_stats",
                             lambda: {"enabled": 0})().get("enabled"))
    for r in range(rounds):
        plan = chaos_plan(rng, hang_s=hang_s, sites=sites)
        if aot_armed:
            # stored-program bit rot, mid-drill: the first load this
            # round (a wedge-dropped bucket rebuilt) reads a
            # just-corrupted entry and must take the clean miss and the
            # rebuild from the live module
            plan["faults"].append({"site": "aot.load", "kind": "corrupt",
                                   "at": 1, "count": 1})
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
    if aot_armed:
        out["aot"] = engine.aot_stats()
    if tracer is not None:
        # whole-drill trace view (the per-round blocks carry only
        # their OWN refs/accounting — the shared ledger counters and
        # spans file cover all rounds, so both live here, once)
        out["trace"] = tracer.snapshot()
        out["tail_exemplars"] = _trace_file_view(trace_path)
    return out




def _merged_priority_blocks(variant_snaps):
    """Aggregate per-priority counters + latency across every variant
    snapshot (live + canary + retired finals, all models): counters
    sum, histograms merge on the shared ladder — the per-priority
    summary block of the registry drill's JSON line."""
    from raft_tpu_torch.serving.metrics import LatencyHistogram

    out = {}
    for snap in variant_snaps:
        for cls, p in (snap.get("priority") or {}).items():
            agg = out.setdefault(cls, {
                "submitted": 0, "completed": 0, "shed": 0,
                "deadline_missed": 0, "_hist": LatencyHistogram()})
            for k in ("submitted", "completed", "shed",
                      "deadline_missed"):
                agg[k] += p[k]
            agg["_hist"].merge(
                LatencyHistogram.from_snapshot(p["latency"]))
    for agg in out.values():
        h = agg.pop("_hist")
        agg["p50_ms"] = h.quantile(0.5)
        agg["p99_ms"] = h.quantile(0.99)
        agg["mean_ms"] = (round(h.total / h.count, 3) if h.count
                          else 0.0)
    return out


def _variant_snaps(model_block):
    """Every variant snapshot in one model's registry-snapshot block."""
    snaps = [model_block["live"]]
    if model_block["canary"] is not None:
        snaps.append(model_block["canary"])
    return snaps + list(model_block["retired"])


def run_registry_drill(models, *, shapes, requests=48, submitters=2,
                       bucket_batch=4, iters=2, priority_mix=(1, 1),
                       canary_fraction=0.0, canary_variables=None,
                       promote=True, deadline_s=None, max_queue=64,
                       gather_window_s=0.005, dispatch_timeout_s=None,
                       breaker_failures=0, breaker_backoff_s=0.25,
                       breaker_backoff_max_s=30.0, wire="f32",
                       pipeline_depth=1, sessions=0, session_frames=4,
                       admission_budget=None, admission_reserve=None,
                       guardian=False, guardian_policy=None,
                       guardian_poll_s=0.05, guardian_timeout_s=30.0,
                       fault_plan=None, metrics_path=None,
                       trace_path=None, trace_sample=1.0, seed=0,
                       engines=None, canary_engine=None, on_accept=None,
                       device="cuda"):
    """Mixed-model, mixed-priority drill over a ``ModelRegistry``.

    ``models``: list of ``(name, weights, config)`` (``weights`` a
    ``RAFT`` module or its state dict) — each becomes a live model with
    its own warm-start engine (one bucket per distinct ÷8 request
    shape), scheduler, breaker board and metrics namespace.
    ``priority_mix``: (interactive, batch) request counts per cycle
    of each submitter's traffic ((0, 0) = priority-less).
    ``canary_fraction`` > 0 deploys ``canary_variables`` as the FIRST
    model's canary before traffic and promotes it after
    (``promote=False`` rolls it back) — under an armed ``fault_plan``
    the deploy may fail, which must auto-roll-back and leave live
    traffic untouched (asserted via the summary's ``canary`` block).
    ``engines``/``canary_engine`` inject prebuilt engines so chaos
    rounds share captures. ``on_accept(model, priority, image1, image2,
    future)`` is called for each accepted one-shot request (a caller
    holding each future to its variant's own forward). Returns the
    one-line summary dict with per-model and per-priority blocks.

    ``guardian=True`` hands the rollout verdict to an
    :class:`~raft_tpu_torch.serving.guardian.SLOGuardian` polling the
    registry (``guardian_policy``: GuardianPolicy kwargs): the drill
    waits up to ``guardian_timeout_s`` for its decision instead of
    promoting/rolling back manually, records it in the summary's
    ``canary``/``guardian`` blocks, and a guardian that never decides
    (wedged at the ``guardian.decide`` chaos site) must leave the
    canary fully routed — never half-rolled — for ``close()`` to
    drain. ``admission_budget`` arms the registry-wide token bucket;
    rejections land per model as ``admission_rejected``."""
    from raft_tpu_torch.serving.registry import DeployError, ModelRegistry
    from raft_tpu_torch.serving.resilience import (CircuitOpen,
                                                   DispatchWedged)
    from raft_tpu_torch.serving.scheduler import (PRIORITY_BATCH,
                                                  PRIORITY_INTERACTIVE,
                                                  BackpressureError,
                                                  DeadlineExceeded)
    from raft_tpu_torch.serving.session import VideoSession
    from raft_tpu_torch.testing import faults

    envelope = sorted({(bucket_batch, _ceil8(h), _ceil8(w))
                       for h, w in shapes})
    _fresh_trace_file(trace_path)
    reg = ModelRegistry(metrics_path=metrics_path,
                        trace_path=trace_path,
                        trace_sample=trace_sample,
                        max_queue=max_queue,
                        max_batch=bucket_batch,
                        gather_window_s=gather_window_s,
                        dispatch_timeout_s=dispatch_timeout_s,
                        breaker_failures=breaker_failures,
                        breaker_backoff_s=breaker_backoff_s,
                        breaker_backoff_max_s=breaker_backoff_max_s,
                        breaker_rng=random.Random(seed),
                        pipeline_depth=pipeline_depth,
                        admission_budget=admission_budget,
                        admission_interactive_reserve=admission_reserve,
                        device=device)
    for name, weights, cfg in models:
        reg.add_model(name, weights, cfg, iters=iters,
                      envelope=envelope,
                      engine=(engines or {}).get(name),
                      warm_start=True, wire=wire)
    guard = None
    if guardian:
        from raft_tpu_torch.serving.guardian import (GuardianPolicy,
                                                     SLOGuardian)

        guard = SLOGuardian(reg, GuardianPolicy(**(guardian_policy
                                                   or {})),
                            poll_s=guardian_poll_s).start()
    target = models[0][0]
    canary = {"requested": canary_fraction > 0, "deployed": False,
              "version": None, "deploy_failed": None,
              "leaked_after_failure": False, "resolution": None,
              "half_rolled": False}
    accepted = [[] for _ in range(submitters)]   # (future, model, prio)
    shed = [0] * submitters
    rejected = [0] * submitters
    session_stats = {"pairs": 0, "warm": 0, "errors": 0}
    pi, pb = priority_mix
    cycle = ([PRIORITY_INTERACTIVE] * int(pi)
             + [PRIORITY_BATCH] * int(pb))

    def submit_loop(sid):
        rng = np.random.RandomState(seed + sid)
        per = requests // submitters + (1 if sid < requests % submitters
                                        else 0)
        for k in range(per):
            h, w = shapes[(sid + k) % len(shapes)]
            name = models[(sid * 7 + k) % len(models)][0]
            prio = cycle[k % len(cycle)] if cycle else None
            i1 = rng.rand(h, w, 3).astype(np.float32) * 255
            i2 = rng.rand(h, w, 3).astype(np.float32) * 255
            try:
                fut = reg.submit(i1, i2, model=name, priority=prio,
                                 deadline_s=deadline_s)
            except BackpressureError:
                shed[sid] += 1
                continue
            except CircuitOpen:
                rejected[sid] += 1
                continue
            accepted[sid].append((fut, name, prio))
            if on_accept is not None:
                on_accept(name, prio, i1, i2, fut)

    def session_loop(sid):
        rng = np.random.RandomState(seed + 1000 + sid)
        h, w = shapes[sid % len(shapes)]
        name = models[sid % len(models)][0]
        sess = VideoSession(reg, model=name, deadline_s=deadline_s)
        futs = []
        for _ in range(session_frames + 1):
            try:
                futs.append(sess.submit_frame(
                    rng.rand(h, w, 3).astype(np.float32) * 255))
            except (BackpressureError, CircuitOpen):
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

    threads = ([threading.Thread(target=submit_loop, args=(s,))
                for s in range(submitters)]
               + [threading.Thread(target=session_loop, args=(s,))
                  for s in range(sessions)])
    if fault_plan is not None:
        faults.arm(fault_plan)
    t0 = time.perf_counter()
    try:
        if canary_fraction > 0:
            # deploy BEFORE traffic: the canary serves its hash slice
            # of the drill. A build failure (incl. the registry.load
            # chaos site) must auto-roll-back: live serves 100% and
            # health shows no canary — the summary pins both.
            try:
                canary["version"] = reg.deploy(
                    target, canary_variables,
                    canary_fraction=canary_fraction,
                    engine=canary_engine)
                canary["deployed"] = True
                if guard is not None:
                    # open the bake BEFORE traffic so the judged
                    # window contains the drill's requests — on a fast
                    # drill the polling loop's first post-deploy tick
                    # could otherwise freeze its baseline after the
                    # traffic already completed
                    guard.tick()
            except DeployError as exc:
                canary["deploy_failed"] = str(exc)[:200]
                canary["leaked_after_failure"] = (
                    reg.health()[target]["canary"] is not None)
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        futures_wait([f for fl in accepted for (f, _, _) in fl],
                     timeout=600)
        if canary["deployed"]:
            if guard is not None:
                # the guardian owns the verdict: wait it out (bounded
                # — a wedged guardian must not wedge the drill), and a
                # canary it never resolved must still be FULLY routed
                # (state canary, fraction > 0) for close() to drain —
                # half-rolled is the invariant violation chaos hunts
                decision = guard.wait_decision(
                    target, timeout=guardian_timeout_s)
                canary["resolution"] = (
                    "guardian_" + decision["action"]
                    if decision is not None else "guardian_undecided")
            elif promote:
                canary["resolution"] = reg.promote(target)["mode"]
            else:
                reg.rollback(target)
                canary["resolution"] = "rolled_back"
        health = reg.health()
        tgt_canary = health[target]["canary"]
        canary["half_rolled"] = (
            tgt_canary is not None
            and (tgt_canary["state"] != "canary"
                 or not tgt_canary["fraction"] > 0))
        guardian_block = None
        if guard is not None:
            guardian_block = {
                "decisions": list(guard.decisions),
                "errors": guard.errors,
                "wedged": not guard.stop(timeout=5.0),
            }
        admission = reg.admission_snapshot()
        reg.close(drain=True)
    finally:
        if guard is not None:
            guard.stop(timeout=0.1)
        if fault_plan is not None:
            faults.disarm()
    wall = time.perf_counter() - t0

    snap = reg.snapshot()    # post-close: retired finals included
    per_model = {}
    for name, _, _ in models:
        blk = snap[name]
        live = blk["live"]
        per_model[name] = {
            "submitted": blk["totals"]["submitted"],
            "completed": blk["totals"]["completed"],
            "failed": blk["totals"]["failed"],
            "shed": blk["totals"]["shed"],
            "evicted": blk["totals"]["evicted"],
            "admission_rejected": blk["totals"]["admission_rejected"],
            "deadline_missed": blk["totals"]["deadline_missed"],
            "cancelled": blk["totals"]["cancelled"],
            "accounting_ok": blk["accounting_ok"],
            "abandoned_inflight": sum(
                s["abandoned_inflight"] for s in _variant_snaps(blk)),
            "occupancy": live["occupancy"]["mean"],
            "p50_ms": live["latency"]["p50_ms"],
            "p99_ms": live["latency"]["p99_ms"],
            "executables_live": live["executables"],
            "health_state": health[name]["live"]["health"]["state"],
        }
    served = deadline_missed = wedged = circuit = errors = 0
    stranded = evicted = 0
    for fl in accepted:
        for fut, _, _ in fl:
            if not fut.done():
                stranded += 1
                continue
            try:
                fut.result(timeout=0)
                served += 1
            except DeadlineExceeded:
                deadline_missed += 1
            except DispatchWedged:
                wedged += 1
            except CircuitOpen:
                circuit += 1
            except BackpressureError:
                # an ACCEPTED future failing backpressure is a
                # shed-batch-first eviction — by design under a
                # priority mix, not a dispatch failure
                evicted += 1
            except Exception:
                errors += 1
    all_snaps = [s for name, _, _ in models
                 for s in _variant_snaps(snap[name])]
    total_served = served + session_stats["pairs"]
    summary = {
        "registry": True,
        "model_names": [name for name, _, _ in models],
        "submitted": sum(b["submitted"] for b in per_model.values()),
        "accepted": sum(len(fl) for fl in accepted),
        "served": served,
        "shed": sum(shed),
        "circuit_rejected": sum(rejected),
        "deadline_missed": deadline_missed,
        "errors": errors + session_stats["errors"],
        "failed_wedged": wedged,
        "failed_circuit": circuit,
        "failed_evicted": evicted,
        "stranded": stranded,
        "accounting_ok": all(b["accounting_ok"]
                             for b in per_model.values()),
        "abandoned_inflight": sum(b["abandoned_inflight"]
                                  for b in per_model.values()),
        "session_pairs": session_stats["pairs"],
        "warm_submits": session_stats["warm"],
        "canary": canary,
        "guardian": guardian_block,
        "admission": admission,
        "models": per_model,
        "priorities": _merged_priority_blocks(all_snaps),
        "wall_s": round(wall, 3),
        "pairs_per_s": round(total_served / wall, 2) if wall else 0.0,
    }
    if reg.tracer is not None:
        # spans carry the model/variant/canary stamps the registry
        # minted — the phase attribution here covers ALL models
        summary["tail_exemplars"] = {
            **_trace_file_view(trace_path),
            "ledger": reg.tracer.snapshot(),
        }
    return summary


def _registry_round_violations(s: dict) -> list:
    """The registry chaos-drill invariants, checked after every
    round: the single-model invariants PER MODEL, plus the canary
    contract — a failed deploy leaves no canary behind and live
    traffic keeps serving."""
    v = []
    if s["stranded"]:
        v.append(f"stranded futures: {s['stranded']}")
    if s["abandoned_inflight"]:
        v.append(f"abandoned_inflight: {s['abandoned_inflight']}")
    for name, blk in s["models"].items():
        if not blk["accounting_ok"]:
            v.append(f"model {name}: submitted != completed+failed+"
                     "deadline_missed+cancelled")
    if (s["canary"]["deploy_failed"] is not None
            and s["canary"]["leaked_after_failure"]):
        v.append("failed canary deploy left a canary routing traffic "
                 "(auto-rollback broken)")
    if s["canary"].get("half_rolled"):
        v.append("canary left half-rolled (present but not fully "
                 "routed) — a wedged guardian must leave routing "
                 "exactly as it found it")
    return v


def run_registry_chaos(models, *, shapes, rounds=2, requests=16,
                       submitters=2, bucket_batch=3, iters=1,
                       priority_mix=(1, 1), canary_fraction=0.5,
                       canary_variables=None, dispatch_timeout_s=0.4,
                       hang_s=0.8, breaker_failures=2,
                       breaker_backoff_s=0.15,
                       breaker_backoff_max_s=0.6,
                       gather_window_s=0.0, max_queue=64,
                       deadline_s=None, guardian=True,
                       guardian_policy=None, guardian_timeout_s=8.0,
                       admission_budget=None, admission_reserve=None,
                       seed=0, metrics_path=None, device="cuda"):
    """``rounds`` randomized fault rounds + one clean round of the
    registry drill over SHARED prebuilt engines (captures amortized
    across rounds; a new registry per round owns fresh schedulers).
    Each round attempts a canary deploy for the first model — the
    plans draw ``registry.load``, so some deploys fail and must
    auto-roll-back without touching live traffic — then runs
    mixed-model mixed-priority traffic and resolves the rollout. With
    ``guardian=True`` (the default) every round runs under a live
    :class:`~raft_tpu_torch.serving.guardian.SLOGuardian` owning the
    verdict, the plans additionally draw the ``guardian.decide`` site
    (a guardian that raises or hangs must strand nothing and never
    leave a half-rolled canary — the violations check pins it), and
    the clean round must end in a guardian auto-promote; with
    ``guardian=False`` rounds resolve manually (promote on even,
    rollback on odd). Either way the clean round needs per-model
    accounting identity, zero stranded futures, and per-engine
    programs back at the documented bucket count."""
    from raft_tpu_torch.serving.engine import RAFTEngine

    rng = random.Random(seed)
    envelope = sorted({(bucket_batch, _ceil8(h), _ceil8(w))
                       for h, w in shapes})
    # exact_shapes, like run_chaos_drill: a wedge-dropped bucket must
    # honestly recapture, not hide behind a larger healthy one
    engines = {name: RAFTEngine(weights, cfg, iters=iters,
                                envelope=envelope, precompile=True,
                                warm_start=True, exact_shapes=True,
                                device=device)
               for name, weights, cfg in models}
    canary_engine = RAFTEngine(canary_variables, models[0][2],
                               iters=iters, envelope=envelope,
                               precompile=True, warm_start=True,
                               exact_shapes=True, device=device)
    # the recovery check covers every engine population the chaos can
    # wedge — the shared canary engine included, under a reserved key
    all_engines = dict(engines)
    all_engines["_canary"] = canary_engine
    documented = {name: eng.executable_count()
                  for name, eng in all_engines.items()}
    if guardian:
        # drill-sized bake defaults: judgeable within one round's
        # traffic, margins wide enough that only the drill's own
        # injected faults (not latency jitter) can breach. Caller
        # overrides MERGE on top — a --slo/--bake-ms spec must not
        # silently resurrect the production min_requests=20 against a
        # dozen-request round
        overrides = guardian_policy or {}
        guardian_policy = {**{"bake_window_s": 0.5, "max_bake_s": 6.0,
                              "min_requests": 1, "p99_ratio": 4.0,
                              "p99_slack_ms": 500.0,
                              "err_rate_margin": 0.3, "max_wedged": 1,
                              "max_breaker_opens": 2},
                           **overrides}
        if "max_bake_s" not in overrides:
            # a caller-sized bake window (--bake-ms) must not collide
            # with the drill default ceiling (GuardianPolicy rejects
            # max_bake_s < bake_window_s)
            guardian_policy["max_bake_s"] = max(
                guardian_policy["max_bake_s"],
                4.0 * guardian_policy["bake_window_s"])
    common = dict(shapes=shapes, requests=requests,
                  submitters=submitters, bucket_batch=bucket_batch,
                  iters=iters, priority_mix=priority_mix,
                  canary_fraction=canary_fraction,
                  canary_variables=canary_variables,
                  deadline_s=deadline_s, max_queue=max_queue,
                  gather_window_s=gather_window_s,
                  dispatch_timeout_s=dispatch_timeout_s,
                  breaker_failures=breaker_failures,
                  breaker_backoff_s=breaker_backoff_s,
                  breaker_backoff_max_s=breaker_backoff_max_s,
                  guardian=guardian, guardian_policy=guardian_policy,
                  guardian_timeout_s=guardian_timeout_s,
                  admission_budget=admission_budget,
                  admission_reserve=admission_reserve,
                  metrics_path=metrics_path, engines=engines,
                  canary_engine=canary_engine, device=device)
    per_round = []
    violations = []
    sites = (CHAOS_SITES_GUARDIAN if guardian
             else CHAOS_SITES_REGISTRY)
    for r in range(rounds):
        plan = chaos_plan(rng, hang_s=hang_s, sites=sites)
        if r == 0:
            # every chaos run proves the auto-rollback contract at
            # least once: round 0's deploy is FORCED to fail at
            # registry.load (the randomized entries may or may not
            # draw the site) — the round then runs live-only and the
            # violations check pins no-canary-leaked + accounting
            plan["faults"] = [f for f in plan["faults"]
                              if f["site"] != "registry.load"]
            plan["faults"].append({"site": "registry.load",
                                   "kind": "raise", "at": 1,
                                   "count": 1})
        s = run_registry_drill(models, seed=seed + 17 * r,
                               fault_plan=plan, promote=(r % 2 == 0),
                               **common)
        s["round"] = r
        s["plan"] = plan
        per_round.append(s)
        violations += [f"round {r}: {v}"
                       for v in _registry_round_violations(s)]
    # clean round at a production-sized watchdog (same reasoning as
    # run_chaos_drill: a legitimate recapture of a chaos-dropped
    # bucket must not verdict as a wedge mid-recovery)
    clean = dict(common, dispatch_timeout_s=max(30.0,
                                                dispatch_timeout_s))
    s = run_registry_drill(models, seed=seed + 999, fault_plan=None,
                           promote=True, **clean)
    s["round"] = "clean"
    per_round.append(s)
    violations += [f"clean round: {v}"
                   for v in _registry_round_violations(s)]
    if not s["canary"]["deployed"] or s["canary"]["resolution"] is None:
        violations.append("clean round: canary deploy/promote did not "
                          "complete")
    elif guardian and s["canary"]["resolution"] != "guardian_promote":
        # the clean round's canary bakes with zero injected faults: the
        # guardian must judge it clean and auto-promote — anything else
        # (rollback, undecided) is a broken judgment loop
        violations.append(
            "clean round: guardian resolution "
            f"{s['canary']['resolution']!r} != guardian_promote")
    if s["served"] != s["accepted"]:
        violations.append("clean round: served != accepted traffic")
    for name, eng in all_engines.items():
        if eng.executable_count() != documented[name]:
            violations.append(
                f"model {name}: executables {eng.executable_count()} != "
                f"documented {documented[name]} after recovery")
    totals = {k: sum(p[k] for p in per_round) for k in
              ("submitted", "served", "shed", "circuit_rejected",
               "deadline_missed", "failed_wedged", "failed_circuit",
               "errors")}
    deploys = {"attempted": sum(1 for p in per_round
                                if p["canary"]["requested"]),
               "deployed": sum(1 for p in per_round
                               if p["canary"]["deployed"]),
               "auto_rolled_back": sum(
                   1 for p in per_round
                   if p["canary"]["deploy_failed"] is not None)}
    guardian_summary = None
    if guardian:
        guardian_summary = {
            "decisions": sum(len(p["guardian"]["decisions"])
                             for p in per_round if p["guardian"]),
            "errors": sum(p["guardian"]["errors"]
                          for p in per_round if p["guardian"]),
            "wedged_rounds": sum(1 for p in per_round
                                 if p["guardian"]
                                 and p["guardian"]["wedged"]),
            "undecided_rounds": sum(
                1 for p in per_round
                if p["canary"]["resolution"] == "guardian_undecided"),
        }
    return {
        "chaos_rounds": rounds,
        "registry": True,
        "violations": violations,
        "documented_buckets": documented,
        "executables": {name: eng.executable_count()
                        for name, eng in all_engines.items()},
        "deploys": deploys,
        "guardian": guardian_summary,
        "totals": totals,
        "per_round": per_round,
    }


#: --slo spec keys → GuardianPolicy kwargs (floats unless noted)
_SLO_KEYS = {"p99_ms": "p99_ceiling_ms", "p99_ratio": "p99_ratio",
             "p99_slack_ms": "p99_slack_ms",
             "err_rate": "err_rate_margin",
             "min_requests": "min_requests", "wedged": "max_wedged",
             "breaker_opens": "max_breaker_opens"}
_SLO_INT_KEYS = ("min_requests", "wedged", "breaker_opens")


def _parse_slo(spec: str) -> dict:
    """``--slo`` spec → GuardianPolicy kwargs: a comma list of
    ``key:value`` pairs, e.g. ``p99_ms:500,err_rate:0.05`` (absolute
    canary p99 ceiling + error-rate margin over live) or
    ``p99_ratio:2.0,wedged:0``. Unknown keys exit with usage — a typo
    must not silently run an unguarded bake."""
    out = {}
    for part in spec.split(","):
        if not part:
            continue
        key, sep, val = part.partition(":")
        dest = _SLO_KEYS.get(key.strip())
        if not sep or dest is None:
            raise SystemExit(
                f"--slo {spec!r}: expected comma-separated key:value "
                f"pairs with keys from {sorted(_SLO_KEYS)} "
                "(e.g. p99_ms:500,err_rate:0.05)")
        try:
            out[dest] = (int(val) if key.strip() in _SLO_INT_KEYS
                         else float(val))
        except ValueError:
            raise SystemExit(
                f"--slo {spec!r}: {key.strip()!r} needs a number, "
                f"got {val!r}")
    return out


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
    p.add_argument("--models", default=None,
                   help="comma list of model archs (basic, small) to "
                        "serve as independent live models behind a "
                        "ModelRegistry (one engine/scheduler/metrics "
                        "namespace per model, weights seeded from "
                        "--seed); the summary line gains per-model and "
                        "per-priority blocks")
    p.add_argument("--canary", type=float, default=0.0, metavar="F",
                   help="with --models: deploy a same-arch canary (a "
                        "second seeded weight set) for the FIRST model "
                        "at this deterministic request-hash fraction "
                        "before traffic, and promote it after (a "
                        "weight swap into the live engine: nothing is "
                        "captured)")
    p.add_argument("--priority-mix", default="0:0", metavar="I:B",
                   help="with --models: interactive:batch request "
                        "counts per cycle of each submitter's traffic "
                        "(0:0 = priority-less)")
    p.add_argument("--guardian", action="store_true",
                   help="with --models: the SLO guardian owns the "
                        "rollout verdict — it bakes the canary against "
                        "the live variant's window metrics and "
                        "auto-promotes (clean) or auto-rolls-back (SLO "
                        "breach); the summary gains a guardian block. "
                        "With --chaos the plans also draw "
                        "guardian.decide")
    p.add_argument("--slo", default=None, metavar="K:V,...",
                   help="guardian SLO overrides (keys: p99_ms absolute "
                        "canary p99 ceiling, p99_ratio/p99_slack_ms vs "
                        "live, err_rate margin over live, "
                        "min_requests, wedged, breaker_opens), e.g. "
                        "p99_ms:500,err_rate:0.05")
    p.add_argument("--bake-ms", type=float, default=2000.0,
                   help="guardian bake window: a clean canary "
                        "auto-promotes (max bake = 4x)")
    p.add_argument("--admission-budget", type=int, default=0,
                   metavar="N",
                   help="with --models: registry-wide admission budget "
                        "— at most N admitted-but-unsettled requests "
                        "across ALL models; exhaustion fails fast with "
                        "BackpressureError, counted per model as "
                        "admission_rejected (0: off)")
    p.add_argument("--admission-reserve", type=int, default=None,
                   metavar="R",
                   help="interactive-only tokens of the admission "
                        "budget (default N/4): batch-class traffic "
                        "can never take the last R tokens")
    p.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="replica fleet: fan the engine out into N lanes "
                        "behind one scheduler on the card (each "
                        "replica its own weights, stream, graph pool "
                        "and captures); the summary grows a "
                        "per-replica 'fleet' block. Default 1: no "
                        "fleet")
    p.add_argument("--replica-ceiling", type=int, default=None,
                   metavar="M",
                   help="with --replicas: queue pressure grows the "
                        "fleet up to M lanes and idle lanes retire "
                        "back toward the --replicas floor")
    p.add_argument("--hosts", type=int, default=0, metavar="N",
                   help="host fleet (serving/hosts.py): N loopback host "
                        "workers behind the transport seam, admitted by "
                        "push and prewarm before traffic, heartbeat-"
                        "monitored with failover; the summary grows a "
                        "per-host 'hosts' block. With --chaos the plans "
                        "also draw transport.send / transport.recv / "
                        "host.heartbeat. Default 0: no fleet")
    p.add_argument("--hosts-kill-one", action="store_true",
                   help="with --hosts: poison host h0 after submission "
                        "while the queue drains (dead verdict, lane "
                        "quarantine, failover to survivors, every "
                        "request settled exactly once)")
    p.add_argument("--aot-cache", default=None, metavar="DIR",
                   help="program store directory (serving/aot.py): the "
                        "engine loads programs already there instead of "
                        "tracing them and stores what it traces; the "
                        "summary grows aot_hits/aot_misses/compiles/"
                        "compiles_avoided. Run the same drill twice "
                        "against one DIR for the load-against-trace A/B")
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
    if args.ragged and args.models:
        raise SystemExit("--ragged is a single-model drill knob (the "
                         "registry drills keep the bucketed path)")
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
    if trace_path and args.models and args.chaos:
        raise SystemExit("--trace-path with --models --chaos is not "
                         "wired yet (each chaos round builds a fresh "
                         "registry/ledger and the shared spans file "
                         "would repeat trace ids) — trace the "
                         "single-model chaos or the plain registry "
                         "drill")
    if args.replicas > 1 or args.replica_ceiling:
        if args.models or args.chaos:
            raise SystemExit(
                "--replicas/--replica-ceiling drive the plain drill "
                "only for now (registry drills size their own fleets "
                "via canary_fraction; the chaos harness stays "
                "single-engine) — drop --models/--chaos")
        if args.feature_cache:
            raise SystemExit(
                "--replicas with --feature-cache is not supported: "
                "the device-resident feature pool is single-engine "
                "state (a stream's cached activations live on ONE "
                "replica) — run the fleet without it")
    if args.hosts:
        if args.models:
            raise SystemExit(
                "--hosts drives the single-model drills only for now "
                "(the registry drill builds its engines internally) "
                "— drop --models")
        if args.ragged:
            raise SystemExit(
                "--hosts with --ragged is not supported: remote lanes "
                "speak the bucketed engine surface — run the host drill "
                "without --ragged")
        if args.feature_cache:
            raise SystemExit(
                "--hosts with --feature-cache is not supported: the "
                "device-resident feature pool is single-engine state "
                "— run the host drill without it")
    if args.hosts_kill_one and not args.hosts:
        raise SystemExit("--hosts-kill-one needs --hosts")
    if args.hosts_kill_one and args.chaos:
        raise SystemExit("--hosts-kill-one drives the plain drill "
                         "(the chaos rounds inject their own host "
                         "faults through the widened site vocabulary)")
    if (args.guardian or args.admission_budget) and not args.models:
        raise SystemExit("--guardian/--admission-budget need --models "
                         "(they are ModelRegistry features)")
    if args.aot_cache and args.models:
        raise SystemExit("--aot-cache with --models is not wired yet "
                         "(the registry drill builds its engines "
                         "internally; use ModelRegistry's artifact_dir= "
                         "in library code) — run the single-model drills "
                         "against the store")
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    if args.models:
        return _registry_main(args, shapes, metrics_path, trace_path,
                              trace_sample)
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
            trace_sample=trace_sample, aot_cache=args.aot_cache,
            hosts=args.hosts, device=args.device)
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
        trace_sample=trace_sample, seed=args.seed,
        aot_cache=args.aot_cache, replicas=args.replicas,
        replica_ceiling=args.replica_ceiling, hosts=args.hosts,
        host_kill_one=args.hosts_kill_one, device=args.device)
    print(json.dumps(summary), flush=True)
    return summary


def _registry_main(args, shapes, metrics_path, trace_path, trace_sample):
    """``--models``: the registry drill (or its chaos rounds) with one
    live model per arch name, weights seeded from ``--seed``."""
    from raft_tpu_torch.cli._args import corr_overrides
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT

    over = corr_overrides(args)
    # the small model's update block has no fused GRU
    arch = {"basic": RAFTConfig(**over),
            "small": RAFTConfig(small=True, **{
                k: v for k, v in over.items() if k != "gru_impl"})}
    models = []
    for name in args.models.split(","):
        c = arch.get(name)
        if c is None:
            raise SystemExit(f"--models {name!r}: choose from "
                             f"{sorted(arch)}")
        gen = torch.Generator().manual_seed(args.seed + len(models))
        models.append((name, RAFT(c, gen).state_dict(), c))
    try:
        mix = tuple(int(v) for v in args.priority_mix.split(":"))
        if len(mix) != 2 or any(v < 0 for v in mix):
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"--priority-mix {args.priority_mix!r}: expected "
            "INTERACTIVE:BATCH non-negative counts, e.g. 3:1 "
            "(0:0 = priority-less)")
    canary_variables = None
    if args.canary or args.chaos:
        # same arch as the first model, another seed — the "new
        # checkpoint" the rollout ships
        canary_variables = RAFT(models[0][2], torch.Generator().manual_seed(
            args.seed + 97)).state_dict()
    guardian_policy = None
    if args.guardian:
        guardian_policy = _parse_slo(args.slo) if args.slo else {}
        guardian_policy.setdefault("bake_window_s", args.bake_ms / 1e3)
        # size the evidence floor to the drill unless --slo pinned it:
        # the production default (min_requests=20) against a small
        # --requests run would hold past max_bake and roll every
        # clean canary back as insufficient_traffic
        guardian_policy.setdefault(
            "min_requests", max(1, min(20, args.requests // 8)))
    if args.chaos:
        summary = run_registry_chaos(
            models, shapes=shapes, rounds=args.chaos,
            requests=args.requests, submitters=args.submitters,
            bucket_batch=args.bucket_batch, iters=args.iters,
            priority_mix=mix, canary_fraction=args.canary or 0.5,
            canary_variables=canary_variables,
            dispatch_timeout_s=(args.dispatch_timeout_ms / 1e3
                                if args.dispatch_timeout_ms else 0.4),
            hang_s=args.hang_ms / 1e3,
            breaker_failures=args.breaker_failures or 2,
            breaker_backoff_s=args.breaker_backoff_ms / 1e3,
            breaker_backoff_max_s=max(args.breaker_backoff_max_ms,
                                      args.breaker_backoff_ms) / 1e3,
            gather_window_s=args.gather_ms / 1e3,
            deadline_s=(args.deadline_ms / 1e3 if args.deadline_ms
                        else None),
            guardian=args.guardian, guardian_policy=guardian_policy,
            # scaled like the non-chaos path: a decision can only land
            # after the bake window — a fixed wait below it would
            # report every clean round guardian_undecided
            guardian_timeout_s=max(8.0, 4 * args.bake_ms / 1e3),
            admission_budget=args.admission_budget or None,
            admission_reserve=args.admission_reserve,
            max_queue=args.queue, seed=args.seed,
            metrics_path=metrics_path, device=args.device)
        print(json.dumps(summary), flush=True)
        if summary["violations"]:
            raise SystemExit(1)
        return summary
    summary = run_registry_drill(
        models, shapes=shapes, requests=args.requests,
        submitters=args.submitters, bucket_batch=args.bucket_batch,
        iters=args.iters, priority_mix=mix,
        canary_fraction=args.canary, canary_variables=canary_variables,
        sessions=args.sessions, session_frames=args.session_frames,
        deadline_s=(args.deadline_ms / 1e3 if args.deadline_ms
                    else None),
        max_queue=args.queue, gather_window_s=args.gather_ms / 1e3,
        dispatch_timeout_s=(args.dispatch_timeout_ms / 1e3
                            if args.dispatch_timeout_ms else None),
        breaker_failures=args.breaker_failures,
        breaker_backoff_s=args.breaker_backoff_ms / 1e3,
        breaker_backoff_max_s=max(args.breaker_backoff_max_ms,
                                  args.breaker_backoff_ms) / 1e3,
        wire=args.wire, pipeline_depth=args.pipeline_depth,
        guardian=args.guardian, guardian_policy=guardian_policy,
        guardian_timeout_s=max(30.0, 8 * args.bake_ms / 1e3),
        admission_budget=args.admission_budget or None,
        admission_reserve=args.admission_reserve,
        metrics_path=metrics_path, trace_path=trace_path,
        trace_sample=trace_sample, seed=args.seed, device=args.device)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
