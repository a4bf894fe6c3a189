"""Async micro-batching scheduler: the serving front-end over the engine;
port of ``raft_tpu/serving/scheduler.py`` with its replica fleet, in
this process and in other host processes.

``RAFTEngine`` is a synchronous bucket router — one caller drives it at
a time, and a lone request pads a bucket's whole batch dimension with
zeros. Serving wins by decoupling request ARRIVAL from device DISPATCH
and coalescing ragged traffic into a small set of captured shapes (the
lesson Ragged Paged Attention draws for LLM inference kernels, arXiv
2604.15464). This module is that front-end: requests from any number of
callers land in one bounded queue, a single dispatcher thread groups
same-shape requests into a micro-batch, and the bucket's batch
dimension fills with *different callers' work* instead of padding. On
the card every micro-batch is one replay of the bucket's CUDA graph.

Robustness contract (first-class, not best-effort):

- **Backpressure**: the queue is bounded; a full queue rejects NEW work
  with :class:`BackpressureError` (counted as shed) — load shedding
  never touches accepted or in-flight requests.
- **Deadlines** are enforced while QUEUED only: a request that expires
  before dispatch fails fast with :class:`DeadlineExceeded`; a
  dispatched request always runs to completion (a replay is
  non-preemptible anyway) — zero deadline-abandoned in-flight work, by
  construction (``Future.set_running_or_notify_cancel`` pins it).
  Expiry is scanned at submit and, under a dispatch watchdog, from the
  supervision loop — an in-flight dispatch (even a slow capture) no
  longer starves already-expired queued requests.
- **Drain on shutdown**: ``close(drain=True)`` stops intake, finishes
  everything queued, and joins the worker — no leaked threads.
- **Live weight swap**: ``update_weights`` is safe under concurrent
  dispatch — the engine copies the new weights into its own storage on
  its stream under its lock, so a swap lands between dispatches, never
  inside one.

Resilience layer (serving/resilience.py; every knob defaults OFF, so
the base semantics above are unchanged until armed):

- **Dispatch watchdog** (``dispatch_timeout_s``): dispatch execution
  moves off the queue-owning dispatcher thread onto a supervised
  executor. A dispatch (capacity probe + capture + gather + device
  call) exceeding the wall-clock deadline gets a *wedge verdict*: its
  futures fail with :class:`DispatchWedged`, the stuck thread is
  quarantined and accounted (Python can't kill it — a replacement is
  spawned and the leak lands in metrics), the suspect bucket's program
  is dropped from the engine, and queued-deadline scanning never
  stopped while the dispatch was in flight. A quarantined thread never
  settles a future the verdict failed (``job.abandoned``), and the
  engine holds no lock across its ``engine.compile`` site, so a thread
  hung there blocks no other shape's capture.
- **Per-bucket circuit breakers** (``breaker_failures`` > 0): K
  consecutive failures/wedges open a request-shape's breaker — its
  traffic fails fast with :class:`CircuitOpen` (submit-time and
  queued) instead of burning the queue, while other shapes keep
  serving. After a jittered backoff the breaker half-opens; the next
  request is the probe, and a probe against a dropped bucket lazily
  recaptures it (``ensure_bucket``). Success closes the breaker.
- **Health surface**: :meth:`health` reports
  ``healthy | degraded | wedged`` plus per-bucket breaker states,
  worker liveness, last-dispatch age, and quarantined threads; state
  and breaker transitions append as events to the same metrics.jsonl
  the snapshots use.

Fault drills: every micro-batch passes through the ``serve.request``
fault site (testing/faults) — ``raise`` fails just that batch's
futures (the worker survives), ``hang`` models a half-up device. The
supervised executor adds ``serve.dispatch_exec``, the engine
``engine.compile``, and the pipelined completion stage ``serve.fetch``
— the chaos sites ``serve_bench --chaos`` drives.

Hot path (knobs default OFF): ``pipeline_depth`` > 1 splits dispatch
into stages over the engine's asynchronous dispatch (the replay is
queued on the engine's stream and returns; the blocking fetch moves to
a supervised completion worker), so the host's assembly, edge pad and
pinned copy of batch N+1 overlap the device's replay of batch N; a
``wire="u8"`` engine keeps frames uint8 from ``submit`` intake through
the host pads to the device (4× fewer H2D bytes, on-device
normalize). The ``hot_path`` metrics block (dispatch-gap histogram,
assembly overlap ratio, H2D bytes) measures it.

Priority classes (default OFF): ``submit(..., priority=...)`` tags a
request ``interactive`` (sessions, one-shot demos) or ``batch`` (bulk
offline traffic). Priority changes exactly two decisions and only when
both classes are actually queued: **shed-batch-first backpressure** —
an interactive arrival at a full queue evicts the newest queued
batch-class request (its future fails ``BackpressureError``, counted
shed AND failed so the accounting identity holds) instead of being
rejected itself — and **weighted dequeue** — the dispatcher picks the
interactive head ``interactive_weight`` times for every batch head, so
a batch flood cannot starve interactive p99 while batch still drains
at a bounded fraction. Priority-less traffic is one class: FIFO head,
reject-new backpressure. ``namespace`` prefixes breaker labels
(``model/HxW``) and stamps metrics records.

Observability rides along in :class:`~raft_tpu_torch.serving.metrics.
ServingMetrics`: per-bucket latency histograms for each stage
(enqueue->dispatch->complete), batch occupancy, queue depth, shed and
deadline-miss counters, wedge/quarantine/breaker counters, snapshotted
to ``metrics.jsonl`` on close and dumpable on demand
(``write_metrics``).

Request-scoped tracing (``tracer=`` default None): a
:class:`~raft_tpu_torch.serving.trace.TraceLedger` mints a span per
ACCEPTED request at intake and closes it exactly once on the path that
settled its future, with the outcome tag matching the
accounting-identity class it was counted under; dispatches add fan-in
spans (bucket key, padding-waste share) linked to their request spans,
and phase marks (taken/shipped/fetch_start) give ``serve_trace`` the
queue-vs-assembly-vs-device-vs-fetch attribution behind a p99 spike.

Replica fleet (``replicas`` > 1, ``replica_ceiling``, ``placement=``;
default OFF): N engines on one card (``RAFTEngine.spawn_replica``: each
its own weights, stream, pool and captures), one lane each behind the
one queue, picked least-loaded per dispatch, each with its own executor
and breaker board. A wedge quarantines one lane while the rest serve, and
``swap_weights`` moves every lane or none.

Host lanes (``host_fleet=``, default None): each admitted host of a
:class:`~raft_tpu_torch.serving.hosts.HostFleet` (an engine in another
process, behind a transport) is one more lane, after the local ones. Its
heartbeat verdicts drain on the dispatcher tick; a dead host's lane is
quarantined and its transport poisoned before its in-flight batch fails
over to the surviving lanes by requeue, every request settling exactly
once (a zombie's late answer is dropped). A rejoined host's lane serves
again.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from concurrent.futures import Future, InvalidStateError
from functools import partial
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.ops.padding import pad_amounts
from raft_tpu_torch.ops.interp import forward_interpolate_device
from raft_tpu_torch.parallel.placement import Placement
from raft_tpu_torch.serving.feature_cache import (FeatureCacheMiss,
                                                  FeatureCachePool)
from raft_tpu_torch.serving.futures import settle_future
from raft_tpu_torch.serving.hosts import HostDead
from raft_tpu_torch.serving.metrics import ServingMetrics
from raft_tpu_torch.serving.resilience import (BREAKER_CLOSED,
                                               BREAKER_OPEN, CircuitBreaker,
                                               CircuitOpen,
                                               DispatchExecutor,
                                               DispatchWedged, _DispatchJob)
from raft_tpu_torch.serving.trace import UNARMED, TraceLedger
from raft_tpu_torch.serving.trace import span as layer_span
from raft_tpu_torch.serving.transport import TransportError
from raft_tpu_torch.testing.faults import fault_point


#: priority classes: ``interactive`` holds its p99 under load (evicts
#: queued batch work at a full queue, wins the weighted dequeue);
#: ``batch`` is the bulk tier that sheds first. None = the single
#: historical class.
PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BATCH = "batch"
_PRIORITIES = (None, PRIORITY_INTERACTIVE, PRIORITY_BATCH)


class BackpressureError(RuntimeError):
    """Queue at max_queue: shed — the submitter should back off/retry.
    Also fails a QUEUED batch-class future whose slot was taken by an
    interactive arrival (shed-batch-first)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired while it was still queued."""


class SchedulerClosed(RuntimeError):
    """submit() after close(), or queued work dropped by a no-drain
    close."""


#: lock order (nothing may ever acquire these in the reverse direction;
#: the breaker fires its listeners OUTSIDE its lock precisely so
#: ``_on_breaker`` can take ``_state_lock``): the health recompute holds
#: ``_state_lock`` while reading the queue (``_cv``), the pipeline FIFO
#: (``_pipe_lock``) and the breaker board; ``_cv`` is held while metrics
#: record and while the deadline sweep closes spans; a completion wedge
#: holds ``_pipe_lock`` across the executor swap.
LOCK_ORDER = (
    ("scheduler.MicroBatchScheduler._state_lock",
     "scheduler.MicroBatchScheduler._cv",
     "metrics.ServingMetrics._lock"),
    ("scheduler.MicroBatchScheduler._state_lock",
     "scheduler.MicroBatchScheduler._pipe_lock",
     "resilience.DispatchExecutor._lock"),
    ("scheduler.MicroBatchScheduler._state_lock",
     "resilience.CircuitBreaker._lock"),
    ("scheduler.MicroBatchScheduler._cv",
     "trace.TraceLedger._lock"),
)

#: graftthread T6: wedge verdicts land every consequence (drop the suspect
#: program, record the breaker failure, quarantine the stuck thread)
#: before any future settles: a woken caller sees consistent state, never
#: a half-applied verdict.
GRAFTTHREAD = {
    "verdicts": ("_wedge_verdict", "_wedge_completion",
                 "_wedge_replica", "_wedge_host"),
    "consequences": ("drop_bucket", "record_failure",
                     "quarantine_and_replace"),
    "settles": ("_fail_requests",),
}

#: graftwire W4: the dead-host verdict lands every cross-seam consequence
#: (breaker, executor quarantine, placement mark, transport poison: the
#: one that unsticks a thread blocked in the dead host's recv) before the
#: in-flight batch is failed over or failed; ``_failover_requeue`` counts
#: as a settle because requeued requests are visible to the surviving
#: lanes the moment they are queued.
GRAFTWIRE = {
    "verdicts": ("_wedge_host",),
    "consequences": ("record_failure", "quarantine_and_replace",
                     "mark_host", "poison"),
    "settles": ("_fail_requests", "_failover_requeue"),
}


class ConfigError(ValueError):
    """A constructor-time knob combination that could only misbehave
    at runtime (e.g. ``feature_cache=True`` with ``replicas>1`` would
    silently correlate a stream's frames across replica-local device
    pools) — rejected loudly up front instead."""


class _ReplicaLane:
    """One replica's serving lane in the fleet: its engine, its own
    supervised dispatch executor (a single worker — the engine's
    single-caller contract holds PER REPLICA), its own breaker board
    (labels ``model/HxW/r<k>`` — a wedge on one replica's program must
    not open a sibling's breaker), the in-flight job, and the fan-out
    gauges the least-loaded pick reads. All mutable state is owned by
    the ONE fleet dispatcher thread; other threads only read it for
    health snapshots."""

    __slots__ = ("index", "engine", "exec", "breakers", "job",
                 "t_launch", "active", "quarantined", "dispatches",
                 "prev_pending", "idle_since", "host")

    def __init__(self, index: int, engine, host: Optional[str] = None):
        self.index = index
        self.engine = engine
        #: host name when this lane lives in ANOTHER process
        #: (serving/hosts.py); None for every local lane
        self.host = host
        self.exec = DispatchExecutor(f"MicroBatchScheduler-r{index}")
        self.breakers: Dict[Tuple, CircuitBreaker] = {}
        self.job: Optional[_DispatchJob] = None
        self.t_launch = 0.0
        #: takes new dispatches (False: retired by the idle policy or
        #: quarantined by a wedge verdict — the fleet serves without it)
        self.active = True
        self.quarantined = False
        self.dispatches = 0
        self.prev_pending = None
        self.idle_since: Optional[float] = time.monotonic()


class ServeResult(NamedTuple):
    flow: np.ndarray               #: (H, W, 2), cropped to the request
    flow_low: Optional[np.ndarray]  #: (hp/8, wp/8, 2) in ÷8-padded frame
    #: space when requested (``want_low``) — the next frame's warm-start
    #: substrate — else None


class _Request:
    __slots__ = ("image1", "image2", "key", "flow_init", "want_low",
                 "low_device", "future", "t_submit", "deadline",
                 "priority", "stream", "seq", "prime", "span")

    def __init__(self, image1, image2, key, flow_init, want_low,
                 low_device, deadline, priority=None, stream=None,
                 seq=0, prime=False):
        self.image1 = image1
        self.image2 = image2
        self.key = key                  # (H, W) — the coalescing group;
        #                                 (H, W, kind): ragged/cached rows
        self.flow_init = flow_init
        self.want_low = want_low
        self.low_device = low_device    # flow_low stays a device array
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.deadline = deadline        # absolute monotonic, or None
        self.priority = priority        # interactive | batch | None
        #: feature-cache stream identity + the session's frame counter
        #: (slot validity is seq-exact); ``prime`` rows carry no pair —
        #: their flow result is discarded, their cache output isn't
        self.stream = stream
        self.seq = seq
        self.prime = prime
        #: request-tracing span (serving/trace.py) — None whenever the
        #: scheduler runs without a ledger (tracing off, the default)
        self.span = None


class MicroBatchScheduler:
    """Bounded-queue micro-batching front-end over a ``RAFTEngine``.

    ``max_queue``: pending-request bound (backpressure past it).
    ``max_batch``: coalescing ceiling per dispatch; for a spatial shape
    with no built bucket, ONE bucket is pre-warmed at this batch
    so later micro-batches batch-fill instead of capturing per fill
    count. ``gather_window_s``: how long dispatch holds an underfull
    micro-batch open for concurrent submitters — the latency/occupancy
    knob (bounded; an already-full batch never waits).

    Resilience knobs (all default OFF — identical semantics until set):
    ``dispatch_timeout_s`` arms the dispatch watchdog (must exceed
    ``gather_window_s`` plus a worst-case capture — the deadline covers
    the whole supervised dispatch). ``breaker_failures`` > 0 arms
    per-bucket circuit breakers opening after that many consecutive
    failures/wedges, with jittered exponential backoff
    (``breaker_backoff_s`` base, ``breaker_backoff_max_s`` cap,
    ``breaker_rng`` injectable for deterministic drills) before the
    half-open probe.

    ``pipeline_depth`` (default 1 — bitwise the historical path): at
    depth N > 1 the dispatch path splits into stages riding the
    engine's asynchronous dispatch. The dispatcher assembles and SHIPS
    batch K+1 while the device still computes batch K
    (``engine.infer_batch_async``),
    and the blocking D2H fetch + future settling move to a completion
    stage (its own supervised worker) — up to N batches are in flight,
    and the dispatch gap between consecutive device calls drops to ~0
    under load. The deadline/backpressure/accounting contract is
    unchanged: a handed-off batch is in-flight work (never shed, never
    deadline-expired), completions settle in dispatch order, and with
    the watchdog armed a completion exceeding ``dispatch_timeout_s``
    (a hang in device compute or D2H — the ``serve.fetch`` chaos
    site) gets the same wedge verdict as a stuck dispatch:
    consequences first (bucket dropped, breaker opened, completion
    worker quarantined + replaced, trailing completions re-queued on
    the replacement), THEN the batch's futures fail ``DispatchWedged``.

    ``interactive_weight`` (only observable when BOTH priority classes
    are queued): interactive dequeue picks per batch pick.
    ``namespace``: the model name this scheduler serves under a
    :class:`~raft_tpu_torch.serving.registry.ModelRegistry` — prefixes
    breaker labels and stamps metrics records; None (default) keeps
    single-model labels/records byte-identical.
    """

    def __init__(self, engine, *, max_queue: int = 64, max_batch: int = 8,
                 gather_window_s: float = 0.002,
                 dispatch_timeout_s: Optional[float] = None,
                 breaker_failures: int = 0,
                 breaker_backoff_s: float = 0.25,
                 breaker_backoff_max_s: float = 30.0,
                 breaker_rng: Optional[random.Random] = None,
                 pipeline_depth: int = 1,
                 interactive_weight: int = 4,
                 namespace: Optional[str] = None,
                 metrics: Optional[ServingMetrics] = None,
                 metrics_path: Optional[str] = None,
                 feature_cache: bool = False,
                 feature_cache_capacity: int = 256,
                 ragged: bool = False,
                 tracer: Optional[TraceLedger] = None,
                 replicas: int = 1,
                 replica_ceiling: Optional[int] = None,
                 replica_idle_retire_s: float = 30.0,
                 placement: Optional[Placement] = None,
                 host_fleet=None):
        """(Trailing knobs) ``feature_cache=True`` (needs a
        ``RAFTEngine(feature_cache=True)``) arms the cross-frame
        device feature-cache pool: ``submit_cached`` becomes
        available, per-stream encoder state lives on device in a
        ``feature_cache_capacity``-slot LRU pool
        (serving/feature_cache), and warm video pairs dispatch
        through the cached bucket signature — one encoder pass and
        ONE frame of H2D per pair. Default OFF: no pool exists,
        ``submit_cached`` raises, everything else is bitwise
        unchanged.

        ``ragged=True`` (needs a ``RAFTEngine(ragged=True)``): the
        coalescing key becomes the engine's CAPACITY CLASS instead of
        the request's ``(h, w)`` — requests of ANY shape mapping to
        the same class box fill one micro-batch and dispatch through
        ONE ragged executable (``infer_ragged_async``), with per-row
        crops on the way out. Today's same-shape-only coalescing can
        only fill a batch from one shape's queue; the ragged key fills
        it from the whole mixed-shape queue. Breakers, deadlines,
        priorities, pipelining and the accounting identity are
        unchanged — a class is just a coarser bucket key (labelled
        ``BxHxW/ragged``). Default OFF: keys, labels and dispatch are
        byte-identical to the bucketed path.

        ``tracer`` (a :class:`~raft_tpu_torch.serving.trace.TraceLedger`)
        arms request-scoped tracing: every ACCEPTED request gets a
        span minted at intake and closed exactly once with the
        accounting class it was counted under; dispatches get fan-in
        spans linked to their request spans; spans.jsonl appends under
        the ledger's sampling knob with always-keep-tail exemplars.
        Default None: no span objects exist, every path above is
        bitwise the untraced stack.

        ``replicas`` > 1 (or a ``replica_ceiling`` above it, or an
        explicit ``placement``) arms the REPLICA FLEET: N sibling
        engines on the card (``RAFTEngine.spawn_replica`` — each its own
        weights, stream, graph pool and captures of the primary's
        programs) each serve whole coalesced micro-batches on their own
        supervised lane, picked least-loaded per dispatch. Each lane
        carries its OWN breaker board (``model/HxW/r<k>``) and a wedge
        verdict quarantines ONE replica while the rest keep serving;
        queue pressure activates lanes up to ``replica_ceiling`` and
        ``replica_idle_retire_s`` of idleness retires them back to the
        floor. The placement layer
        (:class:`~raft_tpu_torch.parallel.placement.Placement`) owns
        both decisions. ``replicas=1`` (the default) is the
        single-engine scheduler. ``feature_cache`` and
        ``pipeline_depth>1`` raise :class:`ConfigError` with a fleet —
        see the messages for why.

        ``host_fleet`` (a :class:`~raft_tpu_torch.serving.hosts.
        HostFleet`, already admitted: every host's programs pushed and
        prewarmed) extends the replica fleet across processes: each
        remote worker becomes one more lane, served through its
        :class:`~raft_tpu_torch.serving.hosts.RemoteEngine` proxy like a
        local replica. The fleet's heartbeat monitor is started here;
        its dead-host verdicts drain on the dispatcher tick into
        :meth:`_wedge_host` (quarantine and transport poison FIRST, then
        the in-flight batch FAILS OVER by requeue to the surviving lanes:
        never stranded, never settled twice). With remote lanes, set
        ``breaker_failures>=1`` so a dying but not yet verdicted host is
        paced by its lane breakers instead of re-picked every tick.
        ``ragged=True`` with a fleet raises :class:`ConfigError`.
        ``host_fleet=None`` (the default) builds none of this."""
        self.engine = engine
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.gather_window_s = float(gather_window_s)
        self.dispatch_timeout_s = (float(dispatch_timeout_s)
                                   if dispatch_timeout_s else None)
        #: interactive heads dequeued per batch head when BOTH classes
        #: are queued (priority-less or single-class queues stay FIFO);
        #: >= 1 so batch is rationed, never starved
        self.interactive_weight = max(1, int(interactive_weight))
        self._rr = 0           # weighted-round-robin dispatch counter
        #: lifetime class flags (set under _cv at submit): until BOTH
        #: have been seen, class mixing is impossible and the
        #: dispatcher's head choice stays the O(1) FIFO peek — the
        #: priority-less hot path never pays a queue scan
        self._seen_batch = False
        self._seen_interactive = False
        self.namespace = namespace
        self.metrics = metrics or ServingMetrics(metrics_path,
                                                 namespace=namespace)
        if feature_cache and not getattr(engine, "feature_cache", False):
            raise ValueError(
                "feature_cache=True needs an engine built with "
                "feature_cache=True (the cached bucket signature)")
        if ragged and not getattr(engine, "ragged", False):
            raise ValueError(
                "ragged=True needs an engine built with ragged=True "
                "(the capacity-class programs)")
        if ragged and feature_cache:
            raise ValueError(
                "ragged=True with feature_cache=True is not supported "
                "yet — the cached signature keeps per-shape buckets")
        self._ragged = bool(ragged)
        #: replica fleet: the placement layer owns replica construction
        #: and assignment and the per-bucket replicate-vs-shard decision;
        #: the scheduler owns the lanes. Fleet mode is any ceiling above
        #: one engine; replicas=1 with no ceiling builds NO placement and
        #: stays the single-engine path.
        want = (placement.ceiling if placement is not None
                else max(1, int(replicas), int(replica_ceiling or 0)))
        if host_fleet is not None and ragged:
            raise ConfigError(
                "ragged=True with host_fleet: remote lanes speak the "
                "bucketed engine surface only — capacity-class "
                "programs are not proxied yet")
        if want > 1 or host_fleet is not None:
            if feature_cache:
                raise ConfigError(
                    "feature_cache=True with replicas>1: a stream's "
                    "device slot lives in ONE replica's pool, and "
                    "fleet coalescing would silently correlate its "
                    "frames across replica-local pools — run one "
                    "feature-cache scheduler per replica (pinning "
                    "streams yourself) or set replicas=1")
            if int(pipeline_depth) > 1:
                raise ConfigError(
                    "pipeline_depth>1 with replicas>1: fleet lanes run "
                    "dispatch+fetch+settle inline per replica — cross-"
                    "batch overlap comes from replica concurrency, not "
                    "a shared completion stage")
        self.placement = (placement if placement is not None
                          else (Placement(engine, replicas=replicas,
                                          ceiling=replica_ceiling)
                                if want > 1 or host_fleet is not None
                                else None))
        #: fleet lanes, primary first; EMPTY list = single-engine mode
        #: (every `if self._lanes` fleet branch below is dead)
        self._lanes: List[_ReplicaLane] = (
            [_ReplicaLane(k, eng)
             for k, eng in enumerate(self.placement.engines)]
            if self.placement is not None else [])
        #: the host fleet: each admitted remote worker is one more lane,
        #: appended AFTER the local lanes (local indices never move); its
        #: heartbeat verdicts drain in _run_fleet
        self.host_fleet = host_fleet
        if host_fleet is not None:
            if host_fleet.metrics is None:
                host_fleet.metrics = self.metrics
            for name, host in host_fleet.hosts.items():
                idx = self.placement.attach_host(name, host.engine)
                lane = _ReplicaLane(idx, host.engine, host=name)
                # pre-warm-before-traffic: a host that was never admitted
                # (programs unverified) starts INACTIVE, and only a
                # rejoin notice can activate it
                lane.active = host.ready
                self._lanes.append(lane)
            host_fleet.start()
        self.replica_idle_retire_s = float(replica_idle_retire_s)
        #: swap barrier: a fleet-atomic weight swap quiesces the lanes
        #: (no new launches) while the dispatcher keeps reaping
        self._swapping = False
        #: the dispatcher is changing the fleet (growing a replica or
        #: launching on a lane). Set and read under ``_cv``: it is set
        #: only while no swap is up, and a swap is raised only while it
        #: is clear, so a replica grown from the pre-swap weights always
        #: joins ``_lanes`` before the epoch lists them
        self._mutating = False
        #: high-water mark of simultaneously busy lanes (the fan-out
        #: gauge: > 1 when two lanes dispatched at once)
        self._concurrency_max = 0
        #: request-tracing ledger (serving/trace.py); public so
        #: sessions (parent chaining) and the registry (intake stamps)
        #: can reach it duck-typed. None = tracing off, zero overhead.
        self.tracer = tracer
        self._fcache = (FeatureCachePool(feature_cache_capacity)
                        if feature_cache else None)
        if self._fcache is not None:
            # snapshots grow a per-bucket feature_cache block; the
            # provider is read with NO metrics lock held (pool lock
            # stays a leaf)
            self.metrics.feature_cache_provider = self._fcache.snapshot
        self._cv = threading.Condition()
        self._q: Deque[_Request] = collections.deque()
        self._capacity: Dict[Tuple[int, int], int] = {}
        self._closed = False
        self._breaker_failures = int(breaker_failures)
        self._breaker_backoff_s = float(breaker_backoff_s)
        self._breaker_backoff_max_s = float(breaker_backoff_max_s)
        self._breaker_rng = breaker_rng
        self._breakers: Dict[Tuple[int, int], CircuitBreaker] = {}
        # fleet mode: each lane has its own executor and the fleet
        # watchdog verdicts per lane — the single supervised executor
        # stays un-built
        self._exec = (DispatchExecutor()
                      if self.dispatch_timeout_s is not None
                      and not self._lanes else None)
        self.pipeline_depth = max(1, int(pipeline_depth))
        #: pipelined completion stage: a second supervised worker owns
        #: the blocking fetch + settle; ``_pending_jobs`` is the FIFO
        #: of handed-off-but-unsettled batches (head == the one the
        #: completion worker is on — the watchdog's verdict target)
        self._completion = (DispatchExecutor("MicroBatchScheduler-compl")
                            if self.pipeline_depth > 1 else None)
        self._pipe_lock = threading.Lock()
        self._pending_jobs: Deque[_DispatchJob] = collections.deque()
        #: previous dispatch's PendingBatch — the dispatch-gap clock
        #: (its ``t_ready`` is None while the batch is still in flight,
        #: which IS the perfect-overlap reading: gap 0)
        self._prev_pending = None
        #: the engine's wire dtype: keep frames in it end-to-end so a
        #: u8 wire never widens on the host (submit → stack → pad →
        #: H2D all ride uint8)
        self._wire_np = (np.uint8
                         if getattr(engine, "wire", "f32") == "u8"
                         else np.float32)
        # guards the _health_state compare-and-set + event emit:
        # refreshes race in from the dispatcher, submitters (breaker
        # transitions), and health() callers, and an unsynchronized
        # RMW would emit duplicate/stale-previous serving_state events
        self._state_lock = threading.Lock()
        self._health_state = "healthy"
        self._inflight_since: Optional[float] = None
        self._last_dispatch_done: Optional[float] = None
        self._worker = threading.Thread(
            target=self._run_fleet if self._lanes else self._run,
            name="MicroBatchScheduler-dispatch", daemon=True)
        self._worker.start()

    # -- intake ------------------------------------------------------------

    def submit(self, image1, image2, *, deadline_s: Optional[float] = None,
               flow_init: Optional[np.ndarray] = None,
               want_low: bool = False, low_device: bool = False,
               priority: Optional[str] = None) -> Future:
        """Enqueue ONE ``(H, W, 3)`` frame pair; returns a Future
        resolving to :class:`ServeResult`. Raises
        :class:`BackpressureError` when the queue is full,
        :class:`CircuitOpen` when the shape's breaker is open, and
        :class:`SchedulerClosed` after ``close()``.

        ``priority``: ``"interactive"`` | ``"batch"`` | None (the
        single historical class). At a full queue an interactive
        arrival takes the newest queued batch request's slot (that
        future fails ``BackpressureError``); a batch or priority-less
        arrival is rejected as before.

        ``flow_init`` may be a host array (validated here, embedded on
        the host) or a device tensor the engine itself produced
        (``low_device=True`` results) — the device path never round-
        trips through host memory. ``low_device=True`` makes the
        result's ``flow_low`` a device tensor too."""
        if priority not in _PRIORITIES:
            raise ValueError(
                f"priority={priority!r}: choose "
                f"{PRIORITY_INTERACTIVE!r}, {PRIORITY_BATCH!r} or None")
        image1 = np.asarray(image1)
        image2 = np.asarray(image2)
        # frames ride the engine's wire dtype from intake on: with a
        # u8-wire engine every downstream copy (stack, pad) moves 1
        # byte/px instead of 4, and the host never widens
        if image1.dtype != self._wire_np:
            image1 = image1.astype(self._wire_np)
        if image2.dtype != self._wire_np:
            image2 = image2.astype(self._wire_np)
        if image1.ndim != 3 or image1.shape[-1] != 3:
            raise ValueError(
                f"submit takes one (H, W, 3) frame pair, got "
                f"{image1.shape} — batching is the scheduler's job")
        if image1.shape != image2.shape:
            raise ValueError(f"frame shapes differ: {image1.shape} vs "
                             f"{image2.shape}")
        if ((flow_init is not None or want_low)
                and not getattr(self.engine, "warm_start", False)):
            raise ValueError(
                "flow_init/want_low need a warm_start=True engine")
        if flow_init is not None:
            h, w = image1.shape[:2]
            left, right, top, bottom = pad_amounts(h, w)
            want = ((h + top + bottom) // 8, (w + left + right) // 8, 2)
            if not isinstance(flow_init, torch.Tensor):
                flow_init = np.asarray(flow_init, np.float32)
                if flow_init.shape != want:
                    # validated HERE so a malformed warm start fails ITS
                    # caller alone — at dispatch time the row assignment
                    # would throw inside the shared try and fail (or, if
                    # broadcastable, silently corrupt) the whole
                    # coalesced micro-batch, other callers included
                    raise ValueError(
                        f"flow_init shape {flow_init.shape} != {want} "
                        "(1/8 of the ÷8-padded frame)")
                if not np.isfinite(flow_init).all():
                    # a NaN warm start would only poison this caller's
                    # own row, but fail it here with a cause instead of
                    # returning NaN flow from the device
                    raise ValueError(
                        "flow_init contains non-finite values")
            else:
                # device-resident warm start: shape-check without a
                # D2H sync. No finiteness read — the device
                # forward-splat (ops/interp.forward_interpolate_device)
                # drops non-finite points by construction, so a
                # poisoned flow degrades to a cold start, not NaN flow
                if tuple(flow_init.shape) != want:
                    raise ValueError(
                        f"flow_init shape {tuple(flow_init.shape)} != "
                        f"{want} (1/8 of the ÷8-padded frame)")
        if self._ragged:
            # CROSS-SHAPE coalescing: the key is the capacity-class
            # box this shape maps to, so mixed-shape requests share a
            # queue group (and a breaker) — compiles nothing here
            h, w = image1.shape[:2]
            key = self.engine.ragged_class_for(h, w) + ("ragged",)
        else:
            key = tuple(image1.shape[:2])
        self._intake_guard(key)
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req = _Request(image1, image2, key, flow_init, want_low,
                       low_device, deadline, priority)
        if self.tracer is not None:
            req.span = self._trace_begin(
                key, priority, deadline_s, warm=flow_init is not None)
        self._enqueue_traced(req, priority)
        return req.future

    def submit_cached(self, frame, *, stream, seq: int,
                      prime: bool = False,
                      deadline_s: Optional[float] = None,
                      priority: Optional[str] = None) -> Future:
        """Enqueue ONE frame of a feature-cached video stream; returns
        a Future resolving to :class:`ServeResult` (``flow_low`` is
        always None — the recurrence state lives in the device pool).

        ``stream`` is the pool slot identity; ``seq`` is the stream's
        frame counter. ``prime=True`` submits the stream's (re)start
        frame: the dispatch's flow output is discarded (the future
        resolves to ``ServeResult(None, None)``) and its cache output
        installs the slot — pair ``seq`` then correlates THIS frame
        against a slot at ``seq - 1``. A pair submit with no valid
        slot (never primed, LRU-evicted, flushed by a weight swap, or
        a seq hole left by a failed/expired pair) fails fast with
        :class:`~raft_tpu_torch.serving.feature_cache.FeatureCacheMiss` —
        the caller cold-restarts by re-priming
        (``VideoSession(feature_cache=True)`` does this itself).

        Raises the same intake errors as :meth:`submit`
        (``BackpressureError``/``CircuitOpen``/``SchedulerClosed``;
        cached rows get their own breaker per shape, labelled
        ``HxW/cache``)."""
        if self._fcache is None:
            raise ValueError(
                "submit_cached needs a feature_cache=True scheduler")
        frame = np.asarray(frame)
        if frame.dtype != self._wire_np:
            frame = frame.astype(self._wire_np)
        if frame.ndim != 3 or frame.shape[-1] != 3:
            raise ValueError(
                f"submit_cached takes one (H, W, 3) frame, got "
                f"{frame.shape}")
        if priority not in _PRIORITIES:
            raise ValueError(
                f"priority={priority!r}: choose "
                f"{PRIORITY_INTERACTIVE!r}, {PRIORITY_BATCH!r} or None")
        h, w = frame.shape[:2]
        key = (h, w, "cached")
        # closed/breaker checks BEFORE the pool probe: a closed (or
        # draining) scheduler must say SchedulerClosed — the registry
        # re-route catches that, while a spurious FeatureCacheMiss
        # would send the session into a futile re-prime round trip
        # against a dead variant (and mutate a flushed pool's counters)
        self._intake_guard(key)
        if not prime and not self._fcache.valid(stream, (h, w),
                                                seq - 1):
            # fail fast BEFORE the queue: a pair with no valid slot
            # could only dispatch garbage — the miss is the caller's
            # cold-restart signal, not a request failure
            self._fcache.record_miss()
            raise FeatureCacheMiss(
                f"stream {stream!r} has no valid cache slot for "
                f"{h}x{w} seq {seq - 1} (unprimed, evicted, flushed, "
                "or a missed store) — re-prime the previous frame")
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req = _Request(None, frame, key, None, False, False, deadline,
                       priority, stream=stream, seq=int(seq),
                       prime=prime)
        if self.tracer is not None:
            req.span = self._trace_begin(
                key, priority, deadline_s, stream=stream, seq=int(seq),
                prime=prime)
        self._enqueue_traced(req, priority)
        return req.future

    def _intake_guard(self, key) -> None:
        """Shared submit-time fail-fast checks (closed, open breaker)."""
        with self._cv:
            if self._closed:
                # checked before the breaker: a closed scheduler must
                # say so — CircuitOpen's "retry after backoff" would
                # send the caller into a futile retry loop
                raise SchedulerClosed("scheduler is closed")
        if self._lanes:
            # fleet: a shape fails fast only when it is open on EVERY
            # active replica — one replica's bad program must not
            # reject traffic its siblings serve fine (state() promotes
            # an expired open to half_open, so the probe gets through)
            states = []
            for lane in self._lanes:
                if not lane.active:
                    continue
                br = lane.breakers.get(key)
                states.append(br.state() if br is not None
                              else BREAKER_CLOSED)
            if states and all(s == BREAKER_OPEN for s in states):
                self.metrics.record_circuit_rejected()
                raise CircuitOpen(
                    f"bucket {key} circuit open on every active "
                    "replica — failing fast; retry after backoff")
            return
        br = self._breakers.get(key)
        if br is not None and br.state() == BREAKER_OPEN:
            # fail fast at intake: an open bucket must not burn queue
            # slots healthy shapes could use (state() promotes an
            # expired open to half_open, so the first submit past the
            # backoff gets through as the probe)
            self.metrics.record_circuit_rejected()
            raise CircuitOpen(
                f"bucket {key} circuit open ({br.consecutive} "
                "consecutive failures) — failing fast; retry after "
                "backoff")

    def _enqueue(self, req: _Request, priority: Optional[str]) -> None:
        """Shared queue-insertion tail: expiry sweep, backpressure
        (shed-batch-first for interactive arrivals), append + notify."""
        with self._cv:
            if self._closed:
                raise SchedulerClosed("scheduler is closed")
            # sweep expired entries first: they must not hold
            # backpressure slots, and submit is an expiry edge — a
            # deadline fires within one submit/supervision tick even
            # while a dispatch is in flight
            self._sweep_locked(time.monotonic())
            if len(self._q) >= self.max_queue:
                victim = None
                if priority == PRIORITY_INTERACTIVE:
                    # shed-batch-first: the NEWEST queued batch-class
                    # entry gives up its slot (it has waited least —
                    # the oldest is closest to dispatch and evicting it
                    # would waste the most queue time). Interactive and
                    # priority-less entries are never evicted.
                    for r in reversed(self._q):
                        if (r.priority == PRIORITY_BATCH
                                and not r.future.done()):
                            victim = r
                            break
                if victim is None:
                    self.metrics.record_shed(priority)
                    raise BackpressureError(
                        f"queue full ({self.max_queue} pending) — "
                        "shedding new work; retry with backoff")
                self._q.remove(victim)
                if settle_future(
                        victim.future, BackpressureError(
                            "shed by an interactive arrival under "
                            "full-queue backpressure (batch class "
                            "sheds first); retry with backoff"),
                        # raced: the victim's caller cancelled in the
                        # race window
                        raced=self.metrics.record_cancelled):
                    self.metrics.record_evicted(victim.priority)
                    if self.tracer is not None \
                            and victim.span is not None:
                        # evicted futures fail (counted shed AND
                        # failed) — the span's class follows the
                        # counter, the outcome names the real story
                        self.tracer.close(victim.span, "evicted",
                                          "failed")
                else:
                    self._trace_cancel(victim)
            self._q.append(req)
            if priority == PRIORITY_BATCH:
                self._seen_batch = True
            else:
                self._seen_interactive = True
            self.metrics.record_submit(depth=len(self._q),
                                       priority=priority)
            self._cv.notify()

    # -- request tracing (serving/trace.py; every helper is a no-op
    # when self.tracer is None — the tracing-off hot path pays one
    # attribute read) -------------------------------------------------------

    def _enqueue_traced(self, req: _Request, priority) -> None:
        """``_enqueue`` with span hygiene: a request REJECTED at the
        queue (backpressure, closed) was never accepted — its
        just-minted span is discarded, never an orphan; an accepted
        one stamps its trace id onto the returned future (the
        session-chaining handle)."""
        if req.span is None:
            self._enqueue(req, priority)
            return
        try:
            self._enqueue(req, priority)
        except BaseException:
            self.tracer.discard(req.span)
            raise
        req.future.trace_id = req.span.trace_id

    def _trace_begin(self, key, priority, deadline_s, *, warm=False,
                     stream=None, seq=None, prime=False):
        """Mint one accepted request's span at intake: bucket label,
        priority/deadline, breaker state at admit (``peek`` — the
        read must not promote a half-open probe), cache identity for
        cached rows. The registry's thread-local intake stamp
        (model/variant/canary) and a session's parent link merge in
        at ``begin``."""
        fields = {"bucket": self._key_label(key)}
        if self.namespace is not None:
            fields["model"] = self.namespace
        if priority is not None:
            fields["priority"] = priority
        if deadline_s is not None:
            fields["deadline_s"] = deadline_s
        if warm:
            fields["warm"] = True
        if stream is not None:
            fields["stream"] = str(stream)
            fields["seq"] = seq
            if prime:
                fields["prime"] = True
        br = self._breakers.get(key)
        fields["breaker_at_admit"] = (br.peek() if br is not None
                                      else BREAKER_CLOSED)
        return self.tracer.begin("request", **fields)

    def _trace_cancel(self, req: _Request) -> None:
        """Close a span whose caller cancelled the future (reaped at
        sweep/take/dispatch, or raced into a settle)."""
        if self.tracer is not None and req.span is not None:
            self.tracer.close(req.span, "cancelled", "cancelled")

    def _trace_dispatch(self, live: List[_Request], label: str,
                        bucket, t_disp: float, real_px: int,
                        padded_px: int, **extra) -> None:
        """Mint the coalesce fan-in DISPATCH span and link/mark the
        batch's request spans: one dispatch span carries N request
        trace ids (bucket/capacity-class key + padding-waste share),
        each request span gets the back-link, its ``taken`` mark, and
        its own padding share of the executable's box."""
        tr = self.tracer
        if tr is None:
            return
        spans = [r.span for r in live if r.span is not None]
        if not spans:
            return
        waste = (round(1.0 - real_px / padded_px, 4) if padded_px
                 else 0.0)
        d = tr.begin("dispatch", bucket=label, fan_in=len(live),
                     capacity=int(bucket[0]), padding_waste=waste,
                     requests=[s.trace_id for s in spans],
                     **({"model": self.namespace}
                        if self.namespace is not None else {}),
                     **extra)
        for r in live:
            if r.span is None:
                continue
            px = (r.image2.shape[0] * r.image2.shape[1]
                  if r.image2 is not None else 0)
            tr.mark(r.span, "taken", at=t_disp)
            r.span.linked = d
            tr.annotate(r.span, dispatch=d.trace_id, fan_in=len(live),
                        padding_share=(round(px / padded_px, 4)
                                       if padded_px else 0.0))

    def _trace_mark(self, live: List[_Request], phase: str,
                    at: Optional[float] = None) -> None:
        tr = self.tracer
        if tr is None:
            return
        t = at if at is not None else time.monotonic()
        for r in live:
            if r.span is not None:
                tr.mark(r.span, phase, at=t)

    def _trace_span_ctx(self, pending, live: List[_Request]) -> None:
        """Hand the batch's span context to the engine's PendingBatch
        so the pipelined completion stage can stamp ``fetch_start``
        from the pending it actually fetches (duck-typed pendings
        without the slot are tolerated — the marks just stay on the
        dispatch path's ``live`` closure)."""
        if self.tracer is None:
            return
        try:
            pending.span_ctx = [r.span for r in live]
        except AttributeError:
            pass

    def _trace_close_dispatch(self, live: List[_Request],
                              outcome: str) -> None:
        """Close the batch's linked dispatch span (idempotent — the
        failure paths close it per-request too, first close wins)."""
        tr = self.tracer
        if tr is None:
            return
        for r in live:
            if r.span is not None and r.span.linked is not None:
                tr.close(r.span.linked, outcome)
                return

    def update_weights(self, variables) -> None:
        """Live checkpoint swap; atomic wrt in-flight micro-batches
        (the engine snapshots its tree once per dispatch). With a
        feature cache armed, the pool flushes — features computed by
        the old weights must never feed the new ones (the engine's
        weights-version stamp is the backstop for the race window).
        With a replica fleet, the swap is FLEET-ATOMIC
        (:meth:`swap_weights`): all replicas move under one epoch or
        none do."""
        self.swap_weights(variables)
        if self._fcache is not None:
            self.flush_feature_cache("weights_swap")

    def swap_weights(self, variables, timeout_s: float = 30.0) -> None:
        """Swap the serving weights. Single engine: one atom under its
        lock (``RAFTEngine.update_weights`` copies into the module's
        own storage on its stream), so every dispatch queued before
        ran the old weights and every one after runs the new; the
        ``scheduler.swap`` fault site fires before the engine is
        touched, so a raise leaves it on the old weights.

        Replica fleet: one epoch over every lane that can serve again
        (a quarantined lane never does, and its abandoned worker may
        hold its engine). Raise the swap barrier (the dispatcher reaps
        in-flight lanes but grows and launches nothing new), wait for
        a grow or launch already under way to end (a grown replica is
        listed before the epoch reads the lanes) and for the lanes to
        quiesce (a lane's job ends after its replay's results were
        fetched), then swap engine by engine, each copy on that lane's
        own stream — any failure (the
        ``scheduler.swap`` chaos site fires before each lane) rolls the
        already-swapped engines BACK to a copy of their old weights
        before re-raising, so the fleet is never observable
        half-rolled: every dispatch before this returns ran the old
        weights everywhere, every dispatch after runs the new
        everywhere, a replica grown meanwhile included."""
        if not self._lanes:
            fault_point("scheduler.swap")
            self.engine.update_weights(variables)
            return
        with self._cv:
            if self._swapping:
                raise RuntimeError("a fleet weight swap is already in "
                                   "progress")
            self._swapping = True
        try:
            deadline = time.monotonic() + timeout_s
            with self._cv:
                if not self._cv.wait_for(lambda: not self._mutating,
                                         timeout=timeout_s):
                    raise RuntimeError(
                        f"the fleet did not finish growing or launching "
                        f"within {timeout_s}s for the weight swap")
            while any(lane.job is not None for lane in self._lanes):
                # the dispatcher keeps reaping (and wedging) under the
                # barrier — a wedged lane cannot stall the epoch past
                # its own verdict
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"fleet did not quiesce within {timeout_s}s "
                        "for the weight swap")
                time.sleep(0.001)
            swapped = []
            try:
                for lane in self._lanes:
                    if lane.quarantined:
                        continue
                    copy = getattr(lane.engine, "weights_copy", None)
                    old = (copy() if copy is not None
                           else lane.engine.variables)
                    fault_point("scheduler.swap")
                    lane.engine.update_weights(variables)
                    swapped.append((lane, old))
            except BaseException:
                # epoch abort: restore the engines already swapped (in
                # reverse) — a failed rollout leaves the WHOLE fleet
                # on the old weights, never a mixed set
                for lane, old in reversed(swapped):
                    lane.engine.update_weights(old)
                raise
            self.metrics.record_event(
                "fleet_weights_swap", replicas=len(self._lanes))
        finally:
            with self._cv:
                self._swapping = False
                self._cv.notify_all()

    def invalidate_stream(self, stream) -> bool:
        """Drop one stream's feature-cache slot (end-of-stream
        hygiene — ``VideoSession.drain`` calls this so a finished
        stream's device arrays stop occupying pool capacity). True if
        a slot was dropped; no-op without a pool."""
        if self._fcache is None:
            return False
        return self._fcache.invalidate(stream)

    def flush_feature_cache(self, reason: str, **stamp) -> int:
        """Drop every feature-cache slot and record a ``cache_flush``
        event (stamped with ``reason`` + any caller fields — the
        registry adds model/version). Returns how many slots dropped;
        no-op (0) when no pool is armed."""
        if self._fcache is None:
            return 0
        n = self._fcache.flush()
        self.metrics.record_event("cache_flush", reason=reason,
                                  slots=n, **stamp)
        return n

    # -- breakers / health -------------------------------------------------

    #: label suffix of each program kind's groups and buckets: a kind's
    #: program is its own failure domain, apart from another kind's at
    #: the same shape (a ragged key's dims are the CLASS box) — the one
    #: definition ``_key_label`` and the dispatch's bucket label use
    KIND_LABEL_SUFFIX = {"plain": "", "ragged": "/ragged",
                         "cached": "/cache"}

    @staticmethod
    def _key_parts(key) -> Tuple[int, int, str]:
        """A coalescing-group key as ``(h, w, kind)``: a plain key is the
        request's ``(h, w)``; a ragged key (a capacity class's box) and a
        cached key carry the engine's program kind after the extents."""
        return (*key, "plain")[:3]

    @classmethod
    def _key_label(cls, key) -> str:
        """Namespace-less label for a coalescing-group key: ``HxW`` and
        its kind's :attr:`KIND_LABEL_SUFFIX` — shared by ``_label`` and
        ``health()``."""
        h, w, kind = cls._key_parts(key)
        return f"{h}x{w}{cls.KIND_LABEL_SUFFIX[kind]}"

    def _label(self, key, lane: Optional[_ReplicaLane] = None) -> str:
        """Breaker/event label for a request shape: ``model/HxW``
        under a namespace, plain ``HxW`` single-model — the
        per-model+bucket key the shared metrics.jsonl needs. A fleet
        lane appends its replica suffix (``model/HxW/r<k>``): one
        replica's failure domain, one label."""
        base = self._key_label(key)
        if lane is not None:
            base = f"{base}/r{lane.index}"
        return f"{self.namespace}/{base}" if self.namespace else base

    def _breaker(self, key: Tuple[int, int],
                 lane: Optional[_ReplicaLane] = None
                 ) -> Optional[CircuitBreaker]:
        """The shape's breaker — on ``lane``'s own board in fleet mode
        (a wedge on replica k's program opens replica k's breaker,
        nobody else's) — created on first dispatch (so health lists
        every active bucket). None when breakers are disarmed."""
        if not self._breaker_failures:
            return None
        board = lane.breakers if lane is not None else self._breakers
        with self._cv:
            br = board.get(key)
            if br is not None:
                return br
        label = self._label(key, lane)
        br = CircuitBreaker(
            failures=self._breaker_failures,
            base_s=self._breaker_backoff_s,
            max_s=self._breaker_backoff_max_s,
            rng=self._breaker_rng,
            label=label,
            on_transition=lambda old, new, label=label:
                self._on_breaker(label, old, new))
        with self._cv:
            return board.setdefault(key, br)

    def _on_breaker(self, label: str, old: str, new: str) -> None:
        self.metrics.record_breaker_transition(label, old, new)
        self._refresh_state(f"breaker {label} {old}->{new}")

    def _compute_state(self) -> str:
        if not self._closed and not self._worker.is_alive():
            return "wedged"      # dispatcher died: nothing drains
        t0 = self._inflight_since
        if (self.dispatch_timeout_s is not None and t0 is not None
                and time.monotonic() - t0 > self.dispatch_timeout_s):
            return "wedged"      # verdict due/being handled right now
        if self._completion is not None \
                and self.dispatch_timeout_s is not None:
            with self._pipe_lock:
                head = (self._pending_jobs[0] if self._pending_jobs
                        else None)
                age = (time.monotonic() - head.t_start
                       if head is not None else 0.0)
            if age > self.dispatch_timeout_s:
                return "wedged"  # completion-stage verdict due
        if self._lanes and self.dispatch_timeout_s is not None:
            now = time.monotonic()
            for lane in self._lanes:
                job = lane.job
                if (job is not None and not job.done.is_set()
                        and now - lane.t_launch
                        > self.dispatch_timeout_s):
                    return "wedged"   # lane verdict due right now
        with self._cv:
            breakers = list(self._breakers.values())
            for lane in self._lanes:
                breakers.extend(lane.breakers.values())
        if any(br.peek() != BREAKER_CLOSED for br in breakers):
            return "degraded"
        if any(lane.quarantined for lane in self._lanes):
            return "degraded"    # serving on a reduced fleet
        if self.host_fleet is not None \
                and self.host_fleet.degradation() != "healthy":
            return "degraded"    # a host suspect, dead or partitioned
        return "healthy"

    def _refresh_state(self, reason: str) -> None:
        # lock order: _state_lock -> _cv -> breaker lock (compute
        # walks the breaker board); nothing takes _state_lock while
        # holding either of the others
        with self._state_lock:
            new = self._compute_state()
            old = self._health_state
            if new != old:
                self._health_state = new
                self.metrics.record_state_change(old, new, reason)

    def health(self) -> Dict:
        """Operator surface: overall state (``healthy`` — everything
        closed and live; ``degraded`` — at least one bucket breaker
        open/half-open; ``wedged`` — a dispatch is past its deadline or
        the dispatcher thread is dead), per-bucket breaker states,
        worker liveness, ages, and the quarantined-thread leak
        count."""
        self._refresh_state("health probe")
        now = time.monotonic()
        with self._cv:
            breakers = dict(self._breakers)
            depth = len(self._q)
        with self._pipe_lock:
            pending = len(self._pending_jobs)
        t0 = self._inflight_since
        done = self._last_dispatch_done
        out = {
            "state": self._health_state,
            "buckets": {self._key_label(k): br.snapshot()
                        for k, br in sorted(breakers.items())},
            "worker_alive": self._worker.is_alive(),
            "dispatch_worker_alive": (self._exec.worker_alive()
                                      if self._exec else None),
            "queue_depth": depth,
            "inflight_age_s": (round(now - t0, 3)
                               if t0 is not None else None),
            "last_dispatch_age_s": (round(now - done, 3)
                                    if done is not None else None),
            "quarantined_threads": self.metrics.quarantined_threads,
            "quarantined_alive": (self._exec.quarantined_alive()
                                  if self._exec else 0)
            + (self._completion.quarantined_alive()
               if self._completion else 0)
            + sum(lane.exec.quarantined_alive()
                  for lane in self._lanes),
            "pending_completions": pending,
            "completion_worker_alive": (self._completion.worker_alive()
                                        if self._completion else None),
        }
        if self._lanes:
            out["fleet"] = {
                "replicas": len(self._lanes),
                "active": sum(1 for ln in self._lanes if ln.active),
                "ceiling": self.placement.ceiling,
                "concurrency_max": self._concurrency_max,
                "placement": self.placement.snapshot(),
                "lanes": {
                    f"r{ln.index}": {
                        "active": ln.active,
                        "quarantined": ln.quarantined,
                        "busy": ln.job is not None,
                        "dispatches": ln.dispatches,
                        "worker_alive": ln.exec.worker_alive(),
                        **({"host": ln.host}
                           if ln.host is not None else {}),
                        "breakers": {
                            self._key_label(k): br.snapshot()
                            for k, br in sorted(
                                dict(ln.breakers).items())},
                    } for ln in self._lanes},
            }
        if self.host_fleet is not None:
            # degradation healthy|degraded|partitioned and the per-host
            # heartbeat, failover and push evidence
            out["hosts"] = self.host_fleet.health()
        return out

    # -- dispatch loop -----------------------------------------------------

    def _shape_capacity(self, key,
                        lane: Optional[_ReplicaLane] = None) -> int:
        """Per-key dispatch capacity, probed/warmed through the
        placement layer's :meth:`~raft_tpu_torch.parallel.placement.
        Placement.bucket_fit` (one copy of the capacity-or-ensure
        logic, engine-parametric, so every fleet lane warms ITS
        engine's table the way the single engine does). Cached per key
        (per key+replica in fleet mode: capacity is a property of one
        replica's table — a wedge drops one replica's bucket, not the
        fleet's number)."""
        ck = key if lane is None else (key, lane.index)
        cap = self._capacity.get(ck)
        if cap is None:
            eng = lane.engine if lane is not None else self.engine
            fit = Placement.bucket_fit(eng, *self._key_parts(key),
                                       self.max_batch)
            cap = max(1, min(fit, self.max_batch))
            self._capacity[ck] = cap
        return cap

    def _expire(self, req: _Request, now: float) -> bool:
        if req.deadline is not None and now > req.deadline:
            if settle_future(
                    req.future, DeadlineExceeded(
                        f"deadline expired after "
                        f"{now - req.t_submit:.3f}s in queue (never "
                        "dispatched)"),
                    # raced: the caller cancelled between the
                    # cancelled() check and here — count it as the
                    # cancel it was, and don't let the race kill a
                    # submitter or the dispatcher
                    raced=self.metrics.record_cancelled):
                self.metrics.record_deadline_miss(priority=req.priority)
                if self.tracer is not None and req.span is not None:
                    self.tracer.close(req.span, "deadline_expired",
                                      "deadline_missed")
            else:
                self._trace_cancel(req)
            return True
        return False

    def _sweep_locked(self, now: float) -> None:
        """Drop expired/caller-cancelled entries from the queue
        (caller holds ``_cv``). The single queue representation — every
        path that rewrites the queue goes through here or ``_take``,
        both keeping it a deque (a plain-list rebind would crash
        ``close``'s ``popleft``; pinned by regression test)."""
        if not any(r.deadline is not None or r.future.cancelled()
                   for r in self._q):
            return
        keep: Deque[_Request] = collections.deque()
        for r in self._q:
            if r.future.cancelled():
                self.metrics.record_cancelled()
                self._trace_cancel(r)
            elif self._expire(r, now):
                pass
            else:
                keep.append(r)
        self._q = keep

    def _expiry_scan(self) -> None:
        """Expiry edge usable from the supervision loop while a
        dispatch is in flight — queued deadlines fire within one poll
        tick instead of waiting out a slow compile or hung device."""
        with self._cv:
            self._sweep_locked(time.monotonic())

    def _gather(self, key: Tuple[int, int], capacity: int) -> None:
        """Hold dispatch open briefly so concurrent submitters can fill
        the micro-batch — bounded by ``gather_window_s``; a full batch
        (or a closing scheduler) never waits."""
        t_end = time.monotonic() + self.gather_window_s
        while True:
            with self._cv:
                if (self._closed
                        or sum(1 for r in self._q if r.key == key)
                        >= capacity):
                    return
            if time.monotonic() >= t_end:
                return
            time.sleep(min(0.0005, self.gather_window_s))

    def _take(self, key: Tuple[int, int], capacity: int,
              prefer: Optional[str] = None) -> List[_Request]:
        """Pop up to ``capacity`` same-shape requests FIFO, expiring
        stale deadlines (and reaping caller-cancelled futures) across
        the whole queue on the way. ``prefer`` (a priority class)
        takes that class's entries first, then fills FIFO — without
        it, a same-shape batch flood queued AHEAD of the interactive
        head would defeat the weighted dequeue pick (``_take`` is
        shape-keyed, and FIFO would hand the flood the whole
        micro-batch). ``prefer=None`` is byte-identical to the
        historical FIFO."""
        now = time.monotonic()
        with self._cv:
            live: List[_Request] = []
            for r in self._q:
                if r.future.cancelled():
                    self.metrics.record_cancelled()
                    self._trace_cancel(r)
                elif self._expire(r, now):
                    pass
                else:
                    live.append(r)
            same = [r for r in live if r.key == key]
            if prefer is not None:
                want_batch = prefer == PRIORITY_BATCH
                same = ([r for r in same
                         if (r.priority == PRIORITY_BATCH) == want_batch]
                        + [r for r in same
                           if (r.priority == PRIORITY_BATCH)
                           != want_batch])
            taken = same[:capacity]
            ids = set(map(id, taken))
            self._q = collections.deque(r for r in live
                                        if id(r) not in ids)
        return taken

    def _fail_requests(self, requests: List[_Request], exc: Exception
                      ) -> int:
        """Settle ``requests`` with ``exc``; returns how many actually
        settled (already-done futures — raced by a wedge verdict or a
        late-waking quarantined thread — are skipped, keeping
        submitted == completed + failed + deadline_missed + cancelled
        exact). Tracing armed: each settled request's span closes
        under the ``failed`` class (outcome = the exception type),
        and its linked dispatch span closes with it so a wedged batch
        never orphans its fan-in record; a raced CANCEL closes the
        span cancelled, any other racer owns the close itself."""
        n = 0
        tr = self.tracer
        for r in requests:
            if r.future.done():
                # an already-done future here was settled by a racer
                # who closed its span — EXCEPT a caller cancel, which
                # owns nothing: close it (idempotent) or the span
                # orphans
                if tr is not None and r.future.cancelled():
                    self._trace_cancel(r)
                continue
            if settle_future(r.future, exc):
                n += 1
                if tr is not None and r.span is not None:
                    tr.close(r.span, type(exc).__name__, "failed",
                             reason=str(exc)[:160])
            elif tr is not None and r.span is not None \
                    and r.future.cancelled():
                self._trace_cancel(r)
        if tr is not None:
            # close the batch's linked dispatch span once, whatever
            # mix of settles/races the loop saw — an all-cancelled
            # batch must not orphan its fan-in record (idempotent; a
            # completion racer's "ok" close wins if it got there
            # first)
            self._trace_close_dispatch(requests, "failed")
        return n

    def _await_pipeline_slot(self) -> None:
        """Block the dispatcher until the pipeline has room for another
        in-flight batch (bounded depth — backpressure against a slow
        completion stage), scanning queued deadlines and the completion
        watchdog while waiting so neither stalls behind the wait."""
        if self._completion is None:
            return
        with layer_span("sched.slot_wait"):
            while True:
                with self._pipe_lock:
                    n = len(self._pending_jobs)
                if n < self.pipeline_depth:
                    return
                self._expiry_scan()
                self._check_completions()
                time.sleep(0.001)

    def _select_locked(self) -> Tuple[Tuple[int, int], Optional[str]]:
        """Dispatch-head choice (caller holds ``_cv``, queue
        nonempty): ``(key, preferred class)``. One queued class —
        including the priority-less default — dispatches pure FIFO
        with no preference (bitwise the historical path). With BOTH
        interactive and batch work queued, weighted round-robin: the
        interactive head wins ``interactive_weight`` picks per batch
        pick, so a batch flood cannot starve interactive p99 while
        batch still drains at a bounded fraction (never starved
        either). Priority-less requests ride the interactive class —
        default traffic must not queue behind a bulk flood. The
        winning class is also the ``_take`` preference: its requests
        fill the micro-batch first, the other class's same-shape work
        may ride along in spare rows."""
        if not (self._seen_batch and self._seen_interactive):
            # only one class has EVER been submitted: mixing is
            # impossible, skip the scan — the priority-less hot path
            # stays the O(1) peek it always was
            return self._q[0].key, None
        first_int = first_bat = None
        for r in self._q:
            if r.priority == PRIORITY_BATCH:
                if first_bat is None:
                    first_bat = r
            elif first_int is None:
                first_int = r
            if first_int is not None and first_bat is not None:
                break
        if first_int is None or first_bat is None:
            return self._q[0].key, None
        self._rr += 1
        if self._rr % (self.interactive_weight + 1) == 0:
            return first_bat.key, PRIORITY_BATCH
        return first_int.key, PRIORITY_INTERACTIVE

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait(timeout=0.05)
                    if self._completion is not None:
                        break   # idle tick: run the completion watchdog
                key, prefer = (self._select_locked() if self._q
                               else (None, None))
                closed = self._closed
            if self._completion is not None:
                self._check_completions()
            if self.tracer is not None:
                # span records buffer under the leaf lock; the
                # dispatcher's tick is the serving-time flush point
                # (close() flushes the rest)
                self.tracer.flush()
            if key is None:
                if closed:
                    return
                continue
            self._await_pipeline_slot()
            br = self._breaker(key)
            if br is not None and br.state() == BREAKER_OPEN:
                # queued work behind an open breaker fails fast —
                # neither starving until deadline nor burning dispatch
                # slots other shapes could use
                doomed = self._take(key, self.max_queue or 1)
                n = self._fail_requests(doomed, CircuitOpen(
                    f"bucket {key} circuit open — failing fast"))
                self.metrics.record_failure(n)
                continue
            if self._exec is None:
                job = _DispatchJob(None)
                self._serve_key(key, job, prefer)
                self._after_dispatch(key, job)
            else:
                self._supervise(key, prefer)

    def _supervise(self, key: Tuple[int, int],
                   prefer: Optional[str] = None) -> None:
        """Run one supervised dispatch for ``key`` on the executor,
        scanning queued deadlines while it is in flight; wedge verdict
        past ``dispatch_timeout_s``."""
        timeout = self.dispatch_timeout_s
        job = self._exec.submit(
            lambda j, key=key, prefer=prefer:
            self._serve_key(key, j, prefer))
        self._inflight_since = time.monotonic()
        try:
            poll = min(0.02, timeout / 4)
            while not job.done.wait(poll):
                self._expiry_scan()
                if self._completion is not None:
                    self._check_completions()
                if time.monotonic() - self._inflight_since > timeout:
                    self._wedge_verdict(key, job)
                    return
            self._after_dispatch(key, job)
        finally:
            self._inflight_since = None
            self._refresh_state("dispatch settled")

    def _wedge_error(self, key: Tuple[int, int]) -> DispatchWedged:
        return DispatchWedged(
            f"dispatch for bucket {key[0]}x{key[1]} exceeded "
            f"dispatch_timeout_s={self.dispatch_timeout_s}: futures "
            "failed, thread quarantined, executable dropped — "
            "half-open probe will recompile")

    def _wedge_verdict(self, key: Tuple[int, int], job: _DispatchJob
                       ) -> None:
        """The watchdog's exit-class discipline, serving-side: fail the
        wedged batch, quarantine + replace the stuck thread (accounted,
        not hidden), drop the suspect executable, open the breaker."""
        timeout = self.dispatch_timeout_s
        job.abandoned = True  # a late-waking thread must abort, not
        #                       dispatch into (and recompile) a
        #                       dropped bucket
        self._inflight_since = None  # supervision is over: health is
        #                              degraded now, not wedged
        label = self._label(key)
        # verdict consequences land BEFORE the futures fail, so a
        # caller woken by its DispatchWedged observes consistent state
        # (executable dropped, breaker open, health degraded)
        if job.bucket is not None:
            # engine recovery: the executable that hung is suspect —
            # drop it from its kind's table (and the cached capacity
            # routed through it) so the half-open probe recompiles from
            # clean state
            self.engine.drop_bucket(job.bucket, kind=job.kind)
        self._capacity.pop(key, None)
        br = self._breaker(key)
        if br is not None:
            br.record_failure(wedged=True)
        alive = self._exec.quarantine_and_replace()
        self.metrics.record_quarantined(label, alive=alive)
        exc = self._wedge_error(key)
        # fail the taken batch; a wedge before _take (a hung compile in
        # the capacity probe) instead fails the shape's queued requests
        # — nothing may stay stranded behind a stuck thread
        batch = job.batch
        if batch is None:
            batch = self._take(key, self.max_queue or 1)
        n = self._fail_requests(batch, exc)
        self.metrics.record_wedge(label, failed=n, timeout_s=timeout)
        self._refresh_state(f"wedge verdict on {label}")

    def _check_completions(self) -> None:
        """Completion-stage watchdog (pipeline_depth > 1, watchdog
        armed): verdict the OLDEST pending completion past the
        deadline. Only the head — it is the job the completion worker
        is actually on (FIFO, single worker); trailing jobs age behind
        it and get their own verdicts on later ticks if the cascade is
        real."""
        if self.dispatch_timeout_s is None:
            return
        with self._pipe_lock:
            job = self._pending_jobs[0] if self._pending_jobs else None
        if job is not None and job.t_start is not None \
                and time.monotonic() - job.t_start \
                > self.dispatch_timeout_s:
            self._wedge_completion(job)

    def _wedge_completion(self, job: _DispatchJob) -> None:
        """Wedge verdict on a pipelined completion (device compute or
        D2H that never finishes): same consequences-before-futures-fail
        ordering as the dispatch-stage verdict, now spanning in-flight
        batches — drop the suspect executable, open the breaker,
        quarantine + replace the completion worker (re-queuing the
        completions parked BEHIND the stuck one so they can't strand),
        THEN fail the wedged batch."""
        key = job.key
        job.abandoned = True   # a late-waking fetch must not settle
        #                        results or record a breaker success
        label = self._label(key)
        if job.bucket is not None:
            # the executable that hung is the one of the job's kind —
            # indict it, not a sibling kind's program at the same shape
            self.engine.drop_bucket(job.bucket, kind=job.kind)
        self._capacity.pop(key, None)
        br = self._breaker(key)
        if br is not None:
            br.record_failure(wedged=True)
        # snapshot + worker swap + re-queue are one atom under
        # _pipe_lock, mirroring the handoff atom in _dispatch: no
        # completion can slip into the dying mailbox between the
        # trailing snapshot and the replacement spawn
        with self._pipe_lock:
            try:
                self._pending_jobs.remove(job)
            except ValueError:
                pass   # completion raced the verdict and finished
            trailing = list(self._pending_jobs)
            alive = self._completion.quarantine_and_replace()
            for t in trailing:
                # their mailbox entries died with the quarantined
                # worker's mailbox — re-queue on the replacement, in
                # order, with a fresh watchdog stamp (their queue-wait
                # behind the wedged head must not pre-spend their own
                # deadline)
                t.t_start = time.monotonic()
                self._completion.enqueue(t)
        self._prev_pending = None   # the wedged fetch never completes:
        #                             don't pin its buffers (or feed
        #                             its t_ready to the gap clock)
        self.metrics.record_quarantined(label, alive=alive)
        exc = self._wedge_error(key)
        n = self._fail_requests(list(job.batch or ()), exc)
        self.metrics.record_wedge(label, failed=n,
                                  timeout_s=self.dispatch_timeout_s)
        self._refresh_state(f"completion wedge on {label}")

    # -- fleet dispatch loop (replicas > 1) --------------------------------

    def _run_fleet(self) -> None:
        """The fleet dispatcher: ONE thread owns every lane's executor
        (submit/quarantine/close — the DispatchExecutor single-
        supervisor contract, N times over), fanning coalesced
        micro-batches across the least-loaded free replica while
        reaping finished lanes, wedging overdue ones, and scaling the
        active set against queue depth. Concurrency comes from the
        lanes: while replica k's executor runs a dispatch, this loop
        is already picking a lane for the next key."""
        while True:
            with self._cv:
                if not self._q and not self._closed \
                        and not self._busy_lanes():
                    self._cv.wait(timeout=0.05)
                key, prefer = (self._select_locked() if self._q
                               else (None, None))
                closed = self._closed
            self._reap_lanes()
            if self.host_fleet is not None:
                self._host_notices()
            self._expiry_scan()
            if self.tracer is not None:
                self.tracer.flush()
            if key is None:
                if closed and not self._busy_lanes():
                    return
                if self._busy_lanes():
                    time.sleep(0.0005)
                self._retire_idle()
                continue
            with self._cv:
                swapping = self._swapping
                self._mutating = not swapping
            if swapping:
                # fleet-atomic weight swap in progress: reap (above),
                # grow and launch nothing — the epoch needs quiesced
                # lanes, and all of them listed
                time.sleep(0.0005)
                continue
            try:
                self._fleet_step(key, prefer)
            finally:
                with self._cv:
                    self._mutating = False
                    self._cv.notify_all()

    def _fleet_step(self, key, prefer: Optional[str]) -> None:
        """Scale, pick a lane for ``key`` and launch on it, or settle
        the key's queue when no lane can ever take it (the dispatcher
        holds ``_mutating`` across the call)."""
        self._scale_fleet()
        lane = self._pick_lane(key)
        if lane is None:
            if self._fleet_all_open(key):
                # the shape is open on every active replica:
                # queued work fails fast, exactly the single-board
                # open-breaker discipline
                doomed = self._take(key, self.max_queue or 1)
                n = self._fail_requests(doomed, CircuitOpen(
                    f"bucket {key} circuit open on every active "
                    "replica — failing fast"))
                self.metrics.record_failure(n)
            elif not any(ln.active for ln in self._lanes) \
                    and len(self.placement.engines) \
                    >= self.placement.ceiling:
                # every replica quarantined and no headroom to
                # grow: nothing can ever serve this — fail rather
                # than strand
                doomed = self._take(key, self.max_queue or 1)
                n = self._fail_requests(doomed,
                                        self._wedge_error(key))
                self.metrics.record_failure(n)
            else:
                # lanes busy (or probing backoff): wait a beat,
                # reap on the next tick
                time.sleep(0.0005)
            return
        self._launch(lane, key, prefer)

    def _busy_lanes(self) -> int:
        return sum(1 for lane in self._lanes if lane.job is not None)

    def _reap_lanes(self) -> None:
        """Collect finished lane jobs: outcome bookkeeping (breaker
        success/failure on the LANE's board) and lane release."""
        for lane in self._lanes:
            job = lane.job
            if job is not None and job.done.is_set():
                lane.job = None
                lane.idle_since = time.monotonic()
                self._after_dispatch(job.key, job, lane)
        self._fleet_watchdog()

    def _fleet_watchdog(self) -> None:
        """Wedge verdict for any lane past ``dispatch_timeout_s`` —
        the per-lane analogue of ``_supervise``'s inline deadline."""
        if self.dispatch_timeout_s is None:
            return
        now = time.monotonic()
        for lane in self._lanes:
            job = lane.job
            if (job is not None and not job.done.is_set()
                    and now - lane.t_launch > self.dispatch_timeout_s):
                self._wedge_replica(lane, job)

    def _pick_lane(self, key) -> Optional[_ReplicaLane]:
        """Least-loaded FREE lane for ``key`` — or the primary alone
        when placement says the bucket shards (a sharded program only
        exists on the mesh-armed engine). Skips lanes whose breaker
        for the shape is open (their backoff expiry promotes to
        half_open, which re-admits the lane as the probe). None:
        nothing can take the key right now."""
        lanes = (self._lanes[:1]
                 if self.placement.decide(key) == "shard"
                 else self._lanes)
        best = None
        for lane in lanes:
            if not lane.active or lane.job is not None:
                continue
            br = lane.breakers.get(key)
            if br is not None and br.state() == BREAKER_OPEN:
                continue
            if best is None or lane.dispatches < best.dispatches:
                best = lane
        return best

    def _fleet_all_open(self, key) -> bool:
        if not self._breaker_failures:
            return False
        lanes = [lane for lane in self._lanes if lane.active]
        if not lanes:
            return False
        for lane in lanes:
            br = lane.breakers.get(key)
            if br is None or br.state() != BREAKER_OPEN:
                return False
        return True

    def _launch(self, lane: _ReplicaLane, key,
                prefer: Optional[str]) -> None:
        """Hand one micro-batch dispatch for ``key`` to ``lane``'s
        executor; the loop reaps it later (the lane stays busy until
        then)."""
        lane.dispatches += 1
        lane.idle_since = None
        lane.t_launch = time.monotonic()
        job = lane.exec.submit(
            lambda j, key=key, prefer=prefer, lane=lane:
            self._serve_key(key, j, prefer, lane=lane))
        job.key = key
        lane.job = job
        busy = self._busy_lanes()
        if busy > self._concurrency_max:
            self._concurrency_max = busy

    def _wedge_replica(self, lane: _ReplicaLane,
                       job: _DispatchJob) -> None:
        """Wedge verdict scoped to ONE replica: consequences first —
        abandon the job, drop the suspect program from the LANE's
        engine (its siblings' tables are untouched), open the lane's
        breaker, quarantine the lane's worker and RETIRE the lane —
        then fail the taken batch's futures. The queue survives: work
        the wedged lane never took keeps serving on the remaining
        replicas. The quarantined thread holds no scheduler lock and
        the engine holds none across its capture site, so nothing
        another lane needs waits on it; its stream is abandoned with
        it (a hung graph cannot be killed)."""
        key = job.key
        job.abandoned = True   # a late-waking thread must abort, not
        #                        dispatch into a dropped bucket
        lane.job = None
        label = self._label(key, lane)
        if job.bucket is not None:
            # best-effort on a remote lane: the drop travels the wire, and
            # a wedged host is exactly the kind whose transport may raise
            # (the dispatcher must survive; the lane is retired below
            # either way, and a stale remote bucket dies with its worker)
            try:
                lane.engine.drop_bucket(job.bucket, kind=job.kind)
            except Exception:
                if lane.host is None:
                    raise
        self._capacity.pop((key, lane.index), None)
        br = self._breaker(key, lane)
        if br is not None:
            br.record_failure(wedged=True)
        alive = lane.exec.quarantine_and_replace()
        lane.prev_pending = None
        lane.active = False
        lane.quarantined = True
        if lane.index > 0 and lane.host is None:
            # a quarantined replica never serves again: an engine that
            # leads follower ranks ends their copies (a no-op otherwise;
            # the primary stays, as the spawn source of later replicas)
            close = getattr(lane.engine, "close", None)
            if close is not None:
                close()
        self.metrics.record_quarantined(label, alive=alive)
        self.metrics.record_event(
            "replica_quarantined", replica=lane.index,
            bucket=self._key_label(key))
        exc = self._wedge_error(key)
        # fail ONLY what the wedged lane actually took — a pre-take
        # wedge (hung capacity probe) leaves the shape's queued work
        # for the surviving replicas
        n = self._fail_requests(list(job.batch or ()), exc)
        self.metrics.record_wedge(label, failed=n,
                                  timeout_s=self.dispatch_timeout_s)
        self._refresh_state(f"replica wedge on {label}")

    def _host_notices(self) -> None:
        """Drain the host fleet's liveness verdicts on the dispatcher
        tick: the ONE thread that owns the lanes applies every
        consequence (the heartbeat monitor only queues)."""
        for kind, name in self.host_fleet.pop_notices():
            lane = next((ln for ln in self._lanes if ln.host == name),
                        None)
            if lane is None:
                continue
            if kind == "dead":
                self._wedge_host(lane)
            elif kind == "rejoined":
                # the full re-admission already happened (programs
                # re-pushed and verified, prewarm counters read): the
                # lane serves again, with a fresh breaker board and
                # capacity table, since the restarted worker shares
                # nothing with its dead predecessor
                lane.breakers = {}
                for ck in [ck for ck in self._capacity
                           if ck[1] == lane.index]:
                    self._capacity.pop(ck, None)
                lane.quarantined = False
                lane.active = True
                lane.idle_since = time.monotonic()
                self.placement.mark_host(name, "healthy")
                self._refresh_state(f"host {name} rejoined")

    def _wedge_host(self, lane: _ReplicaLane) -> None:
        """Dead-host verdict: the remote analogue of
        :meth:`_wedge_replica`, with FAILOVER instead of failure.
        Consequences first: abandon the in-flight job, clear the lane's
        capacity entries, open its breaker, quarantine its executor, mark
        the placement layer, poison the transport (which unsticks a lane
        thread blocked in the zombie's recv); THEN the in-flight batch
        fails over: its unsettled requests requeue for the surviving
        lanes (idempotent per request: a future stays RUNNING and settles
        exactly once wherever it lands, and a late answer from the zombie
        is dropped by the ``job.abandoned`` check and ``settle_future``'s
        raced hook). Only when NO lane can ever serve again does the
        batch fail, with :class:`~raft_tpu_torch.serving.hosts.HostDead`."""
        name = lane.host
        job = lane.job
        requeue: List[_Request] = []
        if job is not None:
            job.abandoned = True   # a late-waking lane thread must drop
            #                        its answer, never settle
            lane.job = None
            requeue = [r for r in (job.batch or ())
                       if not r.future.done()]
            job.batch = []   # reaped nowhere: nothing may re-fail these
            br = self._breaker(job.key, lane)
            if br is not None:
                br.record_failure(wedged=True)
        for ck in [ck for ck in self._capacity if ck[1] == lane.index]:
            self._capacity.pop(ck, None)
        alive = lane.exec.quarantine_and_replace()
        lane.prev_pending = None
        lane.active = False
        lane.quarantined = True
        self.placement.mark_host(name, "dead")
        self.host_fleet.poison(name)
        self.metrics.record_quarantined(f"host:{name}", alive=alive)
        self.metrics.record_event(
            "replica_quarantined", replica=lane.index,
            bucket=f"host:{name}")
        survivors = any(ln.active for ln in self._lanes)
        if requeue and not survivors \
                and len(self.placement.engines) >= self.placement.ceiling:
            # nothing left to fail over TO and no headroom to grow: fail
            # rather than strand (every consequence above has landed)
            n = self._fail_requests(requeue, HostDead(
                f"host {name} verdicted dead with no surviving lane — "
                "in-flight work cannot fail over"))
            self.metrics.record_failure(n)
            requeue = []
        n = self._failover_requeue(lane, requeue)
        self.metrics.record_event("failover", host=name,
                                  replica=lane.index, requeued=n)
        self.host_fleet.record_failover(name, requeued=n)
        self._refresh_state(f"host {name} dead")

    def _failover_requeue(self, lane: _ReplicaLane,
                          requests: List[_Request]) -> int:
        """Put a dead host lane's in-flight requests back at the head of
        the shared queue for the surviving lanes. Idempotent: a request
        already settled, or already requeued by the other side of the
        verdict race, is skipped, so each settles exactly once. No
        accounting changes here: the requests never left ``submitted``
        and are counted by whatever finally settles them."""
        n = 0
        with self._cv:
            for r in reversed(requests):
                if r.future.done() or r in self._q:
                    continue
                self._q.appendleft(r)
                n += 1
            if n:
                self._cv.notify_all()
        return n

    def _scale_fleet(self) -> None:
        """Queue-pressure scale-up within the ceiling: reactivate a
        retired (non-quarantined) lane first, else grow a fresh
        replica through the placement layer (its captures happen
        here, on the dispatcher thread, one at a time in the
        process)."""
        with self._cv:
            depth = len(self._q)
        if not depth:
            return
        active = sum(1 for lane in self._lanes if lane.active)
        if active and not self.placement.want_scale_up(
                depth, active, self.max_batch):
            return
        if active >= self.placement.ceiling:
            return
        for lane in self._lanes:
            # host lanes only (re)activate through the fleet's rejoin
            # protocol (programs verified and prewarmed), never by
            # queue-pressure policy
            if not lane.active and not lane.quarantined \
                    and lane.host is None:
                lane.active = True
                lane.idle_since = time.monotonic()
                self.metrics.record_event(
                    "replica_activated", replica=lane.index,
                    queue_depth=depth)
                return
        if len(self.placement.engines) >= self.placement.ceiling:
            return   # only quarantined lanes left below the ceiling
        try:
            eng = self.placement.grow()
        except Exception as exc:  # noqa: BLE001 — scale-up is advisory
            self.metrics.record_event("replica_grow_failed",
                                      error=str(exc)[:160])
            return
        lane = _ReplicaLane(len(self._lanes), eng)
        self._lanes.append(lane)
        self.metrics.record_event("replica_activated",
                                  replica=lane.index, queue_depth=depth,
                                  grown=True)

    def _retire_idle(self) -> None:
        """Idle-time scale-down back toward the configured floor
        (never the primary — shard-pinned buckets only run there)."""
        now = time.monotonic()
        active = sum(1 for lane in self._lanes if lane.active)
        for lane in reversed(self._lanes):
            if (lane.index > 0 and lane.host is None and lane.active
                    and lane.job is None
                    and lane.idle_since is not None
                    and self.placement.want_retire(
                        now - lane.idle_since, active,
                        self.replica_idle_retire_s)):
                lane.active = False
                active -= 1
                self.metrics.record_event(
                    "replica_retired", replica=lane.index,
                    idle_s=round(now - lane.idle_since, 3))

    def _after_dispatch(self, key: Tuple[int, int], job: _DispatchJob,
                        lane: Optional[_ReplicaLane] = None) -> None:
        """Outcome bookkeeping for a dispatch that settled in time
        (``lane``: the fleet lane that ran it — its board takes the
        breaker outcome)."""
        if job.error is not None and job.batch:
            # a failure that escaped _serve_key's routing (e.g. the
            # serve.dispatch_exec fault firing mid-job) with requests
            # already taken: settle them here — never strand
            n = self._fail_requests(list(job.batch), job.error)
            self.metrics.record_failure(n)
        br = self._breaker(key, lane)
        if job.error is not None or job.outcome == "failed":
            if br is not None:
                br.record_failure()
        elif job.outcome == "ok":
            self._last_dispatch_done = time.monotonic()
            if br is not None:
                br.record_success()
        # "dispatched": handed off to the completion stage — it owns
        # the breaker outcome (success must mean RESULTS, not enqueue)
        self._refresh_state("dispatch outcome")

    def _serve_key(self, key: Tuple[int, int], job: _DispatchJob,
                   prefer: Optional[str] = None,
                   lane: Optional[_ReplicaLane] = None) -> None:
        """One micro-batch for ``key``: capacity (may capture) ->
        gather -> take (``prefer``'s class first) -> dispatch. Runs
        inline on the dispatcher thread (no watchdog), on the
        supervised executor, or — fleet mode — on ``lane``'s executor
        against ``lane``'s engine."""
        with layer_span("sched.gather"):
            try:
                # capacity may capture a bucket — never under the queue
                # lock (submitters would shed through the whole capture)
                capacity = self._shape_capacity(key, lane)
            except Exception as exc:
                if (lane is not None and lane.host is not None
                        and isinstance(exc, TransportError)):
                    # the probe died with the HOST, not the shape: take
                    # nothing — the queued work stays for the surviving
                    # lanes, the lane breaker records the failure (through
                    # _after_dispatch) and the heartbeat verdict owns the
                    # quarantine and the failover
                    job.error = exc
                    job.outcome = "failed"
                    return
                # an unservable shape (a capture failure) fails ITS
                # requests — it must not kill the dispatcher and strand
                # every queued future unsettled behind a dead thread
                doomed = self._take(key, self.max_batch)
                job.batch = doomed
                self.metrics.record_failure(self._fail_requests(doomed, exc))
                job.outcome = "failed"
                return
            if job.abandoned:
                # the capacity probe (a capture) outlived the watchdog: a
                # quarantined thread must not take fresh work — but its
                # capture was NOT wasted (first-insert-wins means the
                # replacement's probe finds the bucket ready)
                return
            self._gather(key, capacity)
            batch = self._take(key, capacity, prefer)
        job.batch = batch
        if job.abandoned:
            # verdict landed between the check above and the take: the
            # verdict saw batch=None, so disposing of these is OUR job
            self._dispose_abandoned(key, batch, lane)
            return
        if batch:
            with layer_span("sched.assemble") as assemble:
                self._dispatch(key, batch, job, lane, assemble)

    def _dispose_abandoned(self, key, live: List[_Request],
                        lane: Optional[_ReplicaLane] = None) -> None:
        """Dispose of requests a thread holds after a verdict abandoned
        its job (it may have seen none of them): a host lane's go back to
        the queue for the survivors (a DEAD-HOST failover), any other's
        fail as the wedged batch did. Nothing is stranded."""
        if lane is not None and lane.host is not None:
            self._failover_requeue(lane, live)
        else:
            self.metrics.record_failure(self._fail_requests(
                live, self._wedge_error(key)))

    def _assemble_flow_init(self, live: List[_Request], h: int, w: int):
        """The micro-batch's coalesced warm start, or None when every
        row is cold. Host rows build an np batch (zero rows ARE cold
        starts); if any row is device-resident the batch assembles ON
        THE DEVICE (row copies into device zeros, on the caller's
        stream — the engine's stream waits for it) so session state
        never round-trips through host memory."""
        if not any(r.flow_init is not None for r in live):
            return None
        n = len(live)
        left, right, top, bottom = pad_amounts(h, w)
        lh = (h + top + bottom) // 8
        lw = (w + left + right) // 8
        dev = next((r.flow_init.device for r in live
                    if isinstance(r.flow_init, torch.Tensor)), None)
        if dev is not None:
            finit = torch.zeros((n, lh, lw, 2), dtype=torch.float32,
                                device=dev)
            for i, r in enumerate(live):
                if r.flow_init is not None:
                    finit[i].copy_(torch.as_tensor(r.flow_init))
            return finit
        finit = np.zeros((n, lh, lw, 2), np.float32)
        for i, r in enumerate(live):
            if r.flow_init is not None:
                finit[i] = r.flow_init
        return finit

    def _settle(self, live: List[_Request], outs, label: str,
                t_disp: float, row, replica: Optional[int] = None,
                host: Optional[str] = None) -> None:
        """Resolve a finished micro-batch's futures + per-request
        latency records (inline at depth 1, on the completion worker
        at depth > 1). ``row(outs, i, r)``: request ``r``'s
        :class:`ServeResult`, row ``i`` of ``outs`` (a cached row stores
        its pool slot first); ``replica`` stamps fleet completions into
        the per-replica metrics block; ``host`` set means a lost settle
        race is a ZOMBIE answer — the request already failed over and
        settled elsewhere — counted as a drop, never settled twice."""
        with layer_span("sched.settle") as settle:
            raced = (None if host is None
                     else lambda: self.metrics.record_host_zombie_drop(host))
            t_done = time.monotonic()
            for i, r in enumerate(live):
                if not settle_future(r.future, row(outs, i, r), raced):
                    # wedge verdict settled it first (and owns the span
                    # close); a raced caller cancel owns nothing — close
                    # the span cancelled (idempotent either way)
                    if r.future.cancelled():
                        self._trace_cancel(r)
                    continue
                settle.add("sched.request", r.t_submit, t_done,
                           taken=t_disp)
                queue_ms = (t_disp - r.t_submit) * 1e3
                device_ms = (t_done - t_disp) * 1e3
                tail = self.metrics.record_complete(
                    label, queue_ms=queue_ms, device_ms=device_ms,
                    priority=r.priority,
                    trace_id=(r.span.trace_id if r.span is not None
                              else None),
                    replica=replica)
                if self.tracer is not None and r.span is not None:
                    # observed_ms: the exact value the latency histogram
                    # binned — serve_trace's top-bucket selection must
                    # reproduce the histogram's membership, not re-derive
                    # it from the span's own (ms-skewed) close clock
                    self.tracer.close(
                        r.span, "completed", "completed", tail=tail,
                        observed_ms=round(queue_ms + device_ms, 3))
            self._trace_close_dispatch(live, "ok")

    @staticmethod
    def _flow_row(outs, i: int, r: _Request, warm: bool) -> ServeResult:
        """A plain or ragged row's result: its flow and, when asked for,
        its ``flow_low`` (host numpy unless ``low_device``)."""
        flows, lows = outs if warm else (outs, None)
        low = lows[i] if lows is not None and r.want_low else None
        if isinstance(low, torch.Tensor) and not r.low_device:
            low = low.cpu().numpy()
        return ServeResult(flows[i], low)

    def _cached_row(self, outs, i: int, r: _Request, h: int, w: int,
                    ver: int) -> ServeResult:
        """A cached row's result, after its pool slot is stored (fmap +
        context + flow_low, sliced from the full-bucket device outputs):
        a session harvesting the future must find the slot present. A
        prime row stores a flow-less slot and resolves to
        ``ServeResult(None, None)`` (refinement against zero features)."""
        flow, low_full, fmap2, ctx2 = outs
        left, right, top, bottom = pad_amounts(h, w)
        lh = (h + top + bottom) // 8
        lw = (w + left + right) // 8
        # each slot holds CLONES of its own row: a view would pin the
        # whole batch output (about 58 MB at batch 4, 440x1024, basic
        # model) for as long as the slot lives, and eviction would free
        # nothing
        fl = None if r.prime else low_full[i, :lh, :lw].clone()
        self._fcache.store(r.stream, (h, w), r.seq, ver,
                           fmap2[i, :lh, :lw].clone(),
                           ctx2[i, :lh, :lw].clone(), fl)
        return ServeResult(None if r.prime else flow[i], None)

    def _run_completion(self, key, live: List[_Request], pending,
                        job: _DispatchJob, settle) -> None:
        """Completion-stage skeleton (pipeline_depth > 1), shared by
        every kind of program: the blocking fetch + settle off the
        dispatch path, on the completion executor's worker.
        ``settle(outs)`` is the dispatch's own step. A verdicted
        (abandoned) job settles nothing and records no breaker
        outcome."""
        # the watchdog clock restarts when the worker actually BEGINS
        # this job: queue-wait behind a slow-but-legal predecessor must
        # not count against dispatch_timeout_s, or steady traffic at
        # fetch_time > timeout/depth wedges healthy batches. The stuck
        # cases still age correctly: a hang in the executor loop's own
        # fault site (before fn) leaves the handoff stamp running, and
        # a hang in fetch ages from here.
        job.t_start = time.monotonic()
        if self.tracer is not None:
            # the pending carries its batch's span context (set at
            # dispatch): stamp the device-fetch phase edge from the
            # completion worker that actually blocks on it
            ctx = getattr(pending, "span_ctx", None)
            if ctx:
                t = time.monotonic()
                for s in ctx:
                    if s is not None:
                        self.tracer.mark(s, "fetch_start", at=t)
        try:
            try:
                outs = pending.fetch()
            except Exception as exc:
                if job.abandoned:
                    return
                self.metrics.record_failure(
                    self._fail_requests(live, exc))
                job.outcome = "failed"
                br = self._breaker(key)
                if br is not None:
                    br.record_failure()
                self._refresh_state("completion failed")
                return
            if job.abandoned:
                # verdict landed between the fetch returning and here:
                # the verdict already failed these futures — this
                # safety-net settle covers the race where it saw an
                # empty batch (guards keep accounting exact)
                self._dispose_abandoned(key, live)
                return
            settle(outs)
            job.outcome = "ok"
            self._last_dispatch_done = time.monotonic()
            br = self._breaker(key)
            if br is not None:
                br.record_success()
            self._refresh_state("completion outcome")
        finally:
            with self._pipe_lock:
                try:
                    self._pending_jobs.remove(job)
                except ValueError:
                    pass   # a wedge verdict removed it already
            if self.tracer is not None:
                self.tracer.flush()   # after the lock: I/O stays
                #                       lock-free (T1)

    def _claim(self, batch: List[_Request]) -> List[_Request]:
        """Pin each taken request RUNNING (once that returns True the
        future can no longer be cancelled: a dispatched request is
        never abandoned — the invariant behind
        ``metrics.abandoned_inflight == 0``); returns the live ones.
        A future a wedge verdict settled between take and here is
        skipped; a caller-cancelled one is counted and its span closed;
        one already RUNNING is a failed-over request whose first dispatch
        died with its host, and is dispatched again."""
        live: List[_Request] = []
        for r in batch:
            if r.future.running():
                # already RUNNING: re-dispatch is idempotent (the future
                # settles exactly once, and it can no longer be
                # cancelled, as at its first dispatch)
                live.append(r)
                continue
            try:
                running = r.future.set_running_or_notify_cancel()
            except (InvalidStateError, RuntimeError):
                # stdlib futures raise bare RuntimeError here for any
                # non-PENDING state: a wedge verdict settled it
                continue
            if running:
                live.append(r)
            else:
                self.metrics.record_cancelled()
                self._trace_cancel(r)
        return live

    def _hot_path(self, prev, overlapped: bool, t_asm0: float, pending,
                  live, lane: Optional[_ReplicaLane] = None) -> None:
        """Hot-path sample after a dispatch call returned: gap =
        host-observed device idle before this dispatch (0 when it
        shipped before the previous batch's results were even ready —
        perfect overlap), the assembly time and whether it began while
        the previous batch was in flight, and the H2D bytes."""
        t_call_end = time.monotonic()
        gap_ms = None
        if prev is not None:
            # the previous outputs' completion on the device, before their
            # copies out (a pending without that stamp: its hand-over)
            t_known = getattr(prev, "t_synced", prev.t_ready)
            gap_ms = (0.0 if t_known is None
                      else max(0.0, (t_call_end - t_known) * 1e3))
        self.metrics.record_hot_path(
            gap_ms=gap_ms, assembly_ms=(t_call_end - t_asm0) * 1e3,
            overlapped=overlapped, h2d_bytes=pending.h2d_bytes,
            requests=len(live))
        self._trace_mark(live, "shipped", at=t_call_end)
        self._trace_span_ctx(pending, live)
        if lane is not None:
            lane.prev_pending = pending
        else:
            self._prev_pending = pending

    def _hand_off(self, key, job: _DispatchJob, live: List[_Request],
                  pending, settle) -> None:
        """After the dispatch call: fetch and ``settle(outs)`` inline at
        depth 1, else hand the blocking fetch + settle to the
        completion worker (:meth:`_run_completion`). A wedge verdict
        that landed while the engine call was out (a hung capture that
        eventually returned) already failed these futures, dropped the
        bucket and opened the breaker — handing off now would record a
        completion SUCCESS that closes the breaker the verdict just
        opened: settle any stragglers and stop."""
        if job.abandoned:
            self._dispose_abandoned(key, live)
            return
        if self._completion is None:
            self._trace_mark(live, "fetch_start")
            settle(pending.fetch())
            job.outcome = "ok"
            return
        cjob = _DispatchJob(
            lambda j: self._run_completion(key, live, pending, j, settle))
        cjob.key = key
        cjob.bucket = job.bucket
        cjob.kind = job.kind
        cjob.batch = live
        cjob.t_start = time.monotonic()
        # append + mailbox enqueue are one atom under _pipe_lock: a
        # concurrent completion-wedge verdict swaps the mailbox under
        # the same lock, so a handoff lands either fully before the
        # swap (re-queued with the trailing jobs) or fully after
        # (queued on the replacement) — never into the dead mailbox
        with self._pipe_lock:
            self._pending_jobs.append(cjob)
            self._completion.enqueue(cjob)
        job.outcome = "dispatched"   # the breaker verdict belongs to
        #                              the completion stage now

    def _dispatch(self, key, batch: List[_Request], job: _DispatchJob,
                  lane: Optional[_ReplicaLane] = None,
                  assemble=UNARMED) -> None:
        """One micro-batch of one coalescing key through the engine's (or
        ``lane``'s) program of the key's kind: one protocol for all three
        kinds, each supplying its route, record fields, assembly and row
        settle. ``assemble``: the open ``sched.assemble`` span, which
        ends where ``sched.ship`` (the engine call) begins."""
        eng = lane.engine if lane is not None else self.engine
        replica = lane.index if lane is not None else None
        host = lane.host if lane is not None else None
        live = self._claim(batch)
        if not live:
            return
        job.batch = live
        h, w, kind = self._key_parts(key)
        t_disp = time.monotonic()
        try:  # EVERYTHING here routes failures to the batch's futures —
            # nothing may escape and kill the dispatcher thread
            bucket = eng.route_bucket(len(live), h, w, kind=kind)
            job.bucket, job.kind = bucket, kind
            label = "x".join(map(str, bucket)) + self.KIND_LABEL_SUFFIX[kind]
            if lane is not None:
                label = f"{label}/r{lane.index}"
            if kind == "cached":
                live, slots, ver = self._acquire_slots(live, h, w)
                if not live:
                    # nothing reached the engine: a miss is pool churn,
                    # not a program fault — no breaker outcome (a
                    # "failed" here would let cache churn open a healthy
                    # bucket's breaker), and no dispatch/occupancy record
                    # (nothing dispatched)
                    return
                job.batch = live
            with self._cv:
                depth = len(self._q)
            # padding-waste gauge: requested pixels vs the padded
            # pixels the program actually runs (batch fill + align
            # pad + bucket fill) — comparable across the kinds, shared
            # with the dispatch span
            real_px = sum(r.image2.shape[0] * r.image2.shape[1]
                          for r in live)
            padded_px = bucket[0] * bucket[1] * bucket[2]
            cross = (kind == "ragged"
                     and len({r.image2.shape for r in live}) > 1)
            self.metrics.record_dispatch(
                label, filled=len(live), capacity=bucket[0], depth=depth,
                real_px=real_px, padded_px=padded_px,
                ragged=kind == "ragged", cross_shape=cross, replica=replica)
            tags = {"plain": {}, "cached": {"cached": True},
                    "ragged": {"ragged": True, "cross_shape": cross}}[kind]
            if replica is not None:
                tags["replica"] = replica
            self._trace_dispatch(live, label, bucket, t_disp,
                                 real_px=real_px, padded_px=padded_px,
                                 **tags)
            fault_point("serve.request")
            if job.abandoned:
                # wedge verdict landed while we were stuck above:
                # routing into the engine now would capture a leaked
                # duplicate
                self._dispose_abandoned(key, live, lane)
                return
            warm = getattr(eng, "warm_start", False)
            # an engine without the async API (a host lane) is called
            # synchronously, settled inline: no pipelining, no gap stats
            sync = not hasattr(eng, "infer_batch_async")
            prev = (lane.prev_pending if lane is not None
                    else self._prev_pending)
            overlapped = prev is not None and prev.t_ready is None
            t_asm0 = time.monotonic()
            if kind == "cached":
                call = partial(eng.infer_cached_async,
                               np.stack([r.image2 for r in live]), slots,
                               expect_version=ver)
                row = partial(self._cached_row, h=h, w=w, ver=ver)
            else:
                call = self._flow_call(eng, kind, live, h, w, warm, sync)
                row = partial(self._flow_row, warm=warm)
            assemble.end()
            if sync:
                if lane is not None:
                    lane.prev_pending = None
                else:
                    self._prev_pending = None
                outs = call()
                if job.abandoned:
                    # a ZOMBIE answer: the dead-host verdict landed while
                    # the RPC was out and already failed over (or failed)
                    # this batch — drop the late result whole
                    if host is not None:
                        for _ in live:
                            self.metrics.record_host_zombie_drop(host)
                    return
                self._settle(live, outs, label, t_disp, row,
                             replica=replica, host=host)
                job.outcome = "ok"
                return
            with layer_span("sched.ship", getattr(eng, "device", None)):
                pending = call()
            self._hot_path(prev, overlapped, t_asm0, pending, live, lane)
            self._hand_off(
                key, job, live, pending,
                lambda outs: self._settle(live, outs, label, t_disp, row,
                                          replica=replica))
        except Exception as exc:  # route to the callers; worker survives
            if job.abandoned and host is not None:
                # the raise IS the dead-host verdict unsticking us
                # (poisoned transport): the verdict already owned the
                # batch (requeued or failed); settling here would
                # dispose twice of the futures it failed over
                job.outcome = "failed"
                return
            if host is not None and isinstance(exc, TransportError):
                # the transport died mid-dispatch BEFORE any heartbeat
                # verdict (a socket reset the instant the worker was
                # killed, an injected host.infer raise): fail over NOW —
                # requeue the live batch for the surviving lanes, keep
                # job.error so the lane breaker paces re-picks; the
                # missed-beat ladder delivers the quarantine verdict
                n = self._failover_requeue(lane, live)
                self.metrics.record_event(
                    "failover", host=host, replica=lane.index,
                    requeued=n)
                if self.host_fleet is not None:
                    self.host_fleet.record_failover(host, requeued=n)
                job.batch = []
                job.error = exc
                job.outcome = "failed"
                return
            self.metrics.record_failure(self._fail_requests(live, exc))
            job.outcome = "failed"

    def _flow_call(self, eng, kind: str, live: List[_Request], h: int,
                   w: int, warm: bool, sync: bool):
        """The plain or ragged kind's assembly; returns the engine call
        that ships it. Plain: the frames (and warm starts) stacked into
        one batch. Ragged: the rows as frame pairs, which the engine pads
        into the class box ``(h, w)`` the dispatch routed on — so the
        program that runs, and that a wedge verdict drops, is the one
        ``job.bucket`` names, never a sibling class."""
        kw = {}
        if warm:
            kw["return_low"] = True
            if not sync:
                kw["low_device"] = any(r.want_low and r.low_device
                                       for r in live)
        if kind == "ragged":
            if warm:
                kw["flow_inits"] = [r.flow_init for r in live]
            return partial(eng.infer_ragged_async,
                           [(r.image1, r.image2) for r in live],
                           box=(h, w), **kw)
        i1 = np.stack([r.image1 for r in live])
        i2 = np.stack([r.image2 for r in live])
        if warm:
            kw["flow_init"] = self._assemble_flow_init(live, h, w)
        return partial(eng.infer_batch if sync else eng.infer_batch_async,
                       i1, i2, **kw)

    def _acquire_slots(self, live: List[_Request], h: int, w: int):
        """The cached kind's rows: each returning row's pool slot
        (seq/geometry/weights-version exact), its ``flow_low`` warped into
        the row's ``flow_init`` on the device; prime rows take zeroed
        cache inputs. A slot evicted, flushed or swapped while queued
        fails its row HERE with ``FeatureCacheMiss`` (the cold-restart
        signal), and the rest serve. Returns the rows that reach the
        engine, their slots, and ``ver``: the stamp the engine re-checks
        under its lock (``StaleFeatureError`` on a raced swap)."""
        ver = getattr(self.engine, "weights_version", 0)
        slots = []
        kept: List[_Request] = []
        missed: List[_Request] = []
        for r in live:
            if r.prime:
                kept.append(r)
                slots.append(None)
                continue
            slot = self._fcache.acquire(r.stream, (h, w), r.seq - 1, ver)
            if slot is None:
                missed.append(r)
                continue
            # device-resident recurrence warm start: warp the slot's
            # flow_low on device (holes stay zero = locally cold; a
            # non-finite flow scatters nothing — the poisoned-pair guard
            # without a host sync)
            fi = (None if slot.flow_low is None
                  else forward_interpolate_device(slot.flow_low))
            kept.append(r)
            slots.append((slot.fmap, slot.ctx, fi))
        if self.tracer is not None:
            # feature-cache attribution: whether each row's slot actually
            # held at assembly (the p99 question "was the stream warm or
            # re-priming")
            for r in kept:
                if r.span is not None:
                    self.tracer.annotate(
                        r.span, cache="prime" if r.prime else "hit",
                        warm=not r.prime)
            for r in missed:
                if r.span is not None:
                    self.tracer.annotate(r.span, cache="miss")
        if missed:
            self.metrics.record_failure(self._fail_requests(
                missed, FeatureCacheMiss(
                    "cache slot invalidated while queued (evicted, "
                    "flushed, or weights swapped) — re-prime the stream")))
        return kept, slots, ver

    # -- lifecycle ---------------------------------------------------------

    def executable_count(self) -> int:
        """The engine's programs (captured graphs on the card); with a
        fleet, every lane's (each replica captures its own, so N
        replicas hold N times the single engine's count)."""
        if self._lanes:
            return sum(self._engine_executables(lane.engine)
                       for lane in self._lanes)
        return self._engine_executables(self.engine)

    @staticmethod
    def _engine_executables(engine) -> int:
        count = getattr(engine, "executable_count", None)
        if count is not None:
            # RAFTEngine: plain + cached + ragged tables
            return count()
        return len(engine._compiled)

    def write_metrics(self, path: Optional[str] = None) -> Dict:
        """Dump a metrics snapshot on demand (appends a jsonl line).
        With tracing armed the span buffer flushes first, so the
        snapshot's ``tail_exemplars`` refs resolve in spans.jsonl."""
        if self.tracer is not None:
            self.tracer.flush()
        return self.metrics.write_snapshot(
            executables=self.executable_count(), path=path)

    def close(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Stop intake; ``drain=True`` finishes everything queued
        first, ``drain=False`` fails pending work with
        :class:`SchedulerClosed`. Joins the worker and the supervised
        executor (leaked dispatch threads are a bug, not a shutdown
        mode; quarantined wedge threads are the accounted exception —
        daemon, reported in ``health()``) and writes a final metrics
        snapshot when a metrics path is configured. Idempotent."""
        with self._cv:
            first = not self._closed
            self._closed = True
            if not drain:
                n = 0
                exc = SchedulerClosed("dropped by no-drain close")
                while self._q:
                    r = self._q.popleft()
                    if r.future.done() or not settle_future(r.future,
                                                            exc):
                        # a queued future can only be done here by a
                        # caller cancel no sweep got to: count (and
                        # close the span as) the cancel it was — the
                        # identity must survive shutdown too
                        if r.future.cancelled():
                            self.metrics.record_cancelled()
                            self._trace_cancel(r)
                        continue
                    n += 1
                    if self.tracer is not None \
                            and r.span is not None:
                        self.tracer.close(r.span, "SchedulerClosed",
                                          "failed")
                self.metrics.record_failure(n)
            self._cv.notify_all()
        self._worker.join(timeout)
        if self._worker.is_alive():
            raise RuntimeError(
                f"scheduler worker failed to drain within {timeout}s")
        if self._exec is not None and not self._exec.close(timeout):
            raise RuntimeError(
                "supervised dispatch executor failed to stop within "
                f"{timeout}s")
        if self.host_fleet is not None:
            # stop the heartbeat monitor BEFORE closing the lanes: a
            # verdict with no dispatcher left to drain it would sit in
            # the notices forever
            self.host_fleet.close()
        for lane in self._lanes:
            # the fleet loop drained every lane before returning
            # (quarantined wedge threads stay the accounted daemon
            # exception, same as the single executor)
            if not lane.exec.close(timeout):
                raise RuntimeError(
                    f"replica r{lane.index} dispatch executor failed "
                    f"to stop within {timeout}s")
        if self._completion is not None:
            # handed-off batches are in-flight work: wait them out
            # (wedging any overdue one when the watchdog is armed —
            # the dispatcher that normally runs the scan is gone)
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._pipe_lock:
                    n = len(self._pending_jobs)
                if not n:
                    break
                self._check_completions()
                time.sleep(0.005)
            if not self._completion.close(
                    max(0.1, deadline - time.monotonic())):
                raise RuntimeError(
                    "completion stage failed to drain within "
                    f"{timeout}s")
        # an engine that leads follower ranks (parallel.follow; its
        # replicas lead on its channel): every lane has stopped, so the
        # channel closes and the followers return
        channel = getattr(self.engine, "channel", None)
        if channel is not None:
            channel.close()
        if first and self._fcache is not None:
            # retired variants keep their scheduler objects (frozen
            # snapshots) — the pool must not pin per-stream device
            # arrays past close
            self.flush_feature_cache("close")
        if self.tracer is not None:
            # every accepted span settled above (drain or fail):
            # spans.jsonl is complete once close returns
            self.tracer.flush()
        if first and self.metrics.path:
            self.metrics.write_snapshot(
                executables=self.executable_count())

    def __enter__(self) -> "MicroBatchScheduler":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)
