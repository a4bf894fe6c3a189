"""Serving observability: latency histograms, occupancy, shed counters;
port of ``raft_tpu/serving/metrics.py`` (the record keys are the JAX
package's, one for one, so one dashboard reads either package).

Built into the serving front-end, not bolted on: the scheduler records
every request's life (enqueue -> dispatch -> complete) here, and a
snapshot answers the operator questions a serving stack lives by — how
long are callers waiting and where (queue vs device), how full are the
compiled buckets actually running (batch occupancy vs the
one-request-per-dispatch baseline), how deep is the queue, and how much
work was shed or missed its deadline.

Snapshots append to ``metrics.jsonl`` in the trainer Logger's format
(one JSON object per line carrying a ``step`` key,
training/logger.py:96-103) so the same ``tail -f`` / ``jq`` tooling
reads training and serving records side by side. ``executables``
counts the engine's programs (captured CUDA graphs on the card).
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

#: the metrics lock is a LEAF — record_* calls arrive
#: from under the scheduler's queue lock (``_cv``), so taking any
#: other serving lock in here would invert the declared order. The
#: event appenders (record_event) deliberately do their file I/O with
#: NO lock held (no blocking I/O under a lock).
LOCK_ORDER = (("metrics.ServingMetrics._lock",),)

#: 1-2-5 log ladder, 0.1 ms .. 60 s — everything from a warm CPU
#: dispatch to a cold-compile stall lands inside it
_BOUNDS_MS: List[float] = [
    m * decade
    for decade in (0.1, 1.0, 10.0, 100.0, 1000.0, 10000.0)
    for m in (1, 2, 5)
] + [60000.0]


class LatencyHistogram:
    """Fixed log-ladder histogram. Percentile estimates report the
    matched bucket's upper bound — pessimistic but stable, and two
    histograms with the same ladder merge by adding counts."""

    __slots__ = ("bounds", "counts", "count", "total", "max")

    def __init__(self, bounds: Optional[List[float]] = None):
        self.bounds = list(_BOUNDS_MS if bounds is None else bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def bucket_idx(self, ms: float) -> int:
        """The ladder bucket :meth:`observe` bins ``ms`` into — the
        ONE binning definition (the tail-exemplar refs and
        serve_trace's top-bucket membership both reuse it, so they
        can never drift from the histogram they must reproduce)."""
        return bisect.bisect_left(self.bounds, ms)

    def observe(self, ms: float) -> None:
        self.counts[self.bucket_idx(ms)] += 1
        self.count += 1
        self.total += ms
        if ms > self.max:
            self.max = ms

    @classmethod
    def from_snapshot(cls, snap: Dict,
                      bounds: Optional[List[float]] = None
                      ) -> "LatencyHistogram":
        """Rebuild a histogram from a :meth:`snapshot` dict (the jsonl
        form) so post-hoc consumers can :meth:`merge` blocks without
        poking the internals. ``total`` is re-derived from the rounded
        ``mean_ms`` — percentiles are exact (counts are), the merged
        mean carries the snapshot's 3-decimal rounding."""
        h = cls(bounds)
        h.counts = list(snap["counts"])
        h.count = snap["count"]
        h.total = snap["mean_ms"] * snap["count"]
        h.max = snap["max_ms"]
        return h

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into this histogram (same ladder required) —
        how per-variant latency blocks aggregate into the per-priority
        summaries a multi-model drill reports."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket ladders")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        if other.max > self.max:
            self.max = other.max
        return self

    def quantile(self, q: float) -> float:
        if not self.count:
            return 0.0
        target = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max

    def snapshot(self) -> Dict:
        mean = self.total / self.count if self.count else 0.0
        return {"count": self.count, "mean_ms": round(mean, 3),
                "max_ms": round(self.max, 3),
                "p50_ms": self.quantile(0.5),
                "p99_ms": self.quantile(0.99),
                "counts": list(self.counts)}


#: per-request latency stages: enqueue->dispatch, dispatch->complete,
#: and their sum
_STAGES = ("queue", "device", "total")


class ServingMetrics:
    """Thread-safe counters + per-bucket histograms for the scheduler.

    ``path``: optional ``metrics.jsonl`` destination for
    :meth:`write_snapshot` (appended, Logger-style). Counter semantics:
    ``shed`` is work REJECTED at submit (queue full — backpressure),
    ``evicted`` is the subset of shed that was already QUEUED and gave
    its slot to a higher-priority arrival (shed-batch-first; those
    futures fail, so they also count ``failed`` — the accounting
    identity stays exact), ``admission_rejected`` is the subset of
    shed turned away by the registry-wide admission budget before this
    model's queue ever saw it, ``deadline_missed`` is work that expired
    while still queued, ``abandoned_inflight`` counts dispatched
    requests the scheduler gave up on — by design never incremented;
    the acceptance drill pins it at zero.

    ``namespace``: the model name this metrics block belongs to in a
    multi-model registry — stamped as ``"model"`` on every snapshot
    and event record so one metrics.jsonl serves N models and a
    dashboard can group by it. None (default) keeps the single-model
    record schema byte-identical.

    Per-priority blocks appear lazily: the first ``priority=`` seen
    creates that class's counters + latency histogram; priority-less
    traffic records nothing there (zero overhead, unchanged schema).
    """

    def __init__(self, path: Optional[str] = None,
                 namespace: Optional[str] = None):
        self.path = path
        self.namespace = namespace
        self._lock = threading.Lock()
        self._buckets: Dict[str, Dict] = {}
        self._latency = LatencyHistogram()       # all-bucket total
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.shed = 0
        self.evicted = 0
        self.admission_rejected = 0
        self.deadline_missed = 0
        self.cancelled = 0
        self._priority: Dict[str, Dict] = {}
        self.abandoned_inflight = 0
        self.dispatches = 0
        self.depth_last = 0
        self.depth_max = 0
        self._depth_sum = 0
        self._depth_samples = 0
        self._snapshots = 0
        # resilience surface (serving/resilience.py): wedge verdicts,
        # quarantined (leaked) dispatch threads, breaker activity
        self.wedged = 0
        self.quarantined_threads = 0
        self.circuit_rejected = 0
        self.breaker_transitions = {"open": 0, "half_open": 0,
                                    "closed": 0}
        # hot-path surface (zero-copy serving): dispatch-gap histogram
        # (host-observed device-idle bound between consecutive
        # dispatches — 0 when the next batch shipped before the
        # previous one's results were even ready), host-assembly vs
        # device-compute overlap, and the H2D wire-bytes counter the
        # u8 wire exists to shrink
        self._gap = LatencyHistogram()
        self.h2d_bytes = 0
        self.h2d_requests = 0
        self._assembly_ms = 0.0
        self._assembly_overlapped_ms = 0.0
        # padding-waste gauge (device pixels padded vs requested) on
        # EVERY dispatch path — bucketed, cached, ragged — so a ragged
        # A/B and the bucketed baseline report comparable waste
        self.real_px = 0
        self.padded_px = 0
        # ragged capacity-class surface: how full the boxes ran
        # (px-based — honest about capacity padding, not just row
        # counts) and how often a dispatch actually coalesced ACROSS
        # request shapes (the thing per-shape bucketing can never do)
        self.ragged_dispatches = 0
        self.ragged_cross_shape = 0
        self.ragged_real_px = 0
        self.ragged_padded_px = 0
        #: cross-frame feature cache (serving/feature_cache): when the
        #: scheduler arms a pool it points this at the pool's
        #: ``snapshot`` — every metrics snapshot then carries a
        #: ``feature_cache`` block (hits/misses/evictions/flushes/
        #: occupancy). Called with NO metrics lock held (the pool lock
        #: stays a leaf; see LOCK_ORDER). None = no block,
        #: the historical schema byte for byte.
        self.feature_cache_provider: Optional[Callable[[], Dict]] = None
        #: tail exemplars (request tracing, serving/trace.py): when
        #: ``record_complete`` carries a trace id, completions landing
        #: in the latency histogram's top occupied bucket are kept as
        #: exemplar REFS here (bounded), the snapshot grows a
        #: ``tail_exemplars`` block, and the guardian's evidence
        #: windows carry the refs. With tracing off no trace id ever
        #: arrives — the deque stays empty and the snapshot schema is
        #: byte-identical to the untraced stack.
        self._exemplars = collections.deque(maxlen=64)
        self._tail_max_idx = -1
        #: replica fleet (scheduler replicas>1): per-replica dispatch/
        #: occupancy/latency blocks, created lazily by the first
        #: ``replica=`` record. Single-engine serving never passes a
        #: replica, the dict stays empty, and the snapshot schema is
        #: byte-identical to the fleet-less stack.
        self._replicas: Dict[int, Dict] = {}
        #: multi-host fleet (scheduler host_fleet): per-host liveness/
        #: failover/artifact-push blocks, created lazily by the first
        #: ``record_host_*`` call. ``hosts=0`` records nothing — the
        #: dict stays empty and the snapshot schema is byte-identical
        #: to the single-host stack.
        self._hosts: Dict[str, Dict] = {}

    # -- recording --------------------------------------------------------

    def _bucket(self, key: str) -> Dict:
        b = self._buckets.get(key)
        if b is None:
            b = {"dispatches": 0, "filled": 0, "capacity": 0,
                 "real_px": 0, "padded_px": 0}
            for stage in _STAGES:
                b[stage] = LatencyHistogram()
            self._buckets[key] = b
        return b

    def _depth(self, depth: int) -> None:
        self.depth_last = depth
        self.depth_max = max(self.depth_max, depth)
        self._depth_sum += depth
        self._depth_samples += 1

    def _replica(self, replica: Optional[int]) -> Optional[Dict]:
        """The replica's fleet block, created on first use (caller
        holds the lock). None replica records nothing per-replica."""
        if replica is None:
            return None
        r = self._replicas.get(replica)
        if r is None:
            r = {"dispatches": 0, "filled": 0, "capacity": 0,
                 "completed": 0, "queue_depth_last": 0,
                 "latency": LatencyHistogram()}
            self._replicas[replica] = r
        return r

    def _host(self, name: str) -> Dict:
        """The host's fleet block, created on first use (caller holds
        the lock)."""
        h = self._hosts.get(name)
        if h is None:
            h = {"state": "healthy", "ready": False, "missed_beats": 0,
                 "failovers": 0, "requeued": 0, "zombie_drops": 0,
                 "push_entries": 0, "push_bytes": 0, "push_retries": 0,
                 "rejoins": 0}
            self._hosts[name] = h
        return h

    def record_host_state(self, name: str, state: str, *,
                          missed: int = 0, ready: bool = False) -> None:
        with self._lock:
            h = self._host(name)
            h["state"] = state
            h["missed_beats"] = int(missed)
            h["ready"] = bool(ready)

    def record_host_failover(self, name: str, *,
                             requeued: int = 0) -> None:
        with self._lock:
            h = self._host(name)
            h["failovers"] += 1
            h["requeued"] += int(requeued)

    def record_host_zombie_drop(self, name: str) -> None:
        """A late answer from a verdicted-dead host was dropped
        instead of settling an already-failed-over future."""
        with self._lock:
            self._host(name)["zombie_drops"] += 1

    def record_host_push(self, name: str, *, entries: int = 0,
                         bytes: int = 0, retries: int = 0) -> None:
        with self._lock:
            h = self._host(name)
            h["push_entries"] += int(entries)
            h["push_bytes"] += int(bytes)
            h["push_retries"] += int(retries)

    def record_host_rejoin(self, name: str) -> None:
        with self._lock:
            self._host(name)["rejoins"] += 1

    def _prio(self, priority: Optional[str]) -> Optional[Dict]:
        """The class's counter block, created on first use (caller
        holds the lock). None priority records nothing per-class."""
        if priority is None:
            return None
        p = self._priority.get(priority)
        if p is None:
            p = {"submitted": 0, "completed": 0, "shed": 0,
                 "deadline_missed": 0, "latency": LatencyHistogram()}
            self._priority[priority] = p
        return p

    def record_submit(self, depth: int,
                      priority: Optional[str] = None) -> None:
        with self._lock:
            self.submitted += 1
            self._depth(depth)
            p = self._prio(priority)
            if p is not None:
                p["submitted"] += 1

    def record_shed(self, priority: Optional[str] = None) -> None:
        with self._lock:
            self.shed += 1
            p = self._prio(priority)
            if p is not None:
                p["shed"] += 1

    def record_evicted(self, priority: Optional[str] = None) -> None:
        """A queued request gave its slot to a higher-priority arrival
        (shed-batch-first backpressure). Its future fails, so it counts
        both shed AND failed — submitted == completed + failed +
        deadline_missed + cancelled stays an identity."""
        with self._lock:
            self.shed += 1
            self.evicted += 1
            self.failed += 1
            p = self._prio(priority)
            if p is not None:
                p["shed"] += 1

    def record_admission_rejected(self, priority: Optional[str] = None
                                  ) -> None:
        """Rejected by the registry-wide admission budget BEFORE this
        model's queue (no future was created, so — like ``shed`` — it
        never enters the accounting identity). Counted as shed too:
        admission control is backpressure, one layer up."""
        with self._lock:
            self.admission_rejected += 1
            self.shed += 1
            p = self._prio(priority)
            if p is not None:
                p["shed"] += 1

    def record_deadline_miss(self, n: int = 1,
                             priority: Optional[str] = None) -> None:
        with self._lock:
            self.deadline_missed += n
            p = self._prio(priority)
            if p is not None:
                p["deadline_missed"] += n

    def record_cancelled(self, n: int = 1) -> None:
        with self._lock:
            self.cancelled += n

    def record_abandoned_inflight(self, n: int = 1) -> None:
        with self._lock:
            self.abandoned_inflight += n

    def record_dispatch(self, bucket: str, filled: int, capacity: int,
                        depth: int, real_px: int = 0,
                        padded_px: int = 0, ragged: bool = False,
                        cross_shape: bool = False,
                        replica: Optional[int] = None) -> None:
        """``real_px``/``padded_px``: requested pixels vs the
        executable's padded pixels for this dispatch (the padding-waste
        gauge; 0/0 from duck-typed callers keeps the historical
        records). ``ragged``: a capacity-class dispatch;
        ``cross_shape``: it coalesced more than one distinct request
        shape. ``replica``: the fleet lane that ran it — feeds the
        per-replica blocks (None = single-engine, no block)."""
        with self._lock:
            self.dispatches += 1
            b = self._bucket(bucket)
            b["dispatches"] += 1
            b["filled"] += filled
            b["capacity"] += capacity
            b["real_px"] += real_px
            b["padded_px"] += padded_px
            self.real_px += real_px
            self.padded_px += padded_px
            if ragged:
                self.ragged_dispatches += 1
                self.ragged_real_px += real_px
                self.ragged_padded_px += padded_px
                if cross_shape:
                    self.ragged_cross_shape += 1
            r = self._replica(replica)
            if r is not None:
                r["dispatches"] += 1
                r["filled"] += filled
                r["capacity"] += capacity
                r["queue_depth_last"] = depth
            self._depth(depth)

    def record_complete(self, bucket: str, queue_ms: float,
                        device_ms: float,
                        priority: Optional[str] = None,
                        trace_id: Optional[str] = None,
                        replica: Optional[int] = None) -> bool:
        """Record one completion. ``trace_id`` (request tracing
        armed): the completion is judged against the latency
        histogram's top occupied bucket — returns True when it IS a
        tail exemplar (the request landed in the top bucket, so its
        span must be retained whatever the sample rate says), and its
        ref lands in the snapshot's ``tail_exemplars`` block. Without
        a trace id (tracing off) the return is always False and
        nothing new is recorded — the historical behavior."""
        total = queue_ms + device_ms
        with self._lock:
            self.completed += 1
            b = self._bucket(bucket)
            b["queue"].observe(queue_ms)
            b["device"].observe(device_ms)
            b["total"].observe(total)
            self._latency.observe(total)
            p = self._prio(priority)
            if p is not None:
                p["completed"] += 1
                p["latency"].observe(total)
            r = self._replica(replica)
            if r is not None:
                r["completed"] += 1
                r["latency"].observe(total)
            if trace_id is None:
                return False
            idx = self._latency.bucket_idx(total)
            tail = idx >= self._tail_max_idx
            if idx > self._tail_max_idx:
                self._tail_max_idx = idx
            if tail:
                self._exemplars.append(
                    {"trace_id": trace_id, "bucket": bucket,
                     "total_ms": round(total, 3), "bucket_idx": idx})
            return tail

    def record_failure(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def record_hot_path(self, gap_ms: Optional[float] = None,
                        assembly_ms: float = 0.0,
                        overlapped: bool = False,
                        h2d_bytes: int = 0, requests: int = 0) -> None:
        """One dispatch's hot-path sample: ``gap_ms`` — host-observed
        idle between this dispatch and the previous one's results being
        ready (None for the first dispatch); ``assembly_ms`` — host
        stack/pad/ship time, ``overlapped=True`` when it ran while a
        previous batch was still in flight on the device;
        ``h2d_bytes``/``requests`` — wire bytes shipped for this
        micro-batch and how many requests rode them."""
        with self._lock:
            if gap_ms is not None:
                self._gap.observe(gap_ms)
            self._assembly_ms += assembly_ms
            if overlapped:
                self._assembly_overlapped_ms += assembly_ms
            self.h2d_bytes += h2d_bytes
            self.h2d_requests += requests

    # -- resilience events ------------------------------------------------

    def record_event(self, event: str, **fields) -> None:
        """Append one event record to metrics.jsonl — the supervisor's
        restart-event format (training/supervisor.py), so the dashboard
        tailing one file sees serving health transitions next to
        trainer restarts. No-op without a path; a failed append is
        logged and swallowed (observability must never take down
        serving)."""
        if self.path is None:
            return
        rec = {"event": event, "time": time.time(),
               "kind": "serving_event", **fields}
        if self.namespace is not None and "model" not in rec:
            rec["model"] = self.namespace
        try:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(rec) + "\n")
        except OSError as exc:
            print(f"[serving-metrics] event append failed ({exc}) — "
                  "continuing", file=sys.stderr, flush=True)

    def record_wedge(self, bucket: str, failed: int,
                     timeout_s: float) -> None:
        """A dispatch wedge verdict: ``failed`` futures were failed
        with DispatchWedged after ``timeout_s``."""
        with self._lock:
            self.wedged += 1
            self.failed += failed
        self.record_event("dispatch_wedged", bucket=bucket,
                          failed=failed, timeout_s=timeout_s)

    def record_quarantined(self, bucket: str, alive: int) -> None:
        """A stuck dispatch thread was quarantined and replaced;
        ``alive`` is how many quarantined threads still live — the
        leak, recorded rather than hidden."""
        with self._lock:
            self.quarantined_threads += 1
        self.record_event("thread_quarantined", bucket=bucket,
                          alive=alive)

    def record_breaker_transition(self, bucket: str, old: str,
                                  new: str) -> None:
        with self._lock:
            if new in self.breaker_transitions:
                self.breaker_transitions[new] += 1
        self.record_event("breaker_" + new, bucket=bucket,
                          previous=old)

    def record_state_change(self, old: str, new: str,
                            reason: str) -> None:
        """Scheduler health-state transition (healthy|degraded|wedged)."""
        self.record_event("serving_state", state=new, previous=old,
                          reason=reason)

    def record_circuit_rejected(self, n: int = 1) -> None:
        """Submit-time fail-fast: the bucket's breaker was open."""
        with self._lock:
            self.circuit_rejected += n

    # -- reporting --------------------------------------------------------

    def snapshot(self, executables: Optional[int] = None) -> Dict:
        """One self-contained record: counters, queue-depth gauges,
        occupancy vs the one-request-per-dispatch baseline, and the
        per-bucket stage histograms."""
        # read the feature-cache block BEFORE taking the metrics lock:
        # the pool lock is a leaf and must never nest under this one
        prov = self.feature_cache_provider
        fcache = prov() if prov is not None else None
        with self._lock:
            self._snapshots += 1
            filled = sum(b["filled"] for b in self._buckets.values())
            capacity = sum(b["capacity"] for b in self._buckets.values())
            depth_mean = (self._depth_sum / self._depth_samples
                          if self._depth_samples else 0.0)
            rec = {
                # the Logger contract: every jsonl record carries "step"
                "step": self._snapshots,
                "kind": "serving",
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "shed": self.shed,
                "evicted": self.evicted,
                "admission_rejected": self.admission_rejected,
                "deadline_missed": self.deadline_missed,
                "cancelled": self.cancelled,
                "abandoned_inflight": self.abandoned_inflight,
                "dispatches": self.dispatches,
                "executables": executables,
                "resilience": {
                    "wedged": self.wedged,
                    "quarantined_threads": self.quarantined_threads,
                    "circuit_rejected": self.circuit_rejected,
                    "breaker_transitions":
                        dict(self.breaker_transitions),
                },
                "queue_depth": {"last": self.depth_last,
                                "max": self.depth_max,
                                "mean": round(depth_mean, 3)},
                "occupancy": {
                    "filled": filled,
                    "capacity": capacity,
                    "mean": round(filled / capacity, 4) if capacity
                    else 0.0,
                    # what the same dispatch count would score carrying
                    # ONE request each — the no-coalescing strawman the
                    # drill must strictly beat
                    "one_per_dispatch_baseline":
                        round(self.dispatches / capacity, 4) if capacity
                        else 0.0,
                },
                # padded device pixels vs requested pixels, every
                # dispatch path — the waste the ragged A/B compares
                "padding_waste": {
                    "real_px": self.real_px,
                    "padded_px": self.padded_px,
                    "waste_ratio": round(
                        1.0 - self.real_px / self.padded_px, 4)
                    if self.padded_px else 0.0,
                },
                "ragged": {
                    "dispatches": self.ragged_dispatches,
                    "cross_shape_dispatches": self.ragged_cross_shape,
                    "cross_shape_coalesce_rate": round(
                        self.ragged_cross_shape
                        / self.ragged_dispatches, 4)
                    if self.ragged_dispatches else 0.0,
                    "capacity_fill": round(
                        self.ragged_real_px / self.ragged_padded_px, 4)
                    if self.ragged_padded_px else 0.0,
                },
                "hot_path": {
                    "dispatch_gap": self._gap.snapshot(),
                    "h2d_bytes": self.h2d_bytes,
                    "h2d_bytes_per_req":
                        round(self.h2d_bytes / self.h2d_requests, 1)
                        if self.h2d_requests else 0.0,
                    "assembly": {
                        "total_ms": round(self._assembly_ms, 3),
                        "overlapped_ms":
                            round(self._assembly_overlapped_ms, 3),
                        "overlap_ratio": round(
                            self._assembly_overlapped_ms
                            / self._assembly_ms, 4)
                        if self._assembly_ms else 0.0,
                    },
                },
                "latency": self._latency.snapshot(),
                "priority": {
                    cls: {"submitted": p["submitted"],
                          "completed": p["completed"],
                          "shed": p["shed"],
                          "deadline_missed": p["deadline_missed"],
                          "latency": p["latency"].snapshot()}
                    for cls, p in sorted(self._priority.items())
                },
                "hist_bounds_ms": list(_BOUNDS_MS),
                "buckets": {
                    key: {
                        "dispatches": b["dispatches"],
                        "filled": b["filled"],
                        "capacity": b["capacity"],
                        "occupancy": round(b["filled"] / b["capacity"], 4)
                        if b["capacity"] else 0.0,
                        "real_px": b["real_px"],
                        "padded_px": b["padded_px"],
                        "padding_waste": round(
                            1.0 - b["real_px"] / b["padded_px"], 4)
                        if b["padded_px"] else 0.0,
                        **{stage: b[stage].snapshot()
                           for stage in _STAGES},
                    }
                    for key, b in sorted(self._buckets.items())
                },
            }
            if self._replicas:
                # replica fleet armed: per-lane fan-out blocks (the
                # balance/occupancy evidence the 2×-spread acceptance
                # reads). Absent in single-engine mode: additive
                # schema, byte-identical without a fleet.
                rec["replicas"] = {
                    str(k): {
                        "dispatches": r["dispatches"],
                        "filled": r["filled"],
                        "capacity": r["capacity"],
                        "occupancy": round(r["filled"] / r["capacity"],
                                           4)
                        if r["capacity"] else 0.0,
                        "completed": r["completed"],
                        "queue_depth_last": r["queue_depth_last"],
                        "latency": r["latency"].snapshot(),
                    }
                    for k, r in sorted(self._replicas.items())
                }
            if self._hosts:
                # multi-host fleet armed: per-host liveness/failover/
                # artifact-push evidence (the kill-drill acceptance
                # reads host_dead counts + failovers + push bytes
                # here). Absent with hosts=0: additive schema,
                # byte-identical without remote lanes.
                rec["hosts"] = {
                    name: dict(h)
                    for name, h in sorted(self._hosts.items())
                }
            if fcache is not None:
                rec["feature_cache"] = fcache
            if self._exemplars:
                # request tracing armed: refs of completions in the
                # CURRENT top occupied latency bucket — the span ids
                # serve_trace's phase attribution runs over (early
                # exemplars overtaken by a later, slower top bucket
                # are filtered here; their spans stay retained).
                # Absent whenever tracing is off: additive schema.
                top = self._tail_max_idx
                refs = [dict(e) for e in self._exemplars
                        if e["bucket_idx"] == top]
                rec["tail_exemplars"] = {
                    "top_bucket_idx": top,
                    "top_bucket_gt_ms": (self._latency.bounds[top - 1]
                                         if top > 0 else 0.0),
                    "refs": refs,
                }
            if self.namespace is not None:
                rec["model"] = self.namespace
        return rec

    def write_snapshot(self, executables: Optional[int] = None,
                       path: Optional[str] = None) -> Dict:
        """Append one snapshot line to ``path`` (default: the ctor's);
        returns the record."""
        rec = self.snapshot(executables=executables)
        dest = path or self.path
        if dest is None:
            raise ValueError("no metrics path configured")
        parent = os.path.dirname(dest)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(dest, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(rec) + "\n")
        return rec
