"""Request-scoped tracing: a span ledger across the serving stack;
port of ``raft_tpu/serving/trace.py`` (the same record schema).

The serving metrics (serving/metrics.py) are *aggregates* — latency
histograms, counters, breaker/guardian events — so when p99 spikes
there is no way to say WHICH request was slow or WHY (queue wait?
cross-shape coalescing? cache-miss re-prime? pipeline slot wait? wedge
collateral?). This module is the per-request causality layer: every
ACCEPTED request gets a trace id minted at intake, its **span**
records phase timestamps (enqueue → micro-batch assembly → dispatch →
device fetch → settle) plus structured annotations from every layer
it crosses — coalesce fan-in (one *dispatch span* linked to the N
request spans it carried, with bucket/capacity-class key and
padding-waste share), feature-cache hit/miss/prime, breaker state at
admit, wedge/deadline/shed/eviction outcome, and session chaining
(frame N's span links frame N−1's, so a warm-start recurrence is a
walkable chain) — the per-request attribution Ragged Paged Attention
(arXiv 2604.15464) applies to padded-vs-real work, lifted to the
whole request lifecycle.

Spans append to ``spans.jsonl`` (one JSON object per line, beside
metrics.jsonl) under a **sampling knob with always-keep-tail exemplar
capture**: ``sample_rate`` drops the bulk deterministically (sha256
of the trace id — no RNG, reproducible), but a request landing in a
top latency-histogram bucket (``tail=True`` — ServingMetrics flags it
at completion) is retained regardless, and so is every non-completed
outcome (failures ARE the forensic targets). ``raft_tpu_torch.cli.
serve_trace`` reconstructs a trace's timeline and answers "where did
the p99 go" with a phase-attribution table over the exemplars.

Exactly-once closure is the contract the chaos drill pins: every span
opened for an accepted request closes exactly once, with an outcome
tag whose accounting **class** (``completed`` | ``failed`` |
``deadline_missed`` | ``cancelled``) matches the counter the request
landed in — spans and the accounting identity reconcile
bucket-for-bucket. Closure races (a wedge verdict vs the completion
stage) are settled by whoever won the FUTURE (serving/futures.py);
``close`` is additionally idempotent so a linked dispatch span may be
closed from every path that could orphan it.

I/O discipline: ``close`` never writes — records buffer under the
ledger's leaf lock (pure list append) and :meth:`flush` does the file
I/O with NO lock held, called from the scheduler's
dispatcher loop, the completion stage, and ``close()`` — spans.jsonl
is eventually consistent while serving and complete after a drain.

Tracing defaults OFF everywhere (no ledger constructed ⇒ every
serving path runs untraced — the standing knob convention).

**Layer spans** (:class:`SpanRecorder`, one per process:
:data:`RECORDER`, whose :func:`span`, :func:`records` and
:func:`markers` are the module's functions). Apart from the ledger,
the train step, the scheduler and the engine time the boundaries
between their layers: ``train.step`` and its phases, the
dispatcher's slot wait, gather, assembly and ship, the completion
stage's fetch wait, D2H copy and settle, and one ``sched.request``
record per completed request. The record lives in memory only (never
in ``spans.jsonl``, whose schema the JAX package validates) and is
armed exactly while a ``torch.profiler`` session is active, the
convention of ``torch.profiler.record_function``: unarmed, a span
site costs one flag read. To get the spans, run any profiler session
(``torch.profiler.profile``, the trainer's ``profile_steps`` window,
``cli/profile_step``) over the work and call :func:`records` once it
has stopped; the first span of the next session clears them.

Spans stamp ``time.perf_counter_ns()``. A span whose thread issues
device work (``train.*``, ``sched.ship``) launches, while armed, a
one-thread marker kernel (``torch.cuda._sleep``, named
``spin_kernel`` in the trace) on a stream of its own, and
:func:`markers` keeps the host stamp taken just before each launch.
The least of (the marker's device start − its stamp) over the
markers is the offset that puts the spans on the device trace's
clock; the benchmark's ``flowbench/spans.py`` reads them so.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

#: the ledger lock is a LEAF — span opens/closes arrive
#: from under the scheduler's queue lock (``_cv``, the deadline sweep)
#: and the metrics lock's callers, so taking any other serving lock in
#: here would invert the declared order. Span writes never settle
#: futures or fire listeners under it; file I/O happens in ``flush``
#: with NO lock held.
LOCK_ORDER = (("trace.TraceLedger._lock",),)

#: graftthread declarations: one leaf lock, no callbacks, no threads, no
#: futures; every method is dict and list bookkeeping under ``_lock``
#: except ``flush``'s lock-free file append.
GRAFTTHREAD = {"locks": ("_lock",)}

#: accounting-identity classes a request span may close under — the
#: four counters of submitted == completed + failed + deadline_missed
#: + cancelled (serving/metrics.py)
SPAN_CLASSES = ("completed", "failed", "deadline_missed", "cancelled")

#: phase marks a request span may carry (ms offsets from enqueue):
#: ``taken`` — popped into a micro-batch (assembly begins), ``shipped``
#: — the async device call was issued, ``fetch_start`` — the blocking
#: D2H fetch began (the pipelined completion stage's clock)
SPAN_MARKS = ("taken", "shipped", "fetch_start")


def sample_fraction(trace_id: str) -> float:
    """Deterministic sampling hash in [0, 1): a span is sampled in iff
    this is < the ledger's ``sample_rate``. sha256 over the trace id —
    stable across processes and re-runs (no RNG, no state), the same
    discipline as the registry's canary hash."""
    digest = hashlib.sha256(trace_id.encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2.0 ** 64


class _Span:
    """One open span: identity + start clock + marks + fields.

    ``marks`` are monotonic ms offsets from ``t0``; ``fields`` are the
    static annotations (bucket label, model/variant/canary stamp,
    stream/seq, breaker state at admit, ...). ``linked`` is the
    request span's dispatch span (closed together on failure paths so
    a wedged batch can never orphan its dispatch record);
    ``child_kept`` on a dispatch span records that at least one linked
    request span was written — a dispatch span with no written
    children is dropped (its refs would dangle)."""

    __slots__ = ("trace_id", "span", "t0", "wall0", "marks", "fields",
                 "closed", "linked", "child_kept")

    def __init__(self, trace_id: str, span: str, t0: float,
                 wall0: float, fields: Dict):
        self.trace_id = trace_id
        self.span = span            # "request" | "dispatch"
        self.t0 = t0
        self.wall0 = wall0
        self.marks: Dict[str, float] = {}
        self.fields = fields
        self.closed = False
        self.linked: Optional["_Span"] = None
        self.child_kept = False


def _phases(marks: Dict[str, float], total_ms: float) -> Dict[str, float]:
    """Phase durations from a span's marks: queue (enqueue→taken),
    assembly (taken→shipped), device (shipped→fetch_start — the async
    in-flight window; ~0 on the unpipelined path where fetch follows
    the ship immediately), fetch (fetch_start→settle). Absent marks
    collapse into the preceding phase — a span failed while queued is
    100% queue."""
    taken = marks.get("taken")
    shipped = marks.get("shipped")
    fstart = marks.get("fetch_start")
    ph = {"queue_ms": taken if taken is not None else total_ms}
    if taken is not None:
        ph["assembly_ms"] = (shipped if shipped is not None
                             else total_ms) - taken
    if shipped is not None:
        ph["device_ms"] = (fstart if fstart is not None
                           else total_ms) - shipped
    if fstart is not None:
        ph["fetch_ms"] = total_ms - fstart
    return {k: round(max(0.0, v), 3) for k, v in ph.items()}


class TraceLedger:
    """Thread-safe span ledger writing ``spans.jsonl``.

    ``path``: the jsonl destination (None: spans are tracked and
    counted but never written — the unit-test mode). ``sample_rate``
    in [0, 1]: deterministic keep fraction for completed request
    spans; tail exemplars and non-completed outcomes are ALWAYS kept.

    Intake context rides a thread-local, not an API change: the
    registry's ``_route_and_admit`` calls :meth:`stamp_intake` with
    the model/variant/canary assignment just before handing the
    request to the variant's scheduler (same thread), and a
    ``VideoSession`` calls :meth:`set_parent` with the previous
    frame's trace id — :meth:`begin` consumes both, so the scheduler's
    submit signature stays untouched.
    """

    def __init__(self, path: Optional[str] = None,
                 sample_rate: float = 1.0):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate={sample_rate}: must be in [0, 1]")
        self.path = path
        self.sample_rate = float(sample_rate)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._seq = 0
        self._open: Dict[str, _Span] = {}
        self._buffer: List[str] = []
        # counters (the ledger's own observability block)
        self.opened = 0
        self.closed = 0
        self.written = 0
        self.sampled_out = 0
        self.tail_kept = 0
        self.discarded = 0
        self.write_errors = 0

    # -- intake context (thread-local, consumed by begin) ------------------

    def stamp_intake(self, **fields) -> None:
        """Stamp routing context (model/variant/canary, ...) onto the
        NEXT span this thread opens — the registry's hook."""
        self._tls.intake = fields

    def clear_intake(self) -> None:
        """Drop any unconsumed intake stamp (the registry's finally —
        a submit rejected before the mint must not leak its stamp into
        an unrelated later span on the same thread)."""
        self._tls.intake = None
        self._tls.parent = None

    def set_parent(self, trace_id: Optional[str]) -> None:
        """Link the NEXT span this thread opens to ``trace_id`` — the
        session-chaining hook (frame N's span points at frame N−1's)."""
        self._tls.parent = trace_id

    # -- span lifecycle ----------------------------------------------------

    def begin(self, span: str = "request", **fields) -> _Span:
        """Open a span: mints the trace id (``r-``/``d-`` + counter),
        consumes this thread's intake stamp and parent link, registers
        it open (the orphan-detection set)."""
        intake = getattr(self._tls, "intake", None)
        parent = getattr(self._tls, "parent", None)
        self._tls.intake = None
        self._tls.parent = None
        if intake:
            fields = {**fields, **intake}
        if parent is not None and "parent" not in fields:
            fields["parent"] = parent
        with self._lock:
            self._seq += 1
            trace_id = f"{'d' if span == 'dispatch' else 'r'}-{self._seq}"
            s = _Span(trace_id, span, time.monotonic(), time.time(),
                      fields)
            self._open[trace_id] = s
            self.opened += 1
        return s

    def annotate(self, s: _Span, **fields) -> None:
        """Merge annotations into an open span (later layers: cache
        hit/miss, dispatch link, fan-in, ...)."""
        with self._lock:
            s.fields.update(fields)

    def mark(self, s: _Span, phase: str,
             at: Optional[float] = None) -> None:
        """Stamp a phase mark (monotonic ``at``, default now) as a ms
        offset from the span's open."""
        t = at if at is not None else time.monotonic()
        with self._lock:
            s.marks[phase] = (t - s.t0) * 1e3

    def discard(self, s: _Span) -> None:
        """Un-open a span that never became an accepted request (the
        enqueue raised backpressure/closed after the mint) — counted,
        never written; the zero-orphan invariant covers accepted
        requests only. A consumed parent link is RESTORED to the
        thread-local (discard runs on the minting thread): a
        rollout-raced registry submit that re-routes to live, or a
        session retry after backpressure, must not drop its frame out
        of the stream's trace chain."""
        with self._lock:
            if s.closed:
                return
            s.closed = True
            self._open.pop(s.trace_id, None)
            self.discarded += 1
        parent = s.fields.get("parent")
        if parent is not None:
            self._tls.parent = parent

    def close(self, s: _Span, outcome: str, cls: Optional[str] = None,
              tail: bool = False, **fields) -> bool:
        """Close a span exactly once (idempotent — a second close is a
        counted no-op returning False): compute phases, decide
        retention (class != completed, tail exemplar, or the
        deterministic sample), buffer the record. Returns whether the
        record was KEPT. Never does file I/O (see :meth:`flush`)."""
        t_close = time.monotonic()
        with self._lock:
            if s.closed:
                return False
            s.closed = True
            self._open.pop(s.trace_id, None)
            self.closed += 1
            if fields:
                s.fields.update(fields)
            total_ms = round((t_close - s.t0) * 1e3, 3)
            if s.span == "dispatch":
                keep = s.child_kept
            else:
                keep = (tail or (cls is not None and cls != "completed")
                        or sample_fraction(s.trace_id) < self.sample_rate)
            if tail:
                self.tail_kept += 1
            if not keep:
                # an unkept child never marks its dispatch span kept
                self.sampled_out += 1
                return False
            if s.linked is not None:
                s.linked.child_kept = True
            rec = {"kind": "span", "span": s.span,
                   "trace_id": s.trace_id, "time": s.wall0,
                   "outcome": outcome, "total_ms": total_ms,
                   "tail": bool(tail), **s.fields}
            if cls is not None:
                rec["class"] = cls
            if s.span == "request":
                rec["phases"] = _phases(s.marks, total_ms)
            self.written += 1
            if self.path is None:
                return True
            self._buffer.append(json.dumps(rec))
        return True

    # -- I/O + observability -----------------------------------------------

    def flush(self) -> int:
        """Append every buffered span record to ``path``; returns how
        many lines were written. File I/O runs with NO lock held (a
        slow disk must never stall a settle under the queue lock); a
        failed append is logged and swallowed — observability must
        never take down serving."""
        with self._lock:
            if not self._buffer or self.path is None:
                return 0
            lines, self._buffer = self._buffer, []
        try:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write("\n".join(lines) + "\n")
        except OSError as exc:
            with self._lock:
                self.write_errors += 1
            print(f"[serve-trace] span append failed ({exc}) — "
                  "continuing", file=sys.stderr, flush=True)
            return 0
        return len(lines)

    def open_count(self) -> int:
        """How many spans are open right now — 0 after a drain, or
        there is an orphan (the chaos drill's invariant)."""
        with self._lock:
            return len(self._open)

    def open_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._open)

    def snapshot(self) -> Dict:
        """The ledger's counter block (rides the serve_bench summary
        when tracing is armed)."""
        with self._lock:
            return {"sample_rate": self.sample_rate,
                    "opened": self.opened, "closed": self.closed,
                    "open": len(self._open), "written": self.written,
                    "sampled_out": self.sampled_out,
                    "tail_kept": self.tail_kept,
                    "discarded": self.discarded,
                    "write_errors": self.write_errors,
                    "buffered": len(self._buffer)}


# -- layer spans on the profiler's clock -------------------------------------

#: the records one armed stretch keeps; any more are counted in ``dropped``
MAX_RECORDS = 1 << 18

#: ``time.perf_counter_ns()`` less ``time.monotonic_ns()``: the scheduler
#: stamps its requests by ``time.monotonic()`` (0 where both read one clock)
_PERF_LESS_MONOTONIC_NS = time.perf_counter_ns() - time.monotonic_ns()


def _perf_ns(t_monotonic: float) -> int:
    """A ``time.monotonic()`` reading on the spans' clock, in ns."""
    return int(t_monotonic * 1e9) + _PERF_LESS_MONOTONIC_NS


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` is the name of the span its thread was
    inside when it began; ``marks`` hold further instants (ns) of a
    record that is not a block of one thread (``sched.request``'s
    ``taken``)."""

    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: Optional[str]
    marks: Optional[Dict[str, int]] = None


class _Unarmed:
    """The span every site gets while no profiler runs: does nothing, and
    is false, so a site can skip work only an armed span needs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def end(self) -> None:
        pass

    def add(self, name: str, start_s: float, end_s: float,
            **marks: float) -> None:
        pass


UNARMED = _Unarmed()


class _OpenSpan:
    """An open armed span; ``end()`` (or leaving its ``with`` block)
    closes it once, into the stretch it began in."""

    __slots__ = ("_rec", "_into", "name", "thread", "start_ns", "parent",
                 "_done")

    def __init__(self, rec: "SpanRecorder", into: List, name: str,
                 parent: Optional[str], start_ns: Optional[int] = None):
        self._rec = rec
        self._into = into
        self.name = name
        self.thread = threading.get_ident()
        self.parent = parent
        self._done = False
        self.start_ns = (time.perf_counter_ns() if start_ns is None
                         else start_ns)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def __bool__(self) -> bool:
        return True

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        t = time.perf_counter_ns()
        stack = self._rec._stack()
        if self in stack:
            stack.remove(self)
        self._rec._keep(self._into, SpanRecord(
            self.name, self.thread, self.start_ns, t, self.parent))

    def add(self, name: str, start_s: float, end_s: float,
            **marks: float) -> None:
        """A record of ``name`` from ``start_s`` to ``end_s`` with
        ``marks``, all ``time.monotonic()`` readings, as a child of this
        span: an interval no single block of code spans (a request's
        life from its submit)."""
        self._rec._keep(self._into, SpanRecord(
            name, self.thread, _perf_ns(start_s), _perf_ns(end_s), self.name,
            {k: _perf_ns(v) for k, v in marks.items()}))


class SpanRecorder:
    """Spans at the boundaries between layers, kept in memory while a
    ``torch.profiler`` session is active (see the module's docstring).

    A stretch is the run of armed spans of one profiler session: its
    first span clears the records of the stretch before. A stretch ends
    at the first :meth:`span` or :meth:`records` call that finds no
    profiler running, so two sessions with neither call between them
    share one stretch."""

    def __init__(self, limit: int = MAX_RECORDS):
        self.limit = limit
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._stretch = False
        self._records: List[SpanRecord] = []
        self._markers: List[int] = []
        self._streams: Dict = {}
        self.dropped = 0

    def span(self, name: str, marker=None):
        """A context manager timing its block as ``name``; unarmed, a
        no-op. ``marker``: the device the block's thread issues work to;
        on a CUDA device whose current stream is not capturing, an armed
        span launches the marker kernel there as it begins, and the
        marker's stamp is the span's start."""
        if not _profiler._is_profiler_enabled:
            if self._stretch:
                self._stretch = False
            return UNARMED
        if not self._stretch:
            self._begin_stretch()
        stack = self._stack()
        start = None if marker is None else self._mark(marker)
        s = _OpenSpan(self, self._records, name,
                      stack[-1].name if stack else None, start)
        stack.append(s)
        return s

    def records(self) -> List[SpanRecord]:
        """The records of the latest armed stretch, in the order they
        closed."""
        if not _profiler._is_profiler_enabled:
            self._stretch = False
        return list(self._records)

    def markers(self) -> List[int]:
        """The host stamps (ns) of the latest stretch's marker launches,
        one per marker kernel in the device trace."""
        return list(self._markers)

    def _begin_stretch(self) -> None:
        with self._lock:
            if not self._stretch:
                self._records = []
                self._markers = []
                self.dropped = 0
                self._stretch = True

    def _stack(self) -> List[_OpenSpan]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _keep(self, into: List, rec: SpanRecord) -> None:
        if len(into) < self.limit:
            into.append(rec)
        else:
            with self._lock:
                self.dropped += 1

    def _mark(self, device) -> Optional[int]:
        """Launch the marker kernel on ``device``'s marker stream; the
        host stamp taken just before the launch, or None if none was
        launched."""
        if isinstance(device, str):
            device = torch.device(device)
        if (not isinstance(device, torch.device) or device.type != "cuda"
                or torch.cuda.is_current_stream_capturing()):
            return None
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        stream = self._streams.get(index)
        if stream is None:
            stream = self._streams.setdefault(
                index, torch.cuda.Stream(index))
        markers = self._markers
        with torch.cuda.stream(stream):
            t = time.perf_counter_ns()
            torch.cuda._sleep(1)
        if len(markers) < self.limit:
            markers.append(t)
        return t


#: the process's span record; ``span``, ``records`` and ``markers`` are its
RECORDER = SpanRecorder()
span = RECORDER.span
records = RECORDER.records
markers = RECORDER.markers
