"""Serving resilience primitives: dispatch watchdog + circuit breakers;
port of ``raft_tpu/serving/resilience.py``.

The trainer's watchdog makes *training* survive wedges; this module is
the serving counterpart. The scheduler's dispatch path runs arbitrary
device work (CUDA graph captures, bucket replays) that can hang forever
on a half-up backend — the failure mode ``testing/faults`` models at the
``serve.request`` site. Python cannot kill a thread, so the recovery
discipline mirrors the training watchdog's exit-class discipline one
level down:

- :class:`DispatchExecutor` runs each dispatch on a supervised worker
  thread. The scheduler (the supervisor) waits on the job with a
  wall-clock deadline; on a wedge verdict it fails the batch's futures
  with :class:`DispatchWedged`, quarantines the stuck thread (daemon —
  it parks until its hang ends, then exits without touching the
  mailbox), spawns a replacement, and *accounts the leak* in metrics
  instead of pretending the thread died.
- :class:`CircuitBreaker` isolates failure per bucket (the natural
  unit of ragged multi-shape serving: one poisoned shape must not
  take down the fleet of healthy shapes): closed -> open after K
  consecutive failures/wedges -> half-open probe after a jittered
  exponential backoff (``utils/retry.backoff_delays``, the shared
  transient-failure policy) -> closed again on a probe success.

Engine-agnostic; the scheduler composes these with the
engine-recovery path (drop the suspect bucket's program, lazily
recapture it on the half-open probe).
"""

from __future__ import annotations

import itertools
import queue
import random
import threading
import time
from typing import Callable, List, Optional, Tuple

from raft_tpu_torch.testing.faults import fault_point
from raft_tpu_torch.utils.retry import backoff_delays

#: both locks here are LEAVES — nothing is ever
#: acquired under them (the scheduler's chains name them as terminal
#: nodes; the breaker listener contract below is what keeps it so).
LOCK_ORDER = (
    ("resilience.CircuitBreaker._lock",),
    ("resilience.DispatchExecutor._lock",),
)

#: graftthread T4: transition listeners are caller-supplied code that
#: reads OTHER locked state (the scheduler's health recompute walks the
#: whole breaker board) — they fire via the _set/_notify split, never
#: inside the breaker lock.
GRAFTTHREAD = {"callbacks": ("_on_transition", "on_transition")}


class DispatchWedged(RuntimeError):
    """A dispatch exceeded ``dispatch_timeout_s``: the watchdog failed
    its futures, quarantined the stuck worker thread, and replaced it.
    The bucket is suspect — its compiled executable is dropped and the
    breaker (if armed) opens."""


class CircuitOpen(RuntimeError):
    """The request's bucket breaker is open: the bucket failed/wedged
    K consecutive times and is failing fast until the half-open probe
    succeeds. Healthy buckets keep serving; retry after backoff."""


#: breaker states — strings on purpose: they go straight into
#: ``health()`` JSON and metrics.jsonl events
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-bucket failure isolation: closed -> open -> half-open.

    ``failures``: consecutive failures/wedges that trip the breaker.
    Backoff between open and the half-open probe follows
    ``backoff_delays(base_s, max_s, jitter=jitter, rng=rng)`` — each
    failed probe re-opens with the next (longer) delay; a recovery
    (probe success -> closed) resets the series. ``clock`` is
    injectable for deterministic tests.

    ``on_transition(old, new)`` fires on every state change, *outside*
    the breaker lock (listeners append metrics events and recompute
    scheduler health — they must be free to read other breakers).

    ``label`` names the breaker on the health surface. The scheduler
    keys it ``model/HxW`` when it serves under a registry namespace
    and plain ``HxW`` single-model — per model+bucket, so one model's
    poisoned shape reads unambiguously on a board N models share.

    Probe discipline: this class does not ration probes itself — the
    scheduler's single dispatcher thread serializes dispatch, so at
    most one half-open probe is in flight by construction.
    """

    def __init__(self, failures: int = 3, base_s: float = 0.25,
                 max_s: float = 30.0, jitter: float = 0.5,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str], None]]
                 = None, label: Optional[str] = None):
        if failures < 1:
            raise ValueError(f"failures={failures}: must be >= 1")
        self.failures = int(failures)
        self.label = label
        self._clock = clock
        self._on_transition = on_transition
        self._mk_delays = lambda: backoff_delays(base_s, max_s,
                                                 jitter=jitter, rng=rng)
        self._delays = self._mk_delays()
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._retry_at: Optional[float] = None
        self.consecutive = 0   # consecutive failures since last success
        self.opens = 0         # cumulative closed/half-open -> open trips
        self.wedges = 0        # how many of the failures were wedges

    def _set(self, new: str) -> Optional[Tuple[str, str]]:
        """State write under the lock; returns the transition for the
        caller to notify AFTER releasing (listeners read other
        breakers — firing under the lock would deadlock a health
        recompute)."""
        old = self._state
        if old == new:
            return None
        self._state = new
        return (old, new)

    def _notify(self, fired: Optional[Tuple[str, str]]) -> None:
        if fired is not None and self._on_transition is not None:
            self._on_transition(*fired)

    def state(self) -> str:
        """Current state, promoting an expired ``open`` to
        ``half_open`` (fires the transition listener)."""
        with self._lock:
            fired = None
            if (self._state == BREAKER_OPEN
                    and self._clock() >= self._retry_at):
                fired = self._set(BREAKER_HALF_OPEN)
            st = self._state
        self._notify(fired)
        return st

    def peek(self) -> str:
        """State without side effects (health snapshots): an expired
        ``open`` reads as ``half_open`` but no transition fires."""
        with self._lock:
            if (self._state == BREAKER_OPEN
                    and self._clock() >= self._retry_at):
                return BREAKER_HALF_OPEN
            return self._state

    def record_failure(self, wedged: bool = False) -> None:
        with self._lock:
            self.consecutive += 1
            if wedged:
                self.wedges += 1
            fired = None
            if self._state == BREAKER_HALF_OPEN:
                # failed probe: back to open with the next, longer delay
                self.opens += 1
                self._retry_at = self._clock() + next(self._delays)
                fired = self._set(BREAKER_OPEN)
            elif (self._state == BREAKER_CLOSED
                    and self.consecutive >= self.failures):
                self.opens += 1
                self._delays = self._mk_delays()  # fresh series per trip
                self._retry_at = self._clock() + next(self._delays)
                fired = self._set(BREAKER_OPEN)
        self._notify(fired)

    def record_success(self) -> None:
        with self._lock:
            self.consecutive = 0
            fired = None
            if self._state != BREAKER_CLOSED:
                self._retry_at = None
                fired = self._set(BREAKER_CLOSED)
        self._notify(fired)

    def snapshot(self) -> dict:
        """Health-surface view of this breaker."""
        with self._lock:
            retry_in = None
            state = self._state
            if state == BREAKER_OPEN:
                retry_in = max(0.0, self._retry_at - self._clock())
                if retry_in == 0.0:
                    state = BREAKER_HALF_OPEN  # peek semantics
            snap = {"state": state,
                    "consecutive_failures": self.consecutive,
                    "opens": self.opens,
                    "wedges": self.wedges,
                    "retry_in_s": (round(retry_in, 3)
                                   if retry_in is not None else None)}
            if self.label is not None:
                snap["label"] = self.label
            return snap


class _DispatchJob:
    """One supervised dispatch (or, at ``pipeline_depth`` > 1, one
    pipelined completion). The executing thread fills ``bucket`` (the
    routed executable shape — the wedge verdict's drop target) and
    ``batch`` (the taken requests — the wedge verdict's futures to
    fail) as it goes; the supervisor sets ``abandoned`` at the verdict
    so a late-waking thread aborts instead of dispatching into a
    dropped bucket (which would compile a leaked duplicate).
    Completion jobs additionally carry ``key`` (the request shape, for
    the breaker board) and ``t_start`` (handoff time — the completion
    watchdog's clock)."""

    __slots__ = ("fn", "done", "error", "outcome", "bucket", "batch",
                 "abandoned", "key", "t_start", "kind")

    def __init__(self, fn: Optional[Callable[["_DispatchJob"], None]]):
        self.fn = fn
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.outcome: Optional[str] = None   # "ok" | "failed" | None
        self.bucket: Optional[Tuple[int, int, int]] = None
        self.batch = None
        self.abandoned = False
        self.key: Optional[Tuple[int, int]] = None
        self.t_start: Optional[float] = None
        #: the engine's program kind of ``bucket`` (``"plain"``,
        #: ``"ragged"`` or ``"cached"``): the table a wedge verdict drops
        #: it from, never a sibling kind's program at the same shape
        self.kind = "plain"


class DispatchExecutor:
    """One supervised worker thread running dispatch jobs in order.

    Single-supervisor contract: ``submit``, ``quarantine_and_replace``
    and ``close`` are called from the scheduler's dispatcher thread
    only — one job is in flight at a time, so each worker owns a
    private mailbox and a quarantined worker (its mailbox replaced
    under the lock) exits after its stuck job instead of stealing work
    from the replacement.
    """

    _ids = itertools.count(1)

    def __init__(self, name: str = "MicroBatchScheduler-exec"):
        self._name = name
        self._lock = threading.Lock()
        self._closed = False
        self.quarantined: List[threading.Thread] = []
        self._mailbox: Optional[queue.SimpleQueue] = None
        self._thread: Optional[threading.Thread] = None
        self._spawn()

    def _spawn(self) -> None:
        mailbox: queue.SimpleQueue = queue.SimpleQueue()
        t = threading.Thread(
            target=self._loop, args=(mailbox,),
            name=f"{self._name}-{next(self._ids)}", daemon=True)
        self._mailbox, self._thread = mailbox, t
        t.start()

    def _loop(self, mailbox: queue.SimpleQueue) -> None:
        while True:
            job = mailbox.get()
            if job is None:
                return
            try:
                # chaos site: a hang here wedges the executor worker
                # itself (not the engine) — the quarantine path must
                # not care WHERE in the dispatch the thread stuck
                fault_point("serve.dispatch_exec")
                job.fn(job)
            except BaseException as exc:  # noqa: BLE001 — outcome goes
                job.error = exc           # to the supervisor, the
            finally:                      # worker must survive anything
                job.done.set()
            with self._lock:
                if mailbox is not self._mailbox:
                    # quarantined while running: a replacement owns the
                    # executor now — park no longer, exit quietly
                    return

    def submit(self, fn: Callable[[_DispatchJob], None]) -> _DispatchJob:
        job = _DispatchJob(fn)
        self._mailbox.put(job)
        return job

    def enqueue(self, job: _DispatchJob) -> None:
        """Queue an already-built job on the CURRENT worker. Two users:
        the pipelined completion stage hands off prebuilt jobs here,
        and a completion-wedge verdict re-queues the jobs that were
        parked BEHIND the stuck one — their entries live in the
        abandoned mailbox (a quarantined worker exits without draining
        it), so the supervisor must re-queue them on the replacement or
        their futures strand."""
        self._mailbox.put(job)

    def quarantine_and_replace(self) -> int:
        """Wedge verdict: abandon the stuck worker (Python can't kill
        it; it exits on its own when the hang ends) and spawn a fresh
        one. Returns how many quarantined threads are still alive —
        the leak the metrics record."""
        with self._lock:
            self.quarantined.append(self._thread)
            self._spawn()
        return sum(t.is_alive() for t in self.quarantined)

    def quarantined_alive(self) -> int:
        with self._lock:
            return sum(t.is_alive() for t in self.quarantined)

    def worker_alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def close(self, timeout: float = 10.0) -> bool:
        """Stop and join the current worker (idempotent). Quarantined
        threads are daemon and not joinable — they are accounted, not
        waited for. Returns True when the current worker exited."""
        with self._lock:
            self._closed = True
            mailbox, thread = self._mailbox, self._thread
        mailbox.put(None)
        thread.join(timeout)
        return not thread.is_alive()
