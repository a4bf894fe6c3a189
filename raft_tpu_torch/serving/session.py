"""Per-stream video sessions: warm-started recurrence over the scheduler
or a model registry; port of ``raft_tpu/serving/session.py``.

RAFT's refinement is a recurrence, and consecutive frames of one stream
are nearly the same problem — the reference's Sintel submission writer
carries the previous pair's low-res flow into the next pair's start
(``warm_start``, evaluation/evaluate.py) and converges in fewer
effective iterations. This lifts that into serving (the serving analog
of compiler-first O(1) autoregressive state reuse for SSM inference,
arXiv 2603.09555): a :class:`VideoSession` is a thin per-stream state
holder — frames go in one at a time, each consecutive pair becomes one
scheduler request, and the returned ``flow_low`` is
forward-interpolated (ops/interp, the reference's host-side scipy path)
into the next request's ``flow_init``.

The per-stream recurrence is sequential by nature (pair N+1's warm
start needs pair N's flow), but it never serializes the DEVICE: each
request still coalesces with other streams' and one-shot callers' work
in the scheduler queue, and a zero ``flow_init`` is bit-for-bit a cold
start, so warm and cold rows share one bucket program.
"""

from __future__ import annotations

import itertools
import random
import time
from typing import Callable, Optional

import numpy as np
import torch

from raft_tpu_torch.ops.interp import (forward_interpolate,
                                       forward_interpolate_device)
from raft_tpu_torch.serving.feature_cache import FeatureCacheMiss
from raft_tpu_torch.serving.resilience import CircuitOpen
from raft_tpu_torch.serving.scheduler import (PRIORITY_INTERACTIVE,
                                              BackpressureError)
from raft_tpu_torch.utils.retry import backoff_delays

# This module owns NO locks by design (a session is single-submitter by
# contract; cross-stream concurrency lives in the scheduler's queue).

#: per-session identities: the feature-cache pool's stream names and,
#: over a ModelRegistry, the sticky route tokens — one per session, fixed
#: for its lifetime, so the deterministic canary hash routes the WHOLE
#: stream to one variant (a warm-start flow_init never crosses engines
#: mid-stream)
_SESSION_IDS = itertools.count(1)


def _to_host(t) -> np.ndarray:
    """A flow held on the device (a tensor) or the host, as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class VideoSession:
    """One video stream's warm-start state.

    NOT thread-safe — a stream has one frame order; run each session
    from its own submitter (cross-stream parallelism lives in the
    scheduler's queue). ``warm_start=False`` degrades to per-pair cold
    starts (still coalesced) without touching caller code.
    """

    def __init__(self, scheduler, *, warm_start: bool = True,
                 device_state: bool = False,
                 feature_cache: bool = False,
                 deadline_s: Optional[float] = None,
                 model: Optional[str] = None,
                 priority: Optional[str] = None,
                 route_key: Optional[str] = None,
                 retry_budget: int = 0,
                 retry_base_s: float = 0.05,
                 retry_max_s: float = 2.0,
                 retry_jitter: float = 0.5,
                 retry_rng: Optional[random.Random] = None,
                 retry_sleep: Optional[Callable[[float], None]] = None):
        """``device_state=True`` keeps the recurrence state
        (``flow_low``) ON DEVICE between pairs: the scheduler returns a
        device tensor, the forward warp runs as a scatter on the device
        (ops/interp.forward_interpolate_device — holes stay zero, i.e.
        locally cold, instead of scipy's global nearest fill), and the
        next submit passes the tensor straight back — the
        per-frame D2H→H2D round trip disappears from the hot path.
        Shape-change and cold-restart paths still materialize to host
        (they reset the state to None and restart the recurrence);
        ``drain()`` always returns a host array. Default OFF: the host
        scipy path is bitwise what it always was.

        ``priority`` tags every submit (``"interactive"`` |
        ``"batch"`` | None).

        ``scheduler`` may also be a
        :class:`~raft_tpu_torch.serving.registry.ModelRegistry`:
        ``model`` then names the variant family to serve from,
        ``priority`` defaults to ``"interactive"`` (a session is a user
        waiting on frames), and the session pins a sticky ``route_key``
        so the deterministic canary hash keeps the WHOLE stream on one
        variant — warm-start state never crosses variants mid-stream,
        and a rollout that moves the stream (the ``variant_version``
        poll) cold-restarts it. Against a plain scheduler ``model`` and
        ``route_key`` raise.

        ``feature_cache=True`` (needs a scheduler/registry whose engine
        and scheduler armed the cross-frame feature cache)
        moves the WHOLE recurrence + encoder state device-side: each
        frame submits alone through ``submit_cached`` (the pair's
        first frame never re-ships or re-encodes — its features live
        in the per-stream device pool), the stream's first frame (and
        any cold restart) is a PRIME submit whose future the session
        harvests internally, and a submit-time
        ``FeatureCacheMiss`` (slot evicted/flushed/invalidated)
        cold-restarts cleanly: re-prime the previous frame, wait it
        out, resubmit the pair. ``warm_start``/``device_state`` are
        superseded (state lives pool-side); ``drain()`` returns None
        (the recurrence state never materializes to host). Rollout
        moves (the ``variant_version`` poll) and shape changes
        cold-restart BOTH the recurrence and the cache slot.

        ``retry_budget`` > 0 makes the session absorb transient
        submit-time rejections itself: a ``BackpressureError`` (full
        queue or registry admission budget) or ``CircuitOpen`` retries
        through ``utils/retry.backoff_delays`` (``retry_base_s`` /
        ``retry_max_s`` / ``retry_jitter``; ``retry_rng`` and
        ``retry_sleep`` injectable for deterministic drills), capped
        at ``retry_budget`` retries over the SESSION's lifetime — a
        stream stuck behind a persistent overload must run out, not
        hammer. Any retried pair cold-restarts the recurrence (by the
        time a retry lands, the warm state is stale by at least one
        backoff), and budget exhaustion surfaces the ORIGINAL
        exception to the caller. Default 0: rejections surface
        immediately, the historical contract."""
        self._sched = scheduler
        self.warm_start = bool(warm_start)
        self.device_state = bool(device_state)
        self.feature_cache = bool(feature_cache)
        if feature_cache and not hasattr(scheduler, "submit_cached"):
            raise ValueError(
                "feature_cache=True needs a scheduler/ModelRegistry "
                "with submit_cached (a feature_cache=True scheduler "
                "over a feature_cache=True engine)")
        self.deadline_s = deadline_s
        self._submit_kw = {}
        self._variant_version: Optional[str] = None
        if getattr(scheduler, "is_registry", False):
            self._submit_kw["route_key"] = (
                route_key if route_key is not None
                else f"session-{next(_SESSION_IDS)}")
            self._submit_kw["priority"] = (
                priority if priority is not None else PRIORITY_INTERACTIVE)
            if model is not None:
                self._submit_kw["model"] = model
        elif model is not None or route_key is not None:
            # checked before the priority branch: a plain scheduler
            # must reject these loudly whatever else is set — silently
            # dropping model= would serve the wrong model's output
            raise ValueError(
                "model=/route_key= need a ModelRegistry scheduler")
        elif priority is not None:
            self._submit_kw["priority"] = priority
        self.retry_budget = int(retry_budget)
        self.retries_used = 0
        self._retryable: tuple = ()
        if self.retry_budget > 0:
            self._retryable = (BackpressureError, CircuitOpen)
            self._mk_delays = lambda: backoff_delays(
                retry_base_s, retry_max_s, jitter=retry_jitter,
                rng=retry_rng)
            self._retry_sleep = (retry_sleep if retry_sleep is not None
                                 else time.sleep)
        self.frames = 0
        self.warm_submits = 0
        self._prev_frame: Optional[np.ndarray] = None
        self._pending = None                    # previous pair's Future
        self._flow_low = None          # numpy, or a device tensor
        #: feature-cache stream identity: ALWAYS unique per session
        #: object — pool slots are per-session recurrence state, and
        #: two sessions sharing an explicit sticky ``route_key`` must
        #: NOT share a slot (their independent frame counters would
        #: collide on seq and silently correlate one video's frame
        #: against the other's cached features)
        self._stream = f"stream-{next(_SESSION_IDS)}"
        #: request tracing (serving/trace.py): the previous submit's
        #: trace id — frame N's span links frame N−1's, so the
        #: stream's whole recurrence (primes and re-primes included)
        #: is one walkable chain. None whenever the scheduler runs
        #: untraced.
        self._last_trace: Optional[str] = None

    def _trace_parent(self):
        """Arm the next submit's parent link (tracing armed); returns
        the ledger or None."""
        tr = getattr(self._sched, "tracer", None)
        if tr is not None and self._last_trace is not None:
            tr.set_parent(self._last_trace)
        return tr

    def _trace_unparent(self):
        """Clear an armed-but-unconsumed parent link after a submit
        REJECTED before the mint (backpressure/breaker at intake) —
        a stale stamp on the thread must never chain an unrelated
        later span into this stream."""
        tr = getattr(self._sched, "tracer", None)
        if tr is not None:
            tr.set_parent(None)

    def _harvest(self) -> None:
        """Settle the previous pair — the recurrence is sequential per
        stream: pair N+1 warm-starts from pair N's flow_low. A failed
        or deadline-missed pair cold-restarts the recurrence (the
        failure already surfaced on that pair's own future)."""
        if self._pending is None:
            return
        try:
            self._flow_low = self._pending.result().flow_low
        except Exception:
            self._flow_low = None
        self._pending = None

    def submit_frame(self, frame, *,
                     deadline_s: Optional[float] = None):
        """Feed the next frame; returns the Future for the
        (previous, current) pair — None for the first frame of a
        stream (or after a mid-stream resolution change, which
        restarts the recurrence: ``flow_low`` lives in the old frame
        geometry)."""
        if self.feature_cache:
            return self._submit_frame_cached(frame, deadline_s)
        frame = np.asarray(frame, np.float32)
        self.frames += 1
        prev, self._prev_frame = self._prev_frame, frame
        if prev is None:
            return None
        if prev.shape != frame.shape:
            self._pending, self._flow_low = None, None
            return None
        if self._variant_moved():
            self._pending, self._flow_low = None, None
        flow_init = None
        if self.warm_start:
            self._harvest()
            if self._flow_low is not None and self.device_state \
                    and isinstance(self._flow_low, torch.Tensor):
                # device-resident recurrence: warp on device, feed the
                # tensor straight back — no bytes cross the PCIe/host
                # boundary between pairs. A non-finite flow scatters
                # nothing (every point fails the validity window), so
                # a garbage pair degrades to a cold start here the way
                # the host path's isfinite guard does — without a sync.
                flow_init = forward_interpolate_device(self._flow_low)
            elif self._flow_low is not None:
                flow_init = forward_interpolate(_to_host(self._flow_low))
                if not np.isfinite(flow_init).all():
                    # every forward-warped point left the frame (a
                    # garbage pair, or motion larger than the frame):
                    # griddata had nothing to interpolate from and
                    # returns NaN ('nearest' ignores fill_value) —
                    # cold-start instead of poisoning the stream
                    flow_init = None
        effective_deadline = (self.deadline_s if deadline_s is None
                              else deadline_s)
        tr = self._trace_parent()
        try:
            try:
                fut = self._sched.submit(
                    prev, frame, deadline_s=effective_deadline,
                    flow_init=flow_init, want_low=self.warm_start,
                    low_device=self.device_state, **self._submit_kw)
            except self._retryable as exc:
                fut = self._retry_submit(prev, frame,
                                         effective_deadline, exc)
            else:
                if flow_init is not None:
                    self.warm_submits += 1
        except BaseException:
            self._trace_unparent()
            raise
        self._pending = fut
        if tr is not None:
            self._last_trace = getattr(fut, "trace_id", None)
        return fut

    def _variant_moved(self) -> bool:
        """Registry rollout guard (no-op off a registry): poll the
        variant a request with this stream's sticky ``route_key``
        would serve from; True when a deploy/promote/rollback moved it
        since the last pair — warm state produced by one variant must
        never feed another model's refinement, so the caller
        cold-restarts. The first poll only establishes the baseline.
        (A change landing between this read and the submit is a
        one-pair race; the NEXT pair cold-restarts — and on the
        feature-cache path the pool's weights-version stamp backstops
        even that window.)"""
        if "route_key" not in self._submit_kw:
            return False
        ver = self._sched.variant_version(
            self._submit_kw.get("model"),
            self._submit_kw["route_key"])
        moved = (self._variant_version is not None
                 and ver != self._variant_version)
        self._variant_version = ver
        return moved

    def _harvest_cached(self) -> None:
        """Settle the previous cached dispatch (pair or prime) — its
        completion installs the pool slot the NEXT pair correlates
        against, so the wait is what makes warmth knowable. A failure
        already surfaced on that future, and the pool's seq-exact
        validity turns its missed store into a clean submit-time miss:
        nothing to reset here."""
        if self._pending is None:
            return
        try:
            self._pending.result()
        except Exception:
            pass
        self._pending = None

    def _submit_frame_cached(self, frame, deadline_s):
        """The feature-cache form of ``submit_frame``: one frame ships
        per submit; pairs correlate against the device pool's slot for
        this stream. Cold starts (first frame, shape change, rollout
        move) PRIME: the frame's features install the slot and the
        caller gets None — exactly the first-frame contract."""
        frame = np.asarray(frame, np.float32)
        self.frames += 1
        seq = self.frames
        prev, self._prev_frame = self._prev_frame, frame
        # a deploy/promote/rollback that moves this stream's variant
        # cold-restarts — the slot lives in the OLD variant's pool and
        # its features in the old weights (the pool's weights-version
        # stamp + StaleFeatureError backstop the race window)
        cold = (prev is None or prev.shape != frame.shape
                or self._variant_moved())
        effective_deadline = (self.deadline_s if deadline_s is None
                              else deadline_s)
        if cold:
            # stream (re)start: prime THIS frame — there is no pair
            # (or the recurrence must restart in the new geometry/
            # variant). Harvest the in-flight previous dispatch FIRST:
            # its completion store must not land after (and clobber)
            # the prime's fresh slot. The prime's own future is
            # harvested before the next submit; the caller gets None.
            self._harvest_cached()
            self._pending = self._cached_submit(
                frame, seq=seq, prime=True,
                deadline_s=effective_deadline)
            return None
        # pair owed: wait out the previous dispatch — its completion
        # installs this pair's first-frame features (the sequential-
        # harvest contract: per-stream order, never serializing the
        # device across streams)
        self._harvest_cached()
        fut = None
        for attempt in range(3):
            try:
                fut = self._cached_submit(
                    frame, seq=seq, prime=False,
                    deadline_s=effective_deadline)
                self.warm_submits += 1
                break
            except FeatureCacheMiss:
                # slot gone (LRU-evicted, flushed by a weight swap, or
                # a failed/expired pair left a seq hole): clean
                # cold-restart — re-prime the pair's FIRST frame, wait
                # it out, resubmit the pair against the fresh slot.
                # One extra round trip, paid only on restarts. Bounded
                # retries because under capacity starvation ANOTHER
                # stream's store can evict the fresh slot between the
                # re-prime and the resubmit probe; past the bound the
                # miss surfaces — the pool genuinely is too small for
                # the live stream population, and hammering would only
                # deepen the churn. A failed re-prime surfaces its own
                # error immediately.
                if attempt == 2:
                    raise
                self._cached_submit(
                    prev, seq=seq - 1, prime=True,
                    deadline_s=effective_deadline).result()
        self._pending = fut
        return fut

    def _cached_submit(self, frame, *, seq: int, prime: bool,
                       deadline_s):
        """One cached submit through the session's retry budget: a
        transient ``BackpressureError``/``CircuitOpen`` retries with
        jittered backoff up to the shared per-session cap, exhaustion
        re-raises the ORIGINAL rejection — the cached analog of
        ``_retry_submit``. No forced cold restart here: warmth is
        decided pool-side at dispatch, and the slot's seq/version
        validity already guards anything a backoff could stale.
        Tracing armed: every submit (pairs, primes, re-primes) links
        the stream's previous trace — a cold restart stays ON the
        chain, visible by its ``prime`` annotation, so serve_trace
        can attribute the re-prime round trip to the pair it
        delayed."""
        tr = self._trace_parent()
        try:
            fut = None
            try:
                fut = self._sched.submit_cached(
                    frame, stream=self._stream, seq=seq, prime=prime,
                    deadline_s=deadline_s, **self._submit_kw)
            except self._retryable as exc:
                delays = self._mk_delays()
                while self.retries_used < self.retry_budget:
                    self.retries_used += 1
                    self._retry_sleep(next(delays))
                    try:
                        self._trace_parent()
                        fut = self._sched.submit_cached(
                            frame, stream=self._stream, seq=seq,
                            prime=prime, deadline_s=deadline_s,
                            **self._submit_kw)
                        break
                    except self._retryable:
                        continue
                if fut is None:
                    raise exc
        except BaseException:
            self._trace_unparent()
            raise
        if tr is not None:
            self._last_trace = getattr(fut, "trace_id", None)
        return fut

    def _retry_submit(self, prev, frame,
                      deadline_s: Optional[float], original):
        """Absorb a retryable submit rejection within the session's
        retry budget: jittered backoff, then resubmit the pair COLD —
        by the time a retry lands the warm state is a backoff stale,
        and a cold row is bitwise a fresh stream start. The budget is
        per session and hard; exhaustion re-raises the ORIGINAL
        rejection (the retries' own rejections carry no new
        information)."""
        # cold-restart the recurrence: the retried pair submits with
        # no flow_init, and the NEXT pair must not warm off state from
        # before the disruption either
        self._flow_low = None
        delays = self._mk_delays()
        while self.retries_used < self.retry_budget:
            self.retries_used += 1
            self._retry_sleep(next(delays))
            try:
                self._trace_parent()  # the retried (cold) pair stays
                #                       on the stream's trace chain
                return self._sched.submit(
                    prev, frame, deadline_s=deadline_s,
                    flow_init=None, want_low=self.warm_start,
                    low_device=self.device_state, **self._submit_kw)
            except self._retryable:
                continue
        raise original

    def drain(self) -> Optional[np.ndarray]:
        """Wait out the last pair; returns the stream's final
        ``flow_low`` (None if the stream is cold) — always materialized
        to host, whatever ``device_state`` says. On the feature-cache
        path it also releases the stream's pool slot (a finished
        stream's device arrays must not occupy capacity live streams
        need) and returns None (state never materialized to host)."""
        if self.feature_cache:
            self._harvest_cached()
            inv = getattr(self._sched, "invalidate_stream", None)
            if inv is not None:
                if "route_key" in self._submit_kw:
                    inv(self._stream,
                        model=self._submit_kw.get("model"),
                        route_key=self._submit_kw["route_key"])
                else:
                    inv(self._stream)
            return None
        self._harvest()
        if self._flow_low is not None:
            self._flow_low = _to_host(self._flow_low)
        return self._flow_low
