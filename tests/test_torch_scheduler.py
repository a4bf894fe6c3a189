"""The port's serving front end (``raft_tpu_torch.serving.scheduler``) on
its behaviour: backpressure and deadlines, the dispatch watchdog and the
breakers, ``pipeline_depth=2`` accounting and result routing, ragged
coalescing, priority classes, no leaked threads after ``close``, the
fault sites, and the engine's capture site held outside every lock — the
JAX package's scheduler tests (``tests/test_scheduler.py``,
``tests/test_registry.py::TestPriorityClasses``,
``tests/test_ragged.py::TestRaggedScheduler``) ported onto the port's
``_FakeEngine`` and its CPU engine.

These run beside the JAX suite under ``-n 6``, so no assertion rests on a
wall-clock margin: a hang is an event the test releases, every wait is
bounded (``result(timeout=...)``, joins with timeouts), and the watchdog's
deadline is only ever raced against a hang that cannot end before it.
"""

import random
import threading
import time
import types

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.serving import (PRIORITY_BATCH, PRIORITY_INTERACTIVE,
                                    BackpressureError, CircuitOpen,
                                    DeadlineExceeded, DispatchWedged,
                                    MicroBatchScheduler, RAFTEngine,
                                    SchedulerClosed, VideoSession)
from raft_tpu_torch.serving.feature_cache import FeatureCacheMiss
from raft_tpu_torch.testing import faults

WAIT = 30.0          # every bounded wait; never reached when things work


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    faults.disarm()


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def _pair(rng, h=32, w=32):
    return (rng.rand(h, w, 3).astype(np.float32) * 255,
            rng.rand(h, w, 3).astype(np.float32) * 255)


def _pad8(x):
    return -(-x // 8) * 8


def _identity(snap):
    return snap["submitted"] == (snap["completed"] + snap["failed"]
                                 + snap["deadline_missed"]
                                 + snap["cancelled"])


def _no_leaked_workers(before, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t not in before and t.is_alive()
                  and t.name.startswith("MicroBatchScheduler")]
        if not leaked:
            return []
        time.sleep(0.02)
    return leaked


class _FakePending:
    """The fake's PendingBatch: ``fetch`` blocks while the engine's
    ``fetch_gate`` is closed (the device compute the host waits for)."""

    def __init__(self, eng, i1, bucket):
        self._eng = eng
        self._i1 = i1
        self.bucket = bucket
        self.h2d_bytes = int(i1.nbytes) * 2
        self.t_ready = None

    def fetch(self):
        faults.fault_point("serve.fetch")
        assert self._eng.fetch_gate.wait(WAIT)
        if tuple(self._i1.shape[1:3]) in self._eng.fail_fetch_shapes:
            raise RuntimeError("fetch error")
        # each row's flow carries its own frame's first pixel: result
        # routing across batches and the completion stage is checkable
        out = np.broadcast_to(self._i1[:, :1, :1, :2],
                              self._i1.shape[:3] + (2,)).astype(np.float32)
        self.t_ready = time.monotonic()
        return out


class _FakeEngine:
    """Duck-typed engine with the scheduler-facing surface
    (capacity/route/ensure/drop/_compiled + the async dispatch split), of
    the plain kind only.
    Hangs are events: ``gates[(h, w)]`` blocks that shape's dispatch until
    the test sets it."""

    warm_start = False

    def __init__(self):
        self._compiled = {}
        self.gates = {}
        self.fail_shapes = set()
        self.fail_fetch_shapes = set()
        self.fetch_gate = threading.Event()
        self.fetch_gate.set()
        self.calls = []
        self.ensure_gate = {}

    def bucket_capacity(self, h, w, kind="plain"):
        fits = [s[0] for s in self._compiled
                if s[1] == _pad8(h) and s[2] == _pad8(w)]
        return max(fits) if fits else None

    def ensure_bucket(self, b, h, w, kind="plain"):
        gate = self.ensure_gate.get((h, w))
        if gate is not None:
            gate.wait(WAIT)
        shape = (b, _pad8(h), _pad8(w))
        self._compiled[shape] = object()
        return shape

    def route_bucket(self, b, h, w, kind="plain"):
        return (self.bucket_capacity(h, w) or b, _pad8(h), _pad8(w))

    def drop_bucket(self, shape, kind="plain"):
        return self._compiled.pop(shape, None) is not None

    def infer_batch_async(self, i1, i2, **kw):
        key = tuple(i1.shape[1:3])
        self.calls.append(key)
        gate = self.gates.get(key)
        if gate is not None:
            gate.wait(WAIT)
        if key in self.fail_shapes:
            raise RuntimeError(f"device error at {key}")
        return _FakePending(self, i1, self.route_bucket(i1.shape[0], *key))


def _frame(value, h=32, w=32):
    return np.full((h, w, 3), value, np.float32)


def _watchdog(eng, **kw):
    kw.setdefault("gather_window_s", 0.0)
    kw.setdefault("max_batch", 2)
    kw.setdefault("dispatch_timeout_s", 1.0)
    kw.setdefault("breaker_failures", 1)
    kw.setdefault("breaker_backoff_s", 0.05)
    kw.setdefault("breaker_backoff_max_s", 0.05)
    kw.setdefault("breaker_rng", random.Random(0))
    return MicroBatchScheduler(eng, **kw)


def _retry_until_served(sched, h=32, w=32, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return sched.submit(_frame(1, h, w), _frame(2, h, w)).result(
                timeout=timeout)
        except (CircuitOpen, DispatchWedged):
            time.sleep(0.02)
    return None


# -- backpressure, deadlines, drain -----------------------------------------

def test_full_queue_sheds_new_never_inflight():
    eng = _FakeEngine()
    eng.gates[(32, 32)] = gate = threading.Event()
    sched = MicroBatchScheduler(eng, max_queue=3, max_batch=1,
                                gather_window_s=0.0)
    first = sched.submit(_frame(0), _frame(0))      # dispatched, blocked
    assert _wait(lambda: eng.calls)
    queued = [sched.submit(_frame(k), _frame(k)) for k in range(1, 4)]
    with pytest.raises(BackpressureError, match="queue full"):
        sched.submit(_frame(9), _frame(9))
    gate.set()
    for k, f in enumerate([first] + queued):
        assert f.result(timeout=WAIT).flow[0, 0, 0] == k
    sched.close(drain=True)
    snap = sched.metrics.snapshot()
    assert snap["shed"] == 1 and snap["completed"] == 4 and _identity(snap)


def _wait(pred, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


def test_queued_deadline_expires_inflight_completes():
    eng = _FakeEngine()
    eng.gates[(32, 32)] = gate = threading.Event()
    sched = MicroBatchScheduler(eng, max_batch=1, gather_window_s=0.0)
    # a deadline that cannot pass: under CPU load the dispatcher may take
    # over 10 ms to pick a request up, and a 10 ms deadline then expired
    # this one in the queue, before it was ever in flight
    inflight = sched.submit(_frame(0), _frame(0), deadline_s=3600.0)
    assert _wait(lambda: eng.calls)
    doomed = sched.submit(_frame(1), _frame(1), deadline_s=0.01)
    time.sleep(0.05)
    # submit is an expiry edge: the expired queued request fails now,
    # while the blocked dispatch is still out
    sched.submit(_frame(2), _frame(2))
    assert isinstance(doomed.exception(timeout=WAIT), DeadlineExceeded)
    assert not inflight.done()
    gate.set()
    assert inflight.result(timeout=WAIT).flow.shape == (32, 32, 2)
    sched.close(drain=True)
    snap = sched.metrics.snapshot()
    assert snap["deadline_missed"] == 1 and snap["abandoned_inflight"] == 0
    assert _identity(snap)


def test_deadline_fires_from_the_watchdog_while_dispatch_inflight():
    eng = _FakeEngine()
    eng.gates[(32, 32)] = gate = threading.Event()
    sched = _watchdog(eng, dispatch_timeout_s=WAIT, breaker_failures=0)
    first = sched.submit(_frame(0), _frame(0))
    assert _wait(lambda: eng.calls)
    late = sched.submit(_frame(1), _frame(1), deadline_s=0.02)
    # no further submit: the supervision loop's scan is the edge
    assert isinstance(late.exception(timeout=WAIT), DeadlineExceeded)
    assert not first.done()
    gate.set()
    assert first.result(timeout=WAIT).flow.shape == (32, 32, 2)
    sched.close(drain=True)
    assert _identity(sched.metrics.snapshot())


def test_no_drain_close_fails_pending_loudly():
    eng = _FakeEngine()
    eng.gates[(32, 32)] = gate = threading.Event()
    sched = MicroBatchScheduler(eng, max_batch=1, gather_window_s=0.0)
    blocker = sched.submit(_frame(0), _frame(0))
    assert _wait(lambda: eng.calls)
    queued = [sched.submit(_frame(k), _frame(k)) for k in (1, 2)]
    threading.Timer(0.05, gate.set).start()
    sched.close(drain=False)
    assert blocker.result(timeout=WAIT).flow.shape == (32, 32, 2)
    for q in queued:
        with pytest.raises(SchedulerClosed):
            q.result(timeout=WAIT)
    with pytest.raises(SchedulerClosed):
        sched.submit(_frame(3), _frame(3))
    assert _identity(sched.metrics.snapshot())


def test_submit_validates_inputs(rng):
    sched = MicroBatchScheduler(_FakeEngine(), gather_window_s=0.0)
    with pytest.raises(ValueError, match="one \\(H, W, 3\\) frame pair"):
        sched.submit(np.zeros((1, 32, 32, 3)), np.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="frame shapes differ"):
        sched.submit(np.zeros((32, 32, 3)), np.zeros((32, 40, 3)))
    with pytest.raises(ValueError, match="warm_start"):
        sched.submit(*_pair(rng), want_low=True)
    with pytest.raises(ValueError, match="priority"):
        sched.submit(*_pair(rng), priority="realtime")
    with pytest.raises(ValueError, match="feature_cache"):
        sched.submit_cached(np.zeros((32, 32, 3)), stream="s", seq=1)
    sched.close()


# -- watchdog, breakers, recovery -------------------------------------------

def test_wedge_fails_futures_and_recovers():
    before = set(threading.enumerate())
    eng = _FakeEngine()
    eng.gates[(32, 32)] = gate = threading.Event()
    sched = _watchdog(eng, dispatch_timeout_s=1.0)
    fut = sched.submit(_frame(0), _frame(0))
    with pytest.raises(DispatchWedged, match="dispatch_timeout_s"):
        fut.result(timeout=WAIT)
    # consequences landed before the future failed
    assert (2, 32, 32) not in eng._compiled
    h = sched.health()
    assert h["state"] == "degraded" and h["quarantined_threads"] == 1
    assert h["buckets"]["32x32"]["state"] in ("open", "half_open")
    assert h["buckets"]["32x32"]["wedges"] == 1
    # the healthy shape keeps serving while 32x32 is open
    ok = sched.submit(_frame(5, 40, 40), _frame(5, 40, 40))
    assert ok.result(timeout=WAIT).flow.shape == (40, 40, 2)
    del eng.gates[(32, 32)]
    assert _retry_until_served(sched) is not None    # the half-open probe
    assert (2, 32, 32) in eng._compiled
    assert _wait(lambda: sched.health()["state"] == "healthy")
    gate.set()                  # the quarantined thread's hang ends
    sched.close(drain=True)
    snap = sched.metrics.snapshot()
    res = snap["resilience"]
    assert res["wedged"] == 1 and res["quarantined_threads"] == 1
    assert res["breaker_transitions"]["open"] >= 1
    assert res["breaker_transitions"]["closed"] >= 1
    assert snap["abandoned_inflight"] == 0 and _identity(snap)
    assert not _no_leaked_workers(before)


def test_open_breaker_fails_submits_and_queued_work_fast():
    eng = _FakeEngine()
    eng.gates[(32, 32)] = gate = threading.Event()
    sched = _watchdog(eng, dispatch_timeout_s=1.0, breaker_backoff_s=WAIT,
                      breaker_backoff_max_s=WAIT, max_batch=1)
    wedged = sched.submit(_frame(0), _frame(0))
    assert _wait(lambda: eng.calls)
    queued = [sched.submit(_frame(k), _frame(k)) for k in (1, 2, 3)]
    with pytest.raises(DispatchWedged):
        wedged.result(timeout=WAIT)
    for q in queued:
        with pytest.raises(CircuitOpen):
            q.result(timeout=WAIT)
    with pytest.raises(CircuitOpen, match="failing fast"):
        sched.submit(_frame(4), _frame(4))
    assert sched.metrics.circuit_rejected == 1
    gate.set()
    sched.close(drain=True)
    snap = sched.metrics.snapshot()
    assert snap["failed"] == 4 and _identity(snap)


def test_wedged_capacity_probe_fails_the_shapes_requests():
    eng = _FakeEngine()
    eng.ensure_gate[(32, 32)] = gate = threading.Event()
    sched = _watchdog(eng, dispatch_timeout_s=1.0)
    fut = sched.submit(_frame(0), _frame(0))
    with pytest.raises(DispatchWedged):
        fut.result(timeout=WAIT)
    gate.set()
    sched.close(drain=True)
    assert _identity(sched.metrics.snapshot())


def test_device_error_fails_its_batch_not_the_worker():
    eng = _FakeEngine()
    eng.fail_shapes.add((32, 32))
    sched = MicroBatchScheduler(eng, gather_window_s=0.0, breaker_failures=5)
    with pytest.raises(RuntimeError, match="device error"):
        sched.submit(_frame(0), _frame(0)).result(timeout=WAIT)
    ok = sched.submit(_frame(1, 40, 40), _frame(1, 40, 40))
    assert ok.result(timeout=WAIT).flow.shape == (40, 40, 2)
    assert sched.health()["worker_alive"]
    sched.close()
    assert _identity(sched.metrics.snapshot())


# -- pipelined dispatch -----------------------------------------------------

def test_depth2_accounting_and_result_routing():
    eng = _FakeEngine()
    eng.fetch_gate.clear()
    sched = MicroBatchScheduler(eng, max_batch=2, gather_window_s=0.0,
                                pipeline_depth=2)
    shapes = [(32, 32), (40, 40)]
    futs = [sched.submit(_frame(k, *shapes[k % 2]), _frame(k, *shapes[k % 2]))
            for k in range(8)]
    # two batches go out while the device (the fetch gate) is held: the
    # second shipped while the first was in flight
    assert _wait(lambda: len(eng.calls) >= 2)
    assert sched.health()["pending_completions"] == 2
    eng.fetch_gate.set()
    for k, f in enumerate(futs):
        res = f.result(timeout=WAIT)
        assert res.flow.shape == shapes[k % 2] + (2,)
        assert res.flow[0, 0, 0] == k        # each future, its own pair
    h = sched.health()
    assert h["completion_worker_alive"] is True
    sched.close(drain=True)
    snap = sched.metrics.snapshot()
    assert snap["completed"] == 8 and _identity(snap)
    assert snap["abandoned_inflight"] == 0
    hot = snap["hot_path"]
    assert hot["h2d_bytes_per_req"] > 0 and hot["dispatch_gap"]["count"] >= 1
    # the second dispatch shipped before the first's results were ready:
    # a gap of 0, binned in the ladder's first bucket
    assert hot["dispatch_gap"]["counts"][0] >= 1
    assert 0.0 < hot["assembly"]["overlap_ratio"] <= 1.0


def _releasable_hangs(monkeypatch):
    """Make a fault plan's ``hang`` wait on an event the test sets."""
    release = threading.Event()
    monkeypatch.setattr(faults, "time", types.SimpleNamespace(
        sleep=lambda s: release.wait(s)))
    return release


def test_depth2_completion_wedge_requeues_the_trailing_batches(
        monkeypatch):
    release = _releasable_hangs(monkeypatch)
    eng = _FakeEngine()
    eng.ensure_bucket(1, 32, 32)
    eng.ensure_bucket(1, 40, 40)
    faults.arm([{"site": "serve.fetch", "kind": "hang", "hang_s": WAIT,
                 "count": 1}])
    sched = _watchdog(eng, max_batch=1, dispatch_timeout_s=1.0,
                      pipeline_depth=3)
    try:
        doomed = sched.submit(_frame(0), _frame(0))
        ok = [sched.submit(_frame(k, 40, 40), _frame(k, 40, 40))
              for k in (1, 2)]
        with pytest.raises(DispatchWedged):
            doomed.result(timeout=WAIT)
        for k, f in zip((1, 2), ok):
            assert f.result(timeout=WAIT).flow[0, 0, 0] == k
    finally:
        faults.disarm()
        release.set()
        sched.close(drain=True)
    snap = sched.metrics.snapshot()
    assert snap["completed"] == 2 and snap["failed"] == 1 and _identity(snap)
    assert (1, 32, 32) not in eng._compiled      # the suspect was dropped


def test_depth2_fetch_error_fails_its_batch():
    eng = _FakeEngine()
    eng.fail_fetch_shapes.add((32, 32))
    sched = MicroBatchScheduler(eng, gather_window_s=0.0, pipeline_depth=2,
                                breaker_failures=3)
    with pytest.raises(RuntimeError, match="fetch error"):
        sched.submit(_frame(0), _frame(0)).result(timeout=WAIT)
    assert sched.submit(_frame(1, 40, 40), _frame(1, 40, 40)).result(
        timeout=WAIT).flow.shape == (40, 40, 2)
    sched.close()
    assert _identity(sched.metrics.snapshot())


# -- priority classes -------------------------------------------------------

def test_shed_batch_first_under_backpressure():
    eng = _FakeEngine()
    eng.gates[(32, 32)] = gate = threading.Event()
    s = MicroBatchScheduler(eng, max_queue=4, max_batch=1,
                            gather_window_s=0.0)
    first = s.submit(_frame(0), _frame(0), priority=PRIORITY_BATCH)
    assert _wait(lambda: eng.calls)
    bat = [s.submit(_frame(k), _frame(k), priority=PRIORITY_BATCH)
           for k in range(1, 5)]
    with pytest.raises(BackpressureError):
        s.submit(_frame(5), _frame(5), priority=PRIORITY_BATCH)
    inter = [s.submit(_frame(k), _frame(k), priority=PRIORITY_INTERACTIVE)
             for k in (6, 7)]
    # the two NEWEST queued batch entries gave up their slots
    for f in bat[2:]:
        with pytest.raises(BackpressureError, match="shed by an "
                                                    "interactive"):
            f.result(timeout=WAIT)
    gate.set()
    for f in [first] + bat[:2] + inter:
        f.result(timeout=WAIT)
    s.close()
    snap = s.metrics.snapshot()
    assert snap["evicted"] == 2
    p = snap["priority"]
    assert p[PRIORITY_INTERACTIVE]["shed"] == 0
    assert p[PRIORITY_INTERACTIVE]["completed"] == 2
    assert p[PRIORITY_BATCH]["shed"] == 3 and _identity(snap)


def test_priority_less_queue_never_evicts():
    eng = _FakeEngine()
    eng.gates[(32, 32)] = gate = threading.Event()
    s = MicroBatchScheduler(eng, max_queue=2, max_batch=1,
                            gather_window_s=0.0)
    futs = [s.submit(_frame(0), _frame(0))]
    assert _wait(lambda: eng.calls)
    futs += [s.submit(_frame(k), _frame(k)) for k in (1, 2)]
    with pytest.raises(BackpressureError):
        s.submit(_frame(3), _frame(3))
    gate.set()
    s.close()
    assert all(f.exception(timeout=WAIT) is None for f in futs)
    snap = s.metrics.snapshot()
    assert snap["evicted"] == 0 and snap["priority"] == {}


def test_weighted_dequeue_pulls_interactive_ahead():
    eng = _FakeEngine()
    eng.gates[(32, 32)] = gate = threading.Event()
    s = MicroBatchScheduler(eng, max_queue=64, max_batch=1,
                            gather_window_s=0.0, interactive_weight=4)
    order = []
    lock = threading.Lock()

    def tag(name):
        def cb(_):
            with lock:
                order.append(name)
        return cb

    s.submit(_frame(0), _frame(0), priority=PRIORITY_BATCH
             ).add_done_callback(tag("b0"))
    assert _wait(lambda: eng.calls)        # b0 holds the worker
    for i in range(1, 10):
        s.submit(_frame(i), _frame(i), priority=PRIORITY_BATCH
                 ).add_done_callback(tag(f"b{i}"))
    for i in range(4):
        s.submit(_frame(i), _frame(i), priority=PRIORITY_INTERACTIVE
                 ).add_done_callback(tag(f"i{i}"))
    gate.set()
    s.close()
    assert len(order) == 14
    # with both classes queued: four interactive picks per batch pick
    assert order[:6] == ["b0", "i0", "i1", "i2", "i3", "b1"], order


# -- lifecycle and fault sites ----------------------------------------------

def test_no_leaked_threads_after_close():
    before = set(threading.enumerate())
    for kw in ({}, {"dispatch_timeout_s": 5.0}, {"pipeline_depth": 2},
               {"dispatch_timeout_s": 5.0, "pipeline_depth": 2}):
        with MicroBatchScheduler(_FakeEngine(), gather_window_s=0.0,
                                 **kw) as s:
            s.submit(_frame(1), _frame(1)).result(timeout=WAIT)
    assert not _no_leaked_workers(before)


@pytest.mark.parametrize("depth", [1, 2])
def test_serve_request_raise_fails_batch_not_worker(depth):
    eng = _FakeEngine()
    faults.arm([{"site": "serve.request", "kind": "raise", "count": 1}])
    sched = MicroBatchScheduler(eng, gather_window_s=0.0,
                                pipeline_depth=depth)
    with pytest.raises(faults.FaultInjected):
        sched.submit(_frame(0), _frame(0)).result(timeout=WAIT)
    assert sched.submit(_frame(1), _frame(1)).result(
        timeout=WAIT).flow[0, 0, 0] == 1
    sched.close()
    assert eng.calls == [(32, 32)]       # the raise fired before the engine
    assert _identity(sched.metrics.snapshot())


def test_scheduler_swap_site_fires_before_the_engine():
    eng = _FakeEngine()
    eng.swaps = []
    eng.update_weights = eng.swaps.append
    sched = MicroBatchScheduler(eng, gather_window_s=0.0)
    faults.arm([{"site": "scheduler.swap", "kind": "raise", "count": 1}])
    with pytest.raises(faults.FaultInjected):
        sched.update_weights("w1")
    assert eng.swaps == []
    sched.update_weights("w2")
    assert eng.swaps == ["w2"]
    sched.close()


# -- the CPU engine under the scheduler --------------------------------------

SMALL = RAFTConfig(small=True)


@pytest.fixture(scope="module")
def model():
    return RAFT(SMALL, torch.Generator().manual_seed(0)).eval()


def test_hung_capture_blocks_no_other_shape(model, monkeypatch):
    """A ``hang`` at ``engine.compile`` for shape A: the watchdog wedges
    A's dispatch and quarantines its thread, shape B still captures and
    serves meanwhile, and once disarmed A's half-open probe recaptures
    and serves. (The engine fires the site outside its capture lock; the
    hang is released by the test, not by a clock.)"""
    release = _releasable_hangs(monkeypatch)
    eng = RAFTEngine(model, SMALL, iters=1, envelope=[], warm_start=True,
                     device="cpu")
    sched = _watchdog(eng, dispatch_timeout_s=3.0, max_batch=1)
    faults.arm([{"site": "engine.compile", "kind": "hang", "count": 1,
                 "hang_s": WAIT}])
    try:
        a = sched.submit(_frame(3), _frame(4))
        with pytest.raises(DispatchWedged):
            a.result(timeout=WAIT)
        b = sched.submit(_frame(3, 24, 40), _frame(4, 24, 40))
        assert b.result(timeout=WAIT).flow.shape == (24, 40, 2)
        assert (1, 24, 40) in eng.bucket_shapes()
        faults.disarm()
        res = _retry_until_served(sched)
        assert res is not None and res.flow.shape == (32, 32, 2)
        assert (1, 32, 32) in eng.bucket_shapes()
        assert eng.capture_count == 2
        assert _wait(lambda: sched.health()["state"] == "healthy")
    finally:
        release.set()
        sched.close(drain=True)
    snap = sched.metrics.snapshot()
    assert snap["resilience"]["wedged"] == 1 and _identity(snap)


def test_ragged_scheduler_coalesces_across_shapes(model):
    eng = RAFTEngine(model, SMALL, iters=1, warm_start=True, ragged=True,
                     capacity_classes=[(2, 32, 40)], device="cpu")
    shapes = [(32, 32), (24, 40), (32, 40), (24, 24)]
    with MicroBatchScheduler(eng, max_batch=2, gather_window_s=0.0,
                             ragged=True) as sched:
        eng_gate = threading.Event()
        real = eng.infer_ragged_async

        def gated(*a, **kw):
            eng_gate.wait(WAIT)
            return real(*a, **kw)

        eng.infer_ragged_async = gated
        futs = [sched.submit(_frame(k, h, w), _frame(k + 1, h, w),
                             want_low=True)
                for k, (h, w) in enumerate(shapes)]
        eng_gate.set()
        res = [f.result(timeout=WAIT) for f in futs]
        rec = sched.metrics.snapshot(executables=eng.executable_count())
    assert [r.flow.shape[:2] for r in res] == shapes
    assert all(r.flow_low is not None for r in res)
    assert rec["executables"] == 1 and _identity(rec)
    assert rec["ragged"]["cross_shape_dispatches"] > 0
    assert "2x32x40/ragged" in rec["buckets"]
    assert eng.ragged_classes() == [(2, 32, 40)]


def _kind_engine(model, kind):
    """A CPU engine holding a (1, 32, 32) program of ``kind`` beside one
    of a sibling kind at the same shape: a ragged engine's capacity class
    beside its plain bucket, a feature-cache engine's cached and plain
    buckets."""
    if kind == "ragged":
        return RAFTEngine(model, SMALL, iters=1, envelope=[(1, 32, 32)],
                          ragged=True, capacity_classes=[(1, 32, 32)],
                          device="cpu")
    return RAFTEngine(model, SMALL, iters=1, envelope=[(1, 32, 32)],
                      warm_start=True, feature_cache=True, device="cpu")


@pytest.mark.parametrize("site", ["serve.request", "serve.fetch"])
@pytest.mark.parametrize("kind", ["plain", "ragged", "cached"])
def test_wedge_drops_only_its_kinds_program(model, monkeypatch, kind, site):
    """A wedged dispatch (``serve.request``) and a wedged completion
    (``serve.fetch``) at ``pipeline_depth=2``: the verdict drops the
    program from the table of the batch's kind, leaves the sibling kind's
    program at the same shape, and counts the wedge on the kind's breaker
    label."""
    release = _releasable_hangs(monkeypatch)
    eng = _kind_engine(model, kind)
    before = eng.tables()
    sched = _watchdog(eng, max_batch=1, dispatch_timeout_s=3.0,
                      pipeline_depth=2, ragged=kind == "ragged",
                      feature_cache=kind == "cached")
    faults.arm([{"site": site, "kind": "hang", "count": 1, "hang_s": WAIT}])
    try:
        if kind == "cached":
            fut = sched.submit_cached(_frame(3), stream="s", seq=0,
                                      prime=True)
        else:
            fut = sched.submit(_frame(3), _frame(4))
        with pytest.raises(DispatchWedged):
            fut.result(timeout=WAIT)
        tables = eng.tables()
        health = sched.health()
    finally:
        faults.disarm()
        release.set()
        sched.close(drain=True)
    assert tables == {k: [e for e in v if k != kind]
                      for k, v in before.items()}
    assert before[kind] == [((1, 32, 32), True)]
    label = {"plain": "32x32", "ragged": "32x32/ragged",
             "cached": "32x32/cache"}[kind]
    assert health["buckets"][label]["wedges"] == 1
    assert _identity(sched.metrics.snapshot())


def test_feature_cache_session_and_miss(model):
    eng = RAFTEngine(model, SMALL, iters=1, envelope=[(1, 32, 32)],
                     warm_start=True, feature_cache=True, device="cpu")
    with MicroBatchScheduler(eng, max_batch=1, gather_window_s=0.0,
                             feature_cache=True,
                             feature_cache_capacity=2) as sched:
        with pytest.raises(FeatureCacheMiss):
            sched.submit_cached(_frame(1), stream="cold", seq=2)
        sess = VideoSession(sched, feature_cache=True)
        futs = [sess.submit_frame(_frame(k)) for k in range(4)]
        assert futs[0] is None
        flows = [f.result(timeout=WAIT).flow for f in futs[1:]]
        assert all(f.shape == (32, 32, 2) for f in flows)
        assert sess.warm_submits == 3 and sess.drain() is None
        snap = sched.metrics.snapshot()
        fc = snap["feature_cache"]
        assert fc["hits"] == 3 and fc["occupancy"] == 0
        # each slot held its own clone, never a view of the batch output
        sched.submit_cached(_frame(1), stream="s", seq=1,
                            prime=True).result(timeout=WAIT)
        slot = sched._fcache.acquire("s", (32, 32), 1, eng.weights_version)
        assert slot.fmap.is_contiguous() and slot.fmap.shape == (4, 4, 128)
        assert slot.fmap.untyped_storage().nbytes() == slot.fmap.nbytes
    assert _identity(snap)
