"""The serving front end's host units in the port (``raft_tpu_torch.serving``
futures, metrics, trace, schema, resilience, feature_cache, and
``parallel.placement``) against ``raft_tpu``'s in the same process.

Each scenario runs on both packages' modules: the port must pass the JAX
package's own unit assertions (``tests/test_scheduler.py``
``TestCircuitBreakerUnit``/``TestServingMetricsUnit``/``TestSettleFuture``,
``tests/test_trace.py::TestLedgerUnits``,
``tests/test_feature_cache.py::TestFeatureCachePool``) and give the same
records, counters and snapshots. Every record the port writes must pass
BOTH packages' ``validate_record``. Clocks are injected; nothing here waits
on wall time.
"""

import importlib
import json
import os
import threading
from concurrent.futures import Future

import pytest

from raft_tpu_torch.testing import faults as tfaults

PACKAGES = ("raft_tpu", "raft_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(name):
    return [mod(p, name) for p in PACKAGES]


def _lines(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _untimed(rec):
    """A record without its wall-clock fields."""
    if isinstance(rec, dict):
        return {k: _untimed(v) for k, v in rec.items()
                if k not in ("time", "total_ms", "phases", "started",
                             "observed_ms")}
    if isinstance(rec, list):
        return [_untimed(v) for v in rec]
    return rec


def _valid_in_both(records):
    for schema in both("serving.schema"):
        assert schema.validate_lines(records) == [], schema.__name__


# -- settle_future -----------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_settle_future_contract(pkg):
    settle_future = mod(pkg, "serving.futures").settle_future
    fut = Future()
    assert settle_future(fut, 41) is True and fut.result(timeout=0) == 41
    fut = Future()
    assert settle_future(fut, RuntimeError("boom")) is True
    assert isinstance(fut.exception(timeout=0), RuntimeError)
    fut = Future()   # a class is a result, only instances fail
    assert settle_future(fut, RuntimeError) is True
    assert fut.result(timeout=0) is RuntimeError
    calls = []
    fut = Future()
    fut.set_result("winner")
    assert settle_future(fut, "loser", raced=lambda: calls.append(1)) is False
    assert calls == [1] and fut.result(timeout=0) == "winner"
    fut = Future()
    assert fut.cancel()
    assert settle_future(fut, RuntimeError("late"),
                         raced=lambda: calls.append(2)) is False
    assert calls == [1, 2]


# -- circuit breaker ---------------------------------------------------------

def _breaker_trace(res):
    t = [0.0]
    seen = []
    br = res.CircuitBreaker(failures=2, base_s=10.0, max_s=40.0, jitter=0.0,
                            clock=lambda: t[0],
                            on_transition=lambda o, n: seen.append((o, n)))
    states = [br.state()]
    br.record_failure()
    states.append(br.state())
    br.record_failure(wedged=True)
    states += [br.peek(), br.opens, br.wedges, br.snapshot()]
    t[0] = 9.9
    states.append(br.peek())
    t[0] = 10.1
    states += [br.peek(), list(seen), br.state()]
    br.record_failure()
    states += [br.peek(), br.opens]
    t[0] = 10.1 + 19.9
    states.append(br.peek())
    t[0] = 10.1 + 20.1
    states.append(br.state())
    br.record_success()
    states += [br.state(), br.consecutive]
    br.record_failure()
    br.record_failure()
    states.append(br.snapshot())
    return states, seen


def test_circuit_breaker_round_trip_matches_jax():
    (jax_states, jax_seen), (states, seen) = (
        _breaker_trace(r) for r in both("serving.resilience"))
    assert states == jax_states
    assert seen == jax_seen == [("closed", "open"), ("open", "half_open"),
                                ("half_open", "open"), ("open", "half_open"),
                                ("half_open", "closed"), ("closed", "open")]
    assert states[0] == "closed" and states[1] == "closed"
    assert states[2] == "open" and states[5]["retry_in_s"] == 10.0
    assert states[7] == "half_open" and states[9] == "half_open"
    assert states[-1]["retry_in_s"] == 10.0   # recovery resets the series


@pytest.mark.parametrize("seed", [0, 7])
def test_circuit_breaker_jittered_backoff_matches_jax(seed):
    import random

    def opens(res):
        t = [0.0]
        br = res.CircuitBreaker(failures=1, base_s=0.25, max_s=30.0,
                                rng=random.Random(seed), clock=lambda: t[0])
        out = []
        for _ in range(6):
            br.record_failure()
            out.append(br.snapshot()["retry_in_s"])
            t[0] += 100.0
            assert br.state() == "half_open"
        return out

    a, b = (opens(r) for r in both("serving.resilience"))
    assert a == b and len(set(a)) == 6


def test_circuit_breaker_validation_and_reset():
    res = mod("raft_tpu_torch", "serving.resilience")
    with pytest.raises(ValueError, match="failures"):
        res.CircuitBreaker(failures=0)
    br = res.CircuitBreaker(failures=3)
    for ok in (False, False, True, False, False):
        br.record_success() if ok else br.record_failure()
    assert br.state() == "closed"   # never 3 consecutive


def test_dispatch_executor_quarantine_and_replace():
    """A stuck worker is abandoned and replaced; the replacement runs the
    next job; close joins the live worker (bounded waits only)."""
    res = mod("raft_tpu_torch", "serving.resilience")
    release = threading.Event()
    ex = res.DispatchExecutor("unit-exec")
    stuck = ex.submit(lambda j: release.wait(30))
    assert not stuck.done.wait(0.05)
    assert ex.quarantine_and_replace() == 1
    ran = ex.submit(lambda j: setattr(j, "outcome", "ok"))
    assert ran.done.wait(10) and ran.outcome == "ok"
    assert ex.quarantined_alive() == 1 and ex.worker_alive()
    release.set()
    assert stuck.done.wait(10)
    assert ex.close(10)
    for t in ex.quarantined:
        t.join(10)
    assert ex.quarantined_alive() == 0


def test_dispatch_exec_fault_site_fires_in_the_executor_loop():
    res = mod("raft_tpu_torch", "serving.resilience")
    tfaults.arm([{"site": "serve.dispatch_exec", "kind": "raise"}])
    try:
        ex = res.DispatchExecutor("unit-fault")
        job = ex.submit(lambda j: setattr(j, "outcome", "ran"))
        assert job.done.wait(10)
        assert isinstance(job.error, tfaults.FaultInjected)
        assert job.outcome is None      # the site fires before the job
        ok = ex.submit(lambda j: setattr(j, "outcome", "ran"))
        assert ok.done.wait(10) and ok.outcome == "ran"
        assert ex.close(10)
    finally:
        tfaults.disarm()


# -- serving metrics ---------------------------------------------------------

def _metrics_records(metrics, tmp):
    path = str(tmp / "metrics.jsonl")
    m = metrics.ServingMetrics(path)
    for d in (1, 2):
        m.record_submit(depth=d)
    m.record_submit(depth=1, priority="interactive")
    m.record_dispatch("3x32x32", filled=2, capacity=3, depth=0,
                      real_px=2 * 30 * 30, padded_px=3 * 32 * 32)
    m.record_dispatch("4x64x64/ragged", filled=3, capacity=4, depth=1,
                      real_px=3000, padded_px=4 * 64 * 64, ragged=True,
                      cross_shape=True)
    m.record_complete("3x32x32", queue_ms=1.0, device_ms=2.0)
    m.record_complete("3x32x32", queue_ms=4.0, device_ms=2.0,
                      priority="interactive", trace_id="r-1")
    m.record_hot_path(gap_ms=None, assembly_ms=1.5, overlapped=False,
                      h2d_bytes=6144, requests=2)
    m.record_hot_path(gap_ms=0.0, assembly_ms=2.5, overlapped=True,
                      h2d_bytes=6144, requests=2)
    m.record_shed()
    m.record_wedge("3x32x32", failed=2, timeout_s=0.4)
    m.record_quarantined("3x32x32", alive=1)
    m.record_breaker_transition("32x32", "closed", "open")
    m.record_breaker_transition("32x32", "open", "half_open")
    m.record_breaker_transition("32x32", "half_open", "closed")
    m.record_state_change("healthy", "degraded", "breaker open")
    m.record_circuit_rejected(3)
    m.record_event("cache_flush", reason="close", slots=0)
    rec = m.write_snapshot(executables=2)
    again = m.write_snapshot(executables=2)
    return rec, again, _lines(path)


def test_metrics_records_match_jax_and_validate(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jm, tm = both("serving.metrics")
    j_rec, j_again, j_lines = _metrics_records(jm, tmp_path / "jax")
    rec, again, lines = _metrics_records(tm, tmp_path / "port")
    assert _untimed(lines) == _untimed(j_lines)
    assert _untimed(rec) == _untimed(j_rec)
    _valid_in_both(lines)
    # the JAX unit's own assertions, on the port
    assert rec["submitted"] == 3 and rec["shed"] == 1
    assert rec["queue_depth"]["max"] == 2 and again["step"] == 2
    b = rec["buckets"]["3x32x32"]
    assert b["occupancy"] == round(2 / 3, 4) and b["total"]["count"] == 2
    assert b["real_px"] == 1800 and b["padded_px"] == 3072
    assert rec["ragged"]["cross_shape_coalesce_rate"] == 1.0
    res = rec["resilience"]
    assert res["wedged"] == 1 and res["quarantined_threads"] == 1
    assert res["circuit_rejected"] == 3 and rec["failed"] == 2
    assert res["breaker_transitions"] == {"open": 1, "half_open": 1,
                                          "closed": 1}
    hot = rec["hot_path"]
    assert hot["h2d_bytes_per_req"] == 6144 / 2
    assert hot["assembly"]["overlap_ratio"] == round(2.5 / 4.0, 4)
    events = [r["event"] for r in lines if r["kind"] == "serving_event"]
    assert events == ["dispatch_wedged", "thread_quarantined",
                      "breaker_open", "breaker_half_open", "breaker_closed",
                      "serving_state", "cache_flush"]


def test_histogram_ladder_and_write_without_path():
    m = mod("raft_tpu_torch", "serving.metrics")
    jm = mod("raft_tpu", "serving.metrics")
    h, jh = m.LatencyHistogram(), jm.LatencyHistogram()
    for v in (0.05, 1.0, 3.0, 40.0, 70000.0):
        h.observe(v)
        jh.observe(v)
    s = h.snapshot()
    assert s == jh.snapshot() and h.bounds == jh.bounds
    assert s["count"] == 5 and s["max_ms"] == 70000.0
    assert s["p50_ms"] <= s["p99_ms"] <= s["max_ms"]
    merged = m.LatencyHistogram.from_snapshot(s).merge(h)
    assert merged.count == 10
    with pytest.raises(ValueError, match="no metrics path"):
        m.ServingMetrics().write_snapshot()
    m.ServingMetrics().record_event("x")   # no path: a no-op


# -- trace ledger ------------------------------------------------------------

def _ledger_run(trace, tmp):
    path = str(tmp / "spans.jsonl")
    led = trace.TraceLedger(path, sample_rate=0.0)
    out = []
    s = led.begin("request", bucket="32x32")
    out += [led.open_count(), led.close(s, "completed", "completed"),
            led.close(s, "failed", "failed"), led.open_count()]
    out.append([led.close(led.begin("request", bucket="b"), "completed",
                          "completed") for _ in range(5)])
    t = led.begin("request", bucket="b")
    out.append(led.close(t, "completed", "completed", tail=True))
    f = led.begin("request", bucket="b")
    out.append(led.close(f, "RuntimeError", "failed"))
    d = led.begin("request", bucket="b")
    out.append(led.close(d, "deadline_expired", "deadline_missed"))
    r2 = led.begin("request", bucket="b")
    disp = led.begin("dispatch", bucket="b", fan_in=1, capacity=1,
                     padding_waste=0.0, requests=[r2.trace_id])
    r2.linked = disp
    led.mark(r2, "taken")
    led.annotate(r2, fan_in=1)
    led.close(r2, "completed", "completed", tail=True)
    led.close(disp, "ok")
    x = led.begin("request")
    led.discard(x)
    led.set_parent("r-0")
    c = led.begin("request", bucket="b")
    out.append(c.fields.get("parent"))
    led.close(c, "completed", "completed", tail=True)
    out.append(os.path.exists(path))      # close never does I/O
    out.append(led.flush())
    out.append(led.flush())
    out.append(led.snapshot())
    return out, _lines(path)


def test_ledger_units_match_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jt, tt = both("serving.trace")
    j_out, j_lines = _ledger_run(jt, tmp_path / "jax")
    out, lines = _ledger_run(tt, tmp_path / "port")
    assert _untimed(out) == _untimed(j_out)
    assert _untimed(lines) == _untimed(j_lines)
    assert out[:4] == [1, False, False, 0]   # sampled out at rate 0
    assert not any(out[4]) and out[5] and out[6] and out[7]
    assert out[8] == "r-0" and out[9] is False and out[-2] == 0
    assert {r["class"] for r in lines if r["span"] == "request"} == {
        "completed", "failed", "deadline_missed"}
    assert [r["span"] for r in lines].count("dispatch") == 1
    _valid_in_both(lines)
    assert tt.sample_fraction("r-1") == jt.sample_fraction("r-1")
    assert tt.SPAN_CLASSES == jt.SPAN_CLASSES
    assert tt.SPAN_MARKS == jt.SPAN_MARKS
    with pytest.raises(ValueError, match="sample_rate"):
        tt.TraceLedger(None, sample_rate=1.5)


def test_schema_tables_match_jax():
    js, ts = both("serving.schema")
    assert ts.SNAPSHOT_KEYS == js.SNAPSHOT_KEYS
    assert ts.EVENT_FIELDS == js.EVENT_FIELDS
    assert ts.SPAN_FIELDS == js.SPAN_FIELDS
    assert ts.RECORD_KINDS == js.RECORD_KINDS
    assert ts.validate_record({"kind": "serving_event", "event": "nope",
                               "time": 0}) != []
    assert ts.validate_record({"kind": "what"}) != []


# -- feature-cache pool ------------------------------------------------------

def _pool_run(fc):
    out = []
    pool = fc.FeatureCachePool(capacity=4)
    pool.store("s1", (32, 32), seq=1, version=0, fmap="F", ctx="C",
               flow_low="L")
    out.append(pool.valid("s1", (32, 32), 1))
    slot = pool.acquire("s1", (32, 32), 1, 0)
    out.append((slot.fmap, slot.ctx, slot.flow_low))
    for key, seq, ver in (((48, 32), 1, 0), ((32, 32), 2, 0),
                          ((32, 32), 1, 1)):
        pool.store("s2", (32, 32), seq=1, version=0, fmap=1, ctx=2,
                   flow_low=3)
        out.append(pool.acquire("s2", key, seq, ver))
    small = fc.FeatureCachePool(capacity=2)
    for i, s in enumerate("abc"):
        small.store(s, (32, 32), seq=1, version=0, fmap=i, ctx=i,
                    flow_low=None)
    out.append(small.valid("a", (32, 32), 1))
    out.append(small.acquire("b", (32, 32), 1, 0) is not None)
    small.store("d", (32, 32), seq=1, version=0, fmap=9, ctx=9,
                flow_low=None)
    out += [small.valid("b", (32, 32), 1), small.valid("c", (32, 32), 1)]
    out += [pool.invalidate("s1"), pool.invalidate("s1"), pool.flush()]
    pool.record_miss()
    pool.record_miss(stale=True)
    out += [pool.snapshot(), small.snapshot(), len(pool)]
    with pytest.raises(ValueError):
        fc.FeatureCachePool(capacity=0)
    return out


def test_feature_cache_pool_matches_jax():
    j, t = (_pool_run(m) for m in both("serving.feature_cache"))
    assert t == j
    assert t[0] is True and t[1] == ("F", "C", "L")
    assert t[2:5] == [None, None, None]          # geometry, seq, version
    assert t[5] is False and t[6] is True and t[7] is True and t[8] is False
    assert t[9:12] == [True, False, 0]
    snap = t[12]
    assert snap["stale"] == 4 and snap["flushes"] == 1
    assert t[13]["evictions"] == 2 and t[-1] == 0


def test_feature_cache_pool_thread_safety():
    fc = mod("raft_tpu_torch", "serving.feature_cache")
    pool = fc.FeatureCachePool(capacity=8)
    errs = []

    def worker(wid):
        try:
            for i in range(200):
                pool.store(f"s{wid}", (32, 32), i, 0, i, i, None)
                pool.acquire(f"s{wid}", (32, 32), i, 0)
        except Exception as exc:   # pragma: no cover
            errs.append(exc)

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not errs and pool.snapshot()["occupancy"] <= 8


# -- placement over explicit engines ----------------------------------------

class _Eng:
    """The capacity surface ``Placement.bucket_fit`` reads."""

    def __init__(self):
        self.calls = []
        self.table = {}

    def bucket_capacity(self, h, w, cached=False):
        fits = [b for (b, bh, bw, c) in self.table
                if bh >= h and bw >= w and c == cached]
        return max(fits) if fits else None

    def ensure_bucket(self, b, h, w, cached=False):
        self.calls.append(("ensure", b, h, w, cached))
        self.table[(b, -(-h // 8) * 8, -(-w // 8) * 8, cached)] = True
        return (b, -(-h // 8) * 8, -(-w // 8) * 8)

    def ragged_capacity(self, h, w):
        return None

    def ensure_ragged(self, b, h, w):
        self.calls.append(("ragged", b, h, w))
        return (b, h, w)


def _placement_run(pl):
    a, b, c = _Eng(), _Eng(), _Eng()
    p = pl.Placement(a, replicas=2, ceiling=3, engines=[a, b, c])
    out = [p.replicas, p.ceiling, len(p.engines), p.decide((2160, 3840)),
           p.want_scale_up(9, 2, 4), p.want_scale_up(8, 2, 4),
           p.want_scale_up(99, 3, 4), p.want_retire(31.0, 3, 30.0),
           p.want_retire(31.0, 2, 30.0), p.want_retire(1.0, 3, 30.0)]
    out.append(pl.Placement.bucket_fit(a, (30, 30), 4))
    out.append(pl.Placement.bucket_fit(a, (30, 30), 4))    # now built
    out.append(pl.Placement.bucket_fit(a, (30, 30, "cache"), 2))
    out.append(pl.Placement.bucket_fit(a, (64, 64, "ragged"), 3))
    out.append(a.calls)
    k = p.attach_host("h0", c)
    p.mark_host("h0", "dead")
    out += [k, p.ceiling, p.host_lane("h0"), p.host_lane("nope"),
            p.hosts]
    snap = p.snapshot()
    out.append({k: v for k, v in snap.items() if k != "assignments"})
    with pytest.raises(ValueError, match="primary first"):
        pl.Placement(a, engines=[b, a])
    with pytest.raises(ValueError, match="entries"):
        pl.Placement(a, replicas=3, engines=[a])
    with pytest.raises(ValueError, match="spawn_replica"):
        pl.Placement(object(), replicas=2)
    return out


def test_placement_over_explicit_engines_matches_jax():
    j, t = (_placement_run(m) for m in both("parallel.placement"))
    assert t == j
    assert t[:4] == [2, 3, 3, "replicate"]
    assert t[4:10] == [True, False, False, True, False, False]
    assert t[10:14] == [4, 4, 2, 3]
    assert t[14] == [("ensure", 4, 30, 30, False),
                     ("ensure", 2, 30, 30, True), ("ragged", 3, 64, 64)]
    assert t[15:18] == [3, 4, 3]
    pl = mod("raft_tpu_torch", "parallel.placement")
    a = _Eng()
    labels = pl.Placement(a, engines=[a, _Eng()]).assignments
    assert set(labels) == {0, 1}


# -- fault sites -------------------------------------------------------------

def test_serving_fault_sites_registered_as_in_jax():
    jf = mod("raft_tpu", "testing.faults")
    for site in ("serve.request", "serve.dispatch_exec", "scheduler.swap",
                 "serve.fetch", "engine.compile"):
        assert site in tfaults.KNOWN_SITES and site in jf.KNOWN_SITES
    tfaults.arm([{"site": "scheduler.swap", "kind": "raise"}])
    tfaults.disarm()
    with pytest.raises(ValueError, match="serve.request"):
        tfaults.arm([{"site": "serve.requests", "kind": "raise"}])
