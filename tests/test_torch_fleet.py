"""The port's replica fleet (``MicroBatchScheduler(replicas=N)``,
``parallel/placement.py``, ``RAFTEngine.spawn_replica``) on the CPU,
mirroring ``tests/test_fleet.py`` without its AOT-store case:

- the placement layer's decisions (replicate or shard, the scaling
  policy, bucket fit, construction and its errors) against
  ``raft_tpu.parallel.placement`` on the same fakes, exactly;
- the fleet dispatcher on fake engines: fan-out and balance, scale-up
  under queue pressure and idle retirement, one wedged replica
  quarantined alone, the fleet-atomic swap (a ``scheduler.swap`` raise
  leaves every lane on the old weights), the ``ConfigError`` contracts,
  intake failing fast only when a shape is open on every lane, no leaked
  workers;
- real CPU engines: ``replicas=2`` bitwise ``replicas=1``, a replica's
  own captures of its primary's programs, the swap's rollback on real
  weights, and ``serve_bench``'s ``fleet`` block against the JAX drill's.

Threaded tests follow the scheduler tests' rule: a hang is an event the
test releases, every wait is bounded, and no assertion rests on a
wall-clock margin (a watchdog deadline is only raced against a hang that
cannot end before it).
"""

import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu.parallel.placement import Placement as JaxPlacement
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.parallel.placement import SHARD_PX_THRESHOLD, Placement
from raft_tpu_torch.serving import (CircuitOpen, DispatchWedged,
                                    MicroBatchScheduler, RAFTEngine)
from raft_tpu_torch.serving.scheduler import ConfigError
from raft_tpu_torch.testing import faults
from raft_tpu_torch.testing.faults import FaultInjected
from tests.test_scheduler import _FakeEngine as _JaxFakeEngine
from tests.test_torch_scheduler import _FakeEngine, _identity, _wait

WAIT = 30.0
SMALL = RAFTConfig(small=True)


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


class _FleetEngine(_FakeEngine):
    """The scheduler-facing fake, fleet-capable: ``spawn_replica``
    mirrors the built-key table (the real engine's placeholder contract)
    and ``update_weights`` records the weights for the swap drills."""

    def __init__(self):
        super().__init__()
        self.variables = {"gen": 0}
        self.spawned = 0
        self.ensures = 0

    def ensure_bucket(self, b, h, w):
        self.ensures += 1
        return super().ensure_bucket(b, h, w)

    def spawn_replica(self):
        rep = _FleetEngine()
        rep._compiled = dict.fromkeys(self._compiled)
        rep.variables = self.variables
        self.spawned += 1
        return rep

    def update_weights(self, variables):
        self.variables = variables


class _JaxFleetEngine(_JaxFakeEngine):
    """The JAX tests' fake with the same fleet surface."""

    def __init__(self):
        super().__init__()
        self.spawned = 0

    def spawn_replica(self):
        rep = _JaxFleetEngine()
        rep._compiled = dict.fromkeys(self._compiled)
        self.spawned += 1
        return rep


def _sched(eng, **kw):
    kw.setdefault("gather_window_s", 0.0)
    kw.setdefault("max_batch", 2)
    return MicroBatchScheduler(eng, **kw)


def _busy(sched):
    return sum(blk["busy"]
               for blk in sched.health()["fleet"]["lanes"].values())


# -- the placement layer, held to raft_tpu's -----------------------------------

KEYS = [(32, 32), (1080, 1920), (2160, 3840), (2159, 3840), (4320, 7680),
        (2160, 3840, "cache"), (64, 64, "ragged")]


@pytest.mark.parametrize("mesh", [False, True])
def test_decide_matches_jax(mesh):
    engines = (_FleetEngine(), _JaxFleetEngine())
    if mesh:
        for e in engines:
            e.partitioner = object()
    port, jax_ = (cls(e, replicas=2) for cls, e in
                  zip((Placement, JaxPlacement), engines))
    assert [port.decide(k) for k in KEYS] == [jax_.decide(k) for k in KEYS]
    assert port.decide((2160, 3840)) == ("shard" if mesh else "replicate")
    assert 2160 * 3840 >= SHARD_PX_THRESHOLD


@pytest.mark.parametrize("replicas,ceiling", [(1, None), (1, 3), (2, 4),
                                              (3, 2)])
def test_scaling_policy_matches_jax(replicas, ceiling):
    port = Placement(_FleetEngine(), replicas=replicas, ceiling=ceiling)
    jax_ = JaxPlacement(_JaxFleetEngine(), replicas=replicas,
                        ceiling=ceiling)
    up = [(d, a, b) for d in range(0, 20, 3) for a in range(5)
          for b in (1, 4)]
    assert ([port.want_scale_up(*x) for x in up]
            == [jax_.want_scale_up(*x) for x in up])
    retire = [(i, a, r) for i in (0.0, 0.5, 2.0) for a in range(5)
              for r in (0.1, 1.0)]
    assert ([port.want_retire(*x) for x in retire]
            == [jax_.want_retire(*x) for x in retire])


@pytest.mark.parametrize("replicas,ceiling", [(1, None), (3, None), (1, 2),
                                              (2, 1)])
def test_construction_and_growth_match_jax(replicas, ceiling):
    out = []
    for cls, fake in ((Placement, _FleetEngine), (JaxPlacement,
                                                  _JaxFleetEngine)):
        eng = fake()
        eng.ensure_bucket(2, 32, 32)
        p = cls(eng, replicas=replicas, ceiling=ceiling)
        grown = []
        for _ in range(3):
            try:
                p.grow()
                grown.append(len(p.engines))
            except ValueError as exc:
                grown.append(str(exc))
        snap = p.snapshot()
        snap.pop("assignments")          # device names differ by package
        out.append((len(p.engines), eng.spawned, grown, snap,
                    [set(r._compiled) for r in p.engines]))
    assert out[0] == out[1]


def test_placement_validation_matches_jax():
    def outcome(cls, fake, **kw):
        eng = fake()
        try:
            cls(eng, **{k: (v(eng) if callable(v) else v)
                        for k, v in kw.items()})
        except ValueError as exc:
            return str(exc)
        return "ok"

    class Duck:
        pass

    cases = [dict(replicas=2, engines=lambda e: [type(e)(), type(e)()]),
             dict(replicas=2, engines=lambda e: [e]),
             dict(replicas=2, engines=lambda e: [e, type(e)()])]
    for kw in cases:
        assert (outcome(Placement, _FleetEngine, **kw)
                == outcome(JaxPlacement, _JaxFleetEngine, **kw))
    with pytest.raises(ValueError, match="spawn_replica"):
        Placement(Duck(), replicas=2)


def test_bucket_fit_matches_jax():
    port, jax_ = _FleetEngine(), _JaxFleetEngine()
    keys = [(32, 32), (32, 32), (40, 48), (33, 31), (40, 48)]
    fits = [[Placement.bucket_fit(port, k, 4) for k in keys],
            [JaxPlacement.bucket_fit(jax_, k, 4) for k in keys]]
    assert fits[0] == fits[1] == [4, 4, 4, 4, 4]
    assert port.ensures == jax_.compile_calls == 3
    port.drop_bucket((4, 32, 32))
    jax_.drop_bucket((4, 32, 32))
    assert (Placement.bucket_fit(port, (32, 32), 2)
            == JaxPlacement.bucket_fit(jax_, (32, 32), 2) == 2)


# -- the fleet dispatcher on fake engines --------------------------------------

class _WaveGate:
    """One lane's gate: each dispatch waits for a pass, which the test hands
    out one a wave. ``passed`` counts the passes used."""

    def __init__(self):
        self._cv = threading.Condition()
        self.waiting = 0
        self.passed = 0
        self._passes = 0

    def wait(self, timeout):
        with self._cv:
            self.waiting += 1
            ok = self._cv.wait_for(lambda: self._passes > 0, timeout)
            if ok:
                self._passes -= 1
                self.passed += 1
            self.waiting -= 1
            return ok

    def release(self, n=1):
        with self._cv:
            self._passes += n
            self._cv.notify_all()


def test_fanout_concurrency_and_balance(rng):
    """Four lanes run micro-batches at once, and least-loaded picking
    spreads them. The traffic goes in waves: every lane blocked in its
    dispatch, one pass each, then every lane blocked again, so each pick
    sees all lanes free and no lane's thread wins on CPU scheduling alone
    (with one gate for all, whichever lane's thread ran first under load
    kept winning: loads [12, 7, 5, 7])."""
    eng = _FleetEngine()
    sched = _sched(eng, replicas=4, dispatch_timeout_s=WAIT)
    gates = [_WaveGate() for _ in sched._lanes]
    for lane, gate in zip(sched._lanes, gates):
        lane.engine.gates.update({(32, 32): gate, (40, 40): gate})

    def settled():
        # every lane blocked at its gate, or the queue empty and every
        # busy lane blocked there
        waiting = sum(g.waiting for g in gates)
        return waiting == 4 or (sched.health()["queue_depth"] == 0
                                and _busy(sched) == waiting)

    try:
        futs = [sched.submit(*_pair(rng, *s))
                for s in [(32, 32), (40, 40)] * 20]
        assert _wait(lambda: _busy(sched) == 4)
        for _ in range(len(futs)):
            if all(f.done() for f in futs):
                break
            assert _wait(settled)
            wave = {g: g.passed + 1 for g in gates if g.waiting}
            for g in wave:
                g.release()
            assert _wait(lambda: all(g.passed >= n for g, n in wave.items()))
        for f in futs:
            assert f.result(timeout=WAIT).flow.shape[-1] == 2
        fleet = sched.health()["fleet"]
        assert fleet["replicas"] == 4 == fleet["active"]
        assert fleet["concurrency_max"] == 4
        loads = [blk["dispatches"] for blk in fleet["lanes"].values()]
        assert min(loads) >= 1 and max(loads) <= 2 * min(loads), loads
        snap = sched.metrics.snapshot()
        assert snap["submitted"] == 40 == snap["completed"]
        reps = snap["replicas"]
        assert len(reps) == 4
        assert sum(b["completed"] for b in reps.values()) == 40
        # each lane's breaker-less labels carry its replica suffix
        assert any(k.endswith("/r3") for k in snap["buckets"])
    finally:
        for g in gates:
            g.release(1 << 20)
        sched.close()


def test_queue_pressure_grows_then_idle_retires(rng):
    eng = _FleetEngine()
    gate = threading.Event()
    eng.gates[(32, 32)] = gate
    sched = _sched(eng, replicas=1, replica_ceiling=3, max_batch=1,
                   replica_idle_retire_s=0.05)
    try:
        futs = [sched.submit(*_pair(rng)) for _ in range(30)]
        # the primary is held: the queue stays deep and the fleet grows
        # to its ceiling, the new replicas serving meanwhile
        assert _wait(lambda: sched.health()["fleet"]["replicas"] == 3)
        assert eng.spawned == 2
        gate.set()
        for f in futs:
            f.result(timeout=WAIT)
        assert sched.health()["fleet"]["concurrency_max"] > 1
        assert _wait(lambda: sched.health()["fleet"]["active"] == 1)
        assert sched._lanes[0].active         # the primary never retires
    finally:
        gate.set()
        sched.close()


def test_wedged_replica_quarantines_alone_rest_serve(rng):
    eng = _FleetEngine()
    sched = _sched(eng, replicas=3, max_batch=1, dispatch_timeout_s=2.0,
                   breaker_failures=1, breaker_backoff_s=WAIT,
                   breaker_backoff_max_s=WAIT)
    hang = threading.Event()            # released after the verdict
    sched._lanes[1].engine.gates[(32, 32)] = hang
    try:
        futs = [sched.submit(*_pair(rng)) for _ in range(20)]
        outs = [f.exception(timeout=WAIT) for f in futs]   # all settle
        failed = [e for e in outs if e is not None]
        assert len(failed) == 1 and isinstance(failed[0], DispatchWedged)
        h = sched.health()
        assert [k for k, blk in h["fleet"]["lanes"].items()
                if blk["quarantined"]] == ["r1"]
        assert h["state"] == "degraded"
        snap = sched.metrics.snapshot()
        assert snap["completed"] == 19 and _identity(snap)
        assert snap["resilience"]["wedged"] == 1
        # the survivors keep serving after the verdict
        assert sched.submit(*_pair(rng)).result(timeout=WAIT)
    finally:
        hang.set()
        sched.close()


def test_swap_weights_is_fleet_atomic_under_fault(rng):
    eng = _FleetEngine()
    sched = _sched(eng, replicas=3)
    try:
        old = [lane.engine.variables for lane in sched._lanes]
        new = {"gen": 1}
        faults.arm([{"site": "scheduler.swap", "at": 2, "kind": "raise"}])
        with pytest.raises(FaultInjected):
            sched.swap_weights(new)
        for lane, before in zip(sched._lanes, old):
            assert lane.engine.variables is before
        faults.disarm()
        sched.swap_weights(new)
        assert all(lane.engine.variables is new for lane in sched._lanes)
        assert sched.submit(*_pair(rng)).result(timeout=WAIT)
    finally:
        sched.close()


def test_swap_waits_for_the_lanes_in_flight(rng):
    """The epoch quiesces first: a lane mid-dispatch keeps the old
    weights until its job is reaped, then every lane moves. Both lanes
    hold the shape: the dispatcher may hand the queued key to the second
    lane before the first lane's worker takes the request, and either
    lane may serve it."""
    eng = _FleetEngine()
    sched = _sched(eng, replicas=2)
    gate = threading.Event()
    for lane in sched._lanes:
        lane.engine.gates[(32, 32)] = gate
    try:
        fut = sched.submit(*_pair(rng))
        assert _wait(lambda: _busy(sched) == 1)
        new = {"gen": 2}
        t = threading.Thread(target=sched.swap_weights, args=(new,))
        t.start()
        assert _wait(lambda: sched._swapping)
        assert all(lane.engine.variables is not new
                   for lane in sched._lanes)
        gate.set()
        t.join(WAIT)
        assert not t.is_alive()
        assert all(lane.engine.variables is new for lane in sched._lanes)
        assert fut.result(timeout=WAIT)
    finally:
        gate.set()
        sched.close()


class _SlowSpawnEngine(_FleetEngine):
    """A primary whose ``spawn_replica`` copies the weights first and
    then holds on ``gate`` — the real engine's order: a copy of the
    weights, then a capture of every program."""

    def __init__(self, gate, entered):
        super().__init__()
        self.gate, self.entered = gate, entered

    def spawn_replica(self):
        rep = super().spawn_replica()
        self.entered.set()
        self.gate.wait(WAIT)
        return rep


def test_swap_during_a_grow_reaches_the_grown_replica(rng):
    """A swap raised while the dispatcher grows a replica from the old
    weights waits for the new lane to join, then moves it too: the
    fleet is never left mixed by a swap that returned."""
    grow, entered = threading.Event(), threading.Event()
    eng = _SlowSpawnEngine(grow, entered)
    sched = _sched(eng, replicas=1, replica_ceiling=2, max_batch=1)
    new = {"gen": 1}
    try:
        with sched._cv:
            # the dispatcher sees all three at once, so it grows while
            # the primary is idle
            futs = [sched.submit(*_pair(rng)) for _ in range(3)]
        assert entered.wait(WAIT)
        t = threading.Thread(target=sched.swap_weights, args=(new,))
        t.start()
        assert _wait(lambda: sched._swapping)
        grow.set()
        t.join(WAIT)
        assert not t.is_alive()
        assert len(sched._lanes) == 2
        assert all(lane.engine.variables is new for lane in sched._lanes)
        for f in futs:
            assert f.result(timeout=WAIT)
    finally:
        grow.set()
        sched.close()


def test_feature_cache_with_replicas_raises_config_error():
    eng = _FleetEngine()
    eng.feature_cache = True
    with pytest.raises(ConfigError, match="replica"):
        MicroBatchScheduler(eng, replicas=2, feature_cache=True)


def test_pipeline_depth_with_replicas_raises_config_error():
    with pytest.raises(ConfigError, match="pipeline_depth"):
        MicroBatchScheduler(_FleetEngine(), replicas=2, pipeline_depth=2)


def test_replicas_one_builds_no_fleet(rng):
    sched = _sched(_FleetEngine())
    try:
        assert sched.placement is None and sched._lanes == []
        assert "fleet" not in sched.health()
        assert sched.submit(*_pair(rng)).result(timeout=WAIT)
        assert "replicas" not in sched.metrics.snapshot()
    finally:
        sched.close()


def test_shape_open_on_every_lane_fails_fast_at_intake(rng):
    eng = _FleetEngine()
    sched = _sched(eng, replicas=2, max_batch=1, breaker_failures=1,
                   breaker_backoff_s=WAIT, breaker_backoff_max_s=WAIT)
    for lane in sched._lanes:
        lane.engine.fail_shapes.add((32, 32))
    try:
        for _ in range(2):      # one failure opens each lane's breaker
            with pytest.raises(RuntimeError, match="device error"):
                sched.submit(*_pair(rng)).result(timeout=WAIT)
        assert _wait(lambda: all(
            blk["breakers"].get("32x32", {}).get("state") == "open"
            for blk in sched.health()["fleet"]["lanes"].values()))
        with pytest.raises(CircuitOpen, match="every active replica"):
            sched.submit(*_pair(rng))
        # another shape still serves
        assert sched.submit(*_pair(rng, 40, 40)).result(timeout=WAIT)
    finally:
        sched.close()


def test_close_stops_every_lane_worker(rng):
    before = set(threading.enumerate())
    sched = _sched(_FleetEngine(), replicas=3)
    futs = [sched.submit(*_pair(rng)) for _ in range(6)]
    for f in futs:
        f.result(timeout=WAIT)
    sched.close()
    assert _wait(lambda: not [
        t for t in threading.enumerate()
        if t not in before and t.is_alive()
        and t.name.startswith("MicroBatchScheduler")])


# -- real CPU engines ----------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    return (RAFT(SMALL, torch.Generator().manual_seed(0)).state_dict(),
            RAFT(SMALL, torch.Generator().manual_seed(1)).state_dict())


def _engine(w, envelope=((1, 32, 32),), **kw):
    return RAFTEngine(w, SMALL, iters=1, envelope=list(envelope),
                      device="cpu", **kw)


def _gate_lanes(sched):
    """Hold every lane's engine until the returned event is set."""
    gate = threading.Event()
    for lane in sched._lanes:
        real = lane.engine.infer_batch_async

        def gated(*a, real=real, **kw):
            assert gate.wait(WAIT)
            return real(*a, **kw)

        lane.engine.infer_batch_async = gated
    return gate


def _fleet_flows(sched, pairs, lanes):
    """Every pair through ``sched``, each lane busy before any runs."""
    gate = _gate_lanes(sched) if lanes > 1 else None
    futs = [sched.submit(a, b) for a, b in pairs]
    if gate is not None:
        assert _wait(lambda: _busy(sched) == lanes)
        gate.set()
    return [f.result(timeout=WAIT).flow for f in futs]


def test_replicas_two_bitwise_replicas_one(weights, rng):
    pairs = [_pair(rng) for _ in range(6)]
    with _sched(_engine(weights[0]), max_batch=1) as one:
        want = _fleet_flows(one, pairs, 1)
    primary = _engine(weights[0])
    with _sched(primary, replicas=2, max_batch=1) as two:
        got = _fleet_flows(two, pairs, 2)
        lanes = two.health()["fleet"]["lanes"]
        replica = two._lanes[1].engine
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(blk["dispatches"] >= 1 for blk in lanes.values()), lanes
    # the replica captured its own copy of the primary's one program, and
    # holds its own weights
    assert replica.capture_count == primary.capture_count == 1
    assert replica.aot_stats()["compiles"] == 1
    assert replica.bucket_shapes() == primary.bucket_shapes()
    for a, b in zip(replica.variables.values(), primary.variables.values()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert replica._capture_lock is primary._capture_lock


def test_spawn_replica_adopts_programs_and_placeholders(weights):
    primary = _engine(weights[0], envelope=[(1, 32, 32), (2, 24, 40)])
    lazy = _engine(weights[0], envelope=[(1, 16, 16)], precompile=False)
    rep = primary.spawn_replica()
    assert rep.capture_count == 2 and rep.bucket_shapes() == [
        (1, 32, 32), (2, 24, 40)]
    assert rep.adopt_executables(primary) == 0        # nothing new
    rep.drop_bucket((1, 32, 32))
    assert (1, 32, 32) in primary.bucket_shapes()     # tables are its own
    assert rep.adopt_executables(primary) == 1
    lazy_rep = lazy.spawn_replica()
    assert lazy_rep.capture_count == 0
    assert lazy_rep.bucket_shapes() == [(1, 16, 16)]


def test_fleet_swap_rolls_back_real_weights(weights, rng):
    pairs = [_pair(rng) for _ in range(4)]
    oracle = []
    for w in weights:
        eng = _engine(w)
        oracle.append([eng.infer_batch(a[None], b[None])[0]
                       for a, b in pairs])
    with _sched(_engine(weights[0]), replicas=2, max_batch=1) as sched:
        faults.arm([{"site": "scheduler.swap", "at": 2, "kind": "raise"}])
        with pytest.raises(FaultInjected):
            sched.swap_weights(weights[1])
        faults.disarm()
        for lane in sched._lanes:
            for k, v in lane.engine.variables.items():
                assert torch.equal(v, weights[0][k]), k
        for g, w in zip(_fleet_flows(sched, pairs, 2), oracle[0]):
            np.testing.assert_array_equal(g, w)
        sched.swap_weights(weights[1])
        for g, w in zip(_fleet_flows(sched, pairs, 2), oracle[1]):
            np.testing.assert_array_equal(g, w)


def test_serve_bench_fleet_block_matches_jax_drill(weights):
    """``run_drill(replicas=2)`` grows the ``fleet`` block with the JAX
    drill's keys for the same flags, and the single-engine drill on the
    same engine has none."""
    import jax
    import jax.numpy as jnp

    from raft_tpu.cli.serve_bench import run_drill as jax_drill
    from raft_tpu.config import RAFTConfig as JaxConfig
    from raft_tpu.models import RAFT as JaxRAFT
    from raft_tpu.serving.engine import RAFTEngine as JaxEngine
    from raft_tpu_torch.cli.serve_bench import run_drill

    kw = dict(shapes=[(32, 32)], requests=8, submitters=2, bucket_batch=1,
              iters=1, gather_window_s=0.0, replicas=2)
    eng = _engine(weights[0], warm_start=True)
    s = run_drill(weights[0], SMALL, engine=eng, device="cpu", **kw)
    jcfg = JaxConfig(small=True)
    img = jnp.zeros((1, 32, 32, 3))
    jvars = JaxRAFT(jcfg).init(jax.random.PRNGKey(0), img, img, iters=1)
    jeng = JaxEngine(jvars, jcfg, iters=1, envelope=[(1, 32, 32)],
                     precompile=True, warm_start=True)
    js = jax_drill(jvars, jcfg, engine=jeng, **kw)
    assert set(s) == set(js)
    assert set(s["fleet"]) == set(js["fleet"])
    assert set(s["fleet"]["lanes"]["r0"]) == set(js["fleet"]["lanes"]["r0"])
    assert s["served"] == 8 and s["accounting_ok"] and not s["stranded"]
    assert sum(b["completed"] for b in s["fleet"]["lanes"].values()) == 8
    s1 = run_drill(weights[0], SMALL, engine=eng, device="cpu",
                   **dict(kw, replicas=1, requests=4))
    assert "fleet" not in s1


def test_fleet_stress_every_future_gets_its_own_result():
    """More submitters than cores over four lanes, with a short thread
    switch interval: every future settles with its own request's result
    (the fake's flow carries the frame's value), nothing strands, and the
    accounting identity holds."""
    import sys

    eng = _FleetEngine()
    sched = _sched(eng, replicas=4, max_queue=512)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    got, errors = {}, []

    def submit(sid):
        try:
            futs = [(v, sched.submit(np.full((32, 32, 3), v, np.float32),
                                     np.full((32, 32, 3), v, np.float32)))
                    for v in range(sid * 100, sid * 100 + 25)]
            for v, f in futs:
                got[v] = float(f.result(timeout=WAIT).flow[0, 0, 0])
        except Exception as exc:     # surfaced by the assertion below
            errors.append(exc)

    threads = [threading.Thread(target=submit, args=(s,)) for s in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        sched.close()
    assert not errors and len(got) == 400
    assert all(v == k for k, v in got.items())
    snap = sched.metrics.snapshot()
    assert snap["completed"] == 400 and _identity(snap)
    assert sum(b["completed"] for b in snap["replicas"].values()) == 400
