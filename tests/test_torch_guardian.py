"""The port's SLO guardian and admission budget
(``raft_tpu_torch.serving.guardian``) held to ``raft_tpu.serving.guardian``
in the same run, mirroring ``tests/test_guardian.py``:

- ``window_stats`` on the same synthetic snapshot pairs (lifetime and
  fleet-shaped, with tail exemplars): equal dicts;
- ``SLOGuardian`` driven by the same injected clock and reader through
  scripted bakes (clean promote, every breach, the empty-baseline rule,
  insufficient traffic, a new version restarting the bake, the replica
  dilution drill, two models at once, a refused verdict): the same
  decision sequence — action, reason, evidence, mode — and the same
  ``guardian_*`` events in metrics.jsonl;
- ``GuardianPolicy`` validation and ``AdmissionBudget``'s acquire/release
  sequences: the same outcomes;
- on the port alone, over fake engines: a guardian hung or raising at
  ``guardian.decide`` leaves routing whole; the budget's starvation drill
  and its release on a failed submit; and on CPU engines the degraded
  canary rolled back inside its bake window with live outputs bitwise
  unchanged, and a clean canary promoted as a weight swap that captures
  nothing.

Hangs are events the test releases, every wait is bounded, and no
assertion rests on a wall-clock margin.
"""

import copy
import json
import random
import threading
import types

import numpy as np
import pytest
import torch

from raft_tpu.serving import guardian as jax_guardian
from raft_tpu.serving.metrics import _BOUNDS_MS as JAX_BOUNDS
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.serving import guardian
from raft_tpu_torch.serving.guardian import (AdmissionBudget, GuardianPolicy,
                                             SLOGuardian, window_stats)
from raft_tpu_torch.serving.metrics import _BOUNDS_MS
from raft_tpu_torch.serving.registry import ModelRegistry
from raft_tpu_torch.serving.scheduler import (PRIORITY_BATCH,
                                              PRIORITY_INTERACTIVE,
                                              BackpressureError)
from raft_tpu_torch.serving import RAFTEngine
from raft_tpu_torch.testing import faults
from raft_tpu_torch.testing.faults import FaultInjected
from tests.test_torch_scheduler import _FakeEngine, _wait

HW = (32, 32)
Z = np.zeros((*HW, 3), np.float32)
_NB = len(_BOUNDS_MS) + 1
WAIT = 30.0


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


def test_latency_ladder_matches_jax():
    assert list(_BOUNDS_MS) == list(JAX_BOUNDS)


# -- synthetic snapshots (the registry-snapshot variant-block schema) ---------

def _blk(completed=0, failed=0, bucket=3, wedged=0, opens=0, model=None,
         refs=None):
    """One variant snapshot: ``completed`` samples all in histogram
    bucket ``bucket`` (p99 == _BOUNDS_MS[bucket])."""
    counts = [0] * _NB
    counts[bucket] = completed
    d = {"completed": completed, "failed": failed,
         "latency": {"counts": counts, "max_ms": float(completed)},
         "resilience": {"wedged": wedged,
                        "breaker_transitions": {"open": opens}}}
    if model is not None:
        d["model"] = model
    if refs is not None:
        d["tail_exemplars"] = {"refs": [{"trace_id": f"r-{k}",
                                         "ms": float(k)} for k in refs]}
    return d


def _rep(completed=0, bucket=3):
    counts = [0] * _NB
    counts[bucket] = completed
    return {"completed": completed, "dispatches": completed,
            "filled": completed, "capacity": completed,
            "occupancy": 1.0, "queue_depth_last": 0,
            "latency": {"counts": counts, "count": completed,
                        "mean_ms": 0.0, "max_ms": float(completed)}}


def _fleet_blk(reps, failed=0, model=None):
    """A variant snapshot aggregating ``{replica: (completed, bucket)}``
    lanes, the shape a fleet scheduler's metrics emit."""
    counts = [0] * _NB
    total = 0
    for done, bucket in reps.values():
        counts[bucket] += done
        total += done
    d = {"completed": total, "failed": failed,
         "latency": {"counts": counts, "max_ms": float(total)},
         "resilience": {"wedged": 0, "breaker_transitions": {"open": 0}},
         "replicas": {str(k): _rep(done, bucket)
                      for k, (done, bucket) in reps.items()}}
    if model is not None:
        d["model"] = model
    return d


WINDOWS = {
    "lifetime_deltas": (_blk(130, 13, bucket=2), _blk(100, 10, bucket=2)),
    "slow_new_samples": (
        dict(_blk(105, 10, bucket=2),
             latency={"counts": [0, 0, 100] + [0] * 7 + [0, 5]
                      + [0] * (_NB - 12), "max_ms": 105.0}),
        _blk(100, 10, bucket=2)),
    "wedges_and_trips": (_blk(20, 2, wedged=3, opens=2), _blk(10, 1)),
    "empty": (_blk(), _blk()),
    "exemplars_new_since_baseline": (_blk(30, refs=range(12)),
                                     _blk(10, refs=range(3))),
    "fleet_lanes": (_fleet_blk({0: (130, 2), 1: (80, 2)}),
                    _fleet_blk({0: (100, 2), 1: (50, 2)})),
    "fleet_lane_activated_mid_bake": (_fleet_blk({0: (120, 2), 1: (15, 10)}),
                                      _fleet_blk({0: (100, 2)})),
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_window_stats_matches_jax(name):
    cur, base = WINDOWS[name]
    got = window_stats(copy.deepcopy(cur), copy.deepcopy(base))
    assert got == jax_guardian.window_stats(copy.deepcopy(cur),
                                            copy.deepcopy(base))
    assert got["requests"] == got["completed"] + got["failed"]


# -- scripted bakes, both packages --------------------------------------------

class _FakeRegistry:
    """The registry surface the guardian needs, scripted."""

    def __init__(self, metrics_path=None, refuse=None):
        self.metrics_path = metrics_path
        self.actions = []
        self.refuse = refuse

    def promote(self, name):
        if self.refuse is not None:
            raise RuntimeError(self.refuse)
        self.actions.append(("promote", name))
        return {"model": name, "mode": "weights_swap"}

    def rollback(self, name):
        if self.refuse is not None:
            raise RuntimeError(self.refuse)
        self.actions.append(("rollback", name))
        return {"model": name}


def _snap(live, canary):
    return {"m": {"live": live, "canary": canary}}


SCENARIOS = {
    "clean_bake_promotes": (dict(bake_window_s=10.0, min_requests=5), [
        (0.0, _snap(_blk(), _blk(model="m@v2"))),
        (5.0, _snap(_blk(40), _blk(20, model="m@v2"))),
        (10.5, _snap(_blk(40), _blk(20, model="m@v2"))),
        (11.0, _snap(_blk(40), None))]),
    "err_rate_breach_mid_window": (
        dict(bake_window_s=100.0, min_requests=5, err_rate_margin=0.05), [
            (0.0, _snap(_blk(), _blk(model="m@v2"))),
            (3.0, _snap(_blk(40, 1), _blk(10, 5, model="m@v2")))]),
    "p99_breach": (
        dict(bake_window_s=100.0, min_requests=5, p99_ratio=1.5,
             p99_slack_ms=0.0), [
            (0.0, _snap(_blk(), _blk(model="m@v2"))),
            (3.0, _snap(_blk(40, bucket=3), _blk(10, bucket=8,
                                                 model="m@v2")))]),
    "p99_ceiling_is_absolute": (
        dict(bake_window_s=100.0, min_requests=5, p99_ratio=100.0,
             p99_slack_ms=1e6, p99_ceiling_ms=_BOUNDS_MS[5]), [
            (0.0, _snap(_blk(), _blk(model="m@v2"))),
            (3.0, _snap(_blk(40, bucket=6), _blk(10, bucket=6,
                                                 model="m@v2")))]),
    "wedge_breach": (dict(bake_window_s=100.0, min_requests=5), [
        (0.0, _snap(_blk(), _blk(model="m@v2"))),
        (3.0, _snap(_blk(40), _blk(10, wedged=1, model="m@v2")))]),
    "breaker_breach": (dict(bake_window_s=100.0, min_requests=5), [
        (0.0, _snap(_blk(), _blk(model="m@v2"))),
        (3.0, _snap(_blk(40), _blk(10, opens=1, model="m@v2")))]),
    "empty_live_baseline": (
        dict(bake_window_s=10.0, min_requests=5, p99_ratio=1.5,
             p99_slack_ms=0.0, err_rate_margin=0.02), [
            (0.0, _snap(_blk(), _blk(model="m@v2"))),
            (3.0, _snap(_blk(0), _blk(30, 1, bucket=6, model="m@v2"))),
            (10.5, _snap(_blk(0), _blk(30, 1, bucket=6, model="m@v2"))),
            (10.6, _snap(_blk(0), _blk(10, wedged=2, model="m@v3"))),
            (12.0, _snap(_blk(0), _blk(20, wedged=4, model="m@v3")))]),
    "insufficient_traffic": (
        dict(bake_window_s=10.0, max_bake_s=30.0, min_requests=5), [
            (0.0, _snap(_blk(), _blk(model="m@v2"))),
            (15.0, _snap(_blk(40), _blk(2, model="m@v2"))),
            (31.0, _snap(_blk(40), _blk(2, model="m@v2")))]),
    "new_version_restarts_bake": (
        dict(bake_window_s=10.0, min_requests=1), [
            (0.0, _snap(_blk(), _blk(model="m@v2"))),
            (11.0, _snap(_blk(9), _blk(9, model="m@v3"))),
            (22.0, _snap(_blk(20), _blk(15, model="m@v3")))]),
    "one_sick_replica_rolls_back": (
        dict(bake_window_s=100.0, min_requests=5, p99_ratio=1.5,
             p99_slack_ms=0.0), [
            (0.0, _snap(_blk(), _fleet_blk({0: (0, 2), 1: (0, 2)},
                                           model="m@v2"))),
            (3.0, _snap(_blk(1000, bucket=2),
                        _fleet_blk({0: (1000, 2), 1: (5, 10)},
                                   model="m@v2")))]),
    "sick_replica_below_min_holds": (
        dict(bake_window_s=100.0, min_requests=5, p99_ratio=1.5,
             p99_slack_ms=0.0), [
            (0.0, _snap(_blk(), _fleet_blk({0: (0, 2), 1: (0, 2)},
                                           model="m@v2"))),
            (3.0, _snap(_blk(1000, bucket=2),
                        _fleet_blk({0: (1000, 2), 1: (3, 10)},
                                   model="m@v2")))]),
    "healthy_fleet_promotes": (
        dict(bake_window_s=100.0, min_requests=5, p99_ratio=1.5,
             p99_slack_ms=0.0), [
            (0.0, _snap(_blk(), _fleet_blk({0: (0, 2), 1: (0, 2)},
                                           model="m@v2"))),
            (101.0, _snap(_blk(1000, bucket=2),
                          _fleet_blk({0: (500, 2), 1: (480, 2)},
                                     model="m@v2")))]),
    "two_models": (dict(bake_window_s=5.0, min_requests=3), [
        (0.0, {"a": {"live": _blk(), "canary": _blk(model="a@v2")},
               "b": {"live": _blk(), "canary": _blk(model="b@v7")}}),
        (2.0, {"a": {"live": _blk(9), "canary": _blk(5, 5, model="a@v2")},
               "b": {"live": _blk(9), "canary": _blk(4, model="b@v7")}}),
        (6.0, {"a": {"live": _blk(9), "canary": None},
               "b": {"live": _blk(12), "canary": _blk(6, model="b@v7")}})]),
}


def _drive(pkg, policy, steps, metrics_path, refuse=None):
    reg = _FakeRegistry(metrics_path, refuse)
    state = {"t": 0.0, "snap": None}
    g = pkg.SLOGuardian(reg, pkg.GuardianPolicy(**policy),
                        clock=lambda: state["t"],
                        reader=lambda: state["snap"])
    ticks = []
    for t, snap in steps:
        state["t"], state["snap"] = t, copy.deepcopy(snap)
        ticks.append(g.tick())
    events = []
    if metrics_path is not None:
        with open(metrics_path) as fh:
            for line in fh:
                rec = json.loads(line)
                rec.pop("time", None)
                events.append(rec)
    return ticks, reg.actions, g.decisions, events


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_verdict_sequence_matches_jax(name, tmp_path):
    policy, steps = SCENARIOS[name]
    got = _drive(guardian, policy, steps, str(tmp_path / "port.jsonl"))
    want = _drive(jax_guardian, policy, steps, str(tmp_path / "jax.jsonl"))
    assert got == want
    assert any(got[0]) or name == "sick_replica_below_min_holds"


def test_refused_verdict_matches_jax(tmp_path):
    """The registry refusing the verdict (an operator resolved the
    rollout first): a ``failed`` decision that still wakes waiters."""
    policy, steps = dict(bake_window_s=1.0, min_requests=1), [
        (0.0, _snap(_blk(), _blk(model="m@v2"))),
        (2.0, _snap(_blk(4), _blk(4, model="m@v2")))]
    got = _drive(guardian, policy, steps, str(tmp_path / "p.jsonl"),
                 refuse="no canary to promote")
    want = _drive(jax_guardian, policy, steps, str(tmp_path / "j.jsonl"),
                  refuse="no canary to promote")
    assert got == want
    assert got[0][1][0]["action"] == "failed"
    assert got[0][1][0]["intended"] == "promote"


POLICIES = [dict(), dict(bake_window_s=0), dict(min_requests=0),
            dict(p99_ratio=0), dict(err_rate_margin=1.5),
            dict(bake_window_s=10, max_bake_s=5),
            dict(bake_window_s=2.0, p99_ceiling_ms=300, max_wedged=2),
            dict(bake_window_s=3, max_bake_s=3, min_requests=1)]


@pytest.mark.parametrize("kw", POLICIES)
def test_policy_validation_matches_jax(kw):
    def outcome(cls):
        try:
            p = cls(**kw)
        except ValueError as exc:
            return str(exc)
        return {k: getattr(p, k) for k in cls.__slots__}

    assert outcome(GuardianPolicy) == outcome(jax_guardian.GuardianPolicy)


@pytest.mark.parametrize("seed", range(4))
def test_admission_sequence_matches_jax(seed):
    rng = random.Random(seed)
    cap = rng.randint(1, 8)
    reserve = rng.choice([None, 0, rng.randint(0, cap)])
    budgets = (AdmissionBudget(cap, reserve),
               jax_guardian.AdmissionBudget(cap, reserve))
    trace = ([], [])
    for _ in range(200):
        op = rng.random()
        prio = rng.choice([None, PRIORITY_INTERACTIVE, PRIORITY_BATCH])
        for b, out in zip(budgets, trace):
            if op < 0.65:
                out.append(b.try_acquire(prio))
            else:
                b.release()
                out.append(b.snapshot()["in_use"])
    assert trace[0] == trace[1]
    assert budgets[0].snapshot() == budgets[1].snapshot()
    with pytest.raises(ValueError, match="capacity"):
        AdmissionBudget(0)
    with pytest.raises(ValueError, match="interactive_reserve"):
        AdmissionBudget(4, interactive_reserve=5)


# -- the port's guardian over a registry of fake engines ----------------------

def _releasable_hangs(monkeypatch):
    """Make a fault plan's ``hang`` wait on an event the test sets."""
    release = threading.Event()
    monkeypatch.setattr(faults, "time", types.SimpleNamespace(
        sleep=lambda s: release.wait(s)))
    return release


def _registry_with_canary():
    reg = ModelRegistry(gather_window_s=0.0, device="cpu")
    reg.add_model("m", {}, RAFTConfig(), engine=_FakeEngine())
    reg.deploy("m", {}, engine=_FakeEngine(), canary_fraction=0.5)
    return reg


def _wait_bake(g, model="m"):
    def opened():
        with g._lock:
            return model in g._bakes
    assert _wait(opened), "the guardian never opened the bake"


def test_hung_decision_leaves_routing_whole(monkeypatch):
    release = _releasable_hangs(monkeypatch)
    reg = _registry_with_canary()
    g = SLOGuardian(reg, GuardianPolicy(bake_window_s=0.05, max_bake_s=WAIT,
                                        min_requests=1), poll_s=0.01).start()
    try:
        _wait_bake(g)
        faults.arm([{"site": "guardian.decide", "kind": "hang",
                     "hang_s": WAIT, "count": 1}])
        futs = [reg.submit(Z, Z, route_key=i) for i in range(12)]
        for f in futs:
            f.result(WAIT)
        # the guardian reaches the site and hangs there: it decided
        # nothing, and the canary is whole, not half-rolled
        assert _wait(lambda: not faults.armed("guardian.decide"))
        assert g.wait_decision("m", timeout=0.2) is None
        canary = reg.health()["m"]["canary"]
        assert canary["state"] == "canary" and canary["fraction"] > 0
        reg.submit(Z, Z, route_key=1).result(WAIT)
        assert not g.stop(timeout=0.2)
    finally:
        release.set()
        g.stop(timeout=WAIT)
        reg.close()
    assert all(f.done() for f in futs)
    assert reg.snapshot()["m"]["accounting_ok"]


def test_raised_decision_survives_and_retries():
    reg = _registry_with_canary()
    g = SLOGuardian(reg, GuardianPolicy(bake_window_s=0.05, max_bake_s=WAIT,
                                        min_requests=1), poll_s=0.01).start()
    try:
        _wait_bake(g)
        faults.arm([{"site": "guardian.decide", "kind": "raise",
                     "count": 1}])
        for f in [reg.submit(Z, Z, route_key=i) for i in range(12)]:
            f.result(WAIT)
        d = g.wait_decision("m", timeout=WAIT)
        assert d is not None and d["action"] == "promote"
        assert g.errors >= 1
        assert g.stop(timeout=WAIT)
        assert reg.health()["m"]["canary"] is None
    finally:
        g.stop(timeout=WAIT)
        reg.close()
    assert reg.snapshot()["m"]["accounting_ok"]


def test_manual_tick_raises_fault_to_caller():
    reg = _registry_with_canary()
    t = [0.0]
    g = SLOGuardian(reg, GuardianPolicy(bake_window_s=1.0, min_requests=1),
                    clock=lambda: t[0])
    try:
        g.tick()
        key = next(k for k in range(50) if reg.routes_to_canary("m", k))
        reg.submit(Z, Z, route_key=key).result(WAIT)
        t[0] = 2.0
        faults.arm([{"site": "guardian.decide", "kind": "raise",
                     "count": 1}])
        with pytest.raises(FaultInjected):
            g.tick()
        faults.disarm()
        canary = reg.health()["m"]["canary"]
        assert canary is not None and canary["fraction"] > 0
    finally:
        reg.close()


def test_admission_starvation_drill_two_models():
    """A batch flood on one model (its engine held) cannot shed the
    other model's interactive traffic: the reserve admits every one,
    the flood's rejections land on it as ``admission_rejected``."""
    reg = ModelRegistry(gather_window_s=0.0, max_queue=64,
                        admission_budget=6,
                        admission_interactive_reserve=3, device="cpu")
    flood_eng = _FakeEngine()
    gate = threading.Event()
    flood_eng.gates[HW] = gate
    reg.add_model("flood", {}, RAFTConfig(), engine=flood_eng)
    reg.add_model("inter", {}, RAFTConfig(), engine=_FakeEngine())
    flood, rejected, inter_done = [], 0, 0
    try:
        for i in range(40):
            try:
                flood.append(reg.submit(Z, Z, model="flood",
                                        priority=PRIORITY_BATCH))
            except BackpressureError:
                rejected += 1
            if i % 5 == 4:
                f = reg.submit(Z, Z, model="inter",
                               priority=PRIORITY_INTERACTIVE)
                assert f.result(WAIT).flow.shape == (*HW, 2)
                inter_done += 1
        # the held flood took capacity - reserve tokens, and no more
        assert len(flood) == 3 and rejected == 37 and inter_done == 8
        gate.set()
        for f in flood:
            f.result(WAIT)
        snap = reg.snapshot()
        p = snap["inter"]["live"]["priority"][PRIORITY_INTERACTIVE]
        assert p["shed"] == 0 and p["completed"] == inter_done
        assert snap["flood"]["totals"]["admission_rejected"] == rejected
        assert snap["flood"]["accounting_ok"]
        assert snap["inter"]["accounting_ok"]
    finally:
        gate.set()
        reg.close()
    assert _wait(lambda: reg.admission_snapshot()["in_use"] == 0)


def test_budget_released_on_failed_submit():
    reg = ModelRegistry(gather_window_s=0.0, max_queue=1,
                        admission_budget=32, device="cpu")
    eng = _FakeEngine()
    gate = threading.Event()
    eng.gates[HW] = gate
    reg.add_model("m", {}, RAFTConfig(), engine=eng)
    futs, shed = [], 0
    try:
        futs.append(reg.submit(Z, Z))
        assert _wait(lambda: eng.calls)     # dispatched, held
        for _ in range(11):
            try:
                futs.append(reg.submit(Z, Z))
            except BackpressureError:
                shed += 1                   # the token must come back
        assert len(futs) == 2 and shed == 10
        assert reg.admission_snapshot()["in_use"] == 2
        gate.set()
        for f in futs:
            f.result(WAIT)
        assert _wait(lambda: reg.admission_snapshot()["in_use"] == 0)
    finally:
        gate.set()
        reg.close()


# -- the acceptance drills on CPU engines ---------------------------------------

SMALL = RAFTConfig(small=True)


@pytest.fixture(scope="module")
def engines():
    live = RAFT(SMALL, torch.Generator().manual_seed(0)).state_dict()
    canary = RAFT(SMALL, torch.Generator().manual_seed(7)).state_dict()

    def build(w):
        return RAFTEngine(w, SMALL, iters=1, envelope=[(2, *HW)],
                          warm_start=True, device="cpu")

    return live, canary, build


def _pair(rng):
    return (rng.rand(*HW, 3).astype(np.float32) * 255,
            rng.rand(*HW, 3).astype(np.float32) * 255)


def test_degraded_canary_auto_rolls_back(engines, tmp_path):
    """A canary whose dispatches fault at ``serve.request``: the guardian
    rolls it back inside the bake window on ``err_rate``; live outputs
    are bitwise unchanged through it; nothing strands."""
    live_w, canary_w, build = engines
    live_eng = build(live_w)
    xa, xb = _pair(np.random.RandomState(11))
    ref = live_eng.infer_batch(xa[None], xb[None])[0]
    mpath = str(tmp_path / "metrics.jsonl")
    reg = ModelRegistry(max_batch=2, gather_window_s=0.0,
                        metrics_path=mpath, device="cpu")
    reg.add_model("m", live_w, SMALL, iters=1, engine=live_eng)
    version = reg.deploy("m", canary_w, canary_fraction=0.5,
                         engine=build(canary_w))
    live_keys = [k for k in range(100)
                 if not reg.routes_to_canary("m", k)][:8]
    canary_keys = [k for k in range(100) if reg.routes_to_canary("m", k)][:6]
    t = [0.0]
    g = SLOGuardian(reg, GuardianPolicy(bake_window_s=100.0, min_requests=4,
                                        err_rate_margin=0.1),
                    clock=lambda: t[0])
    assert g.tick() == []
    futs = []
    for k in live_keys:
        futs.append(reg.submit(xa, xb, model="m", route_key=k))
        np.testing.assert_array_equal(futs[-1].result(WAIT).flow, ref)
    faults.arm([{"site": "serve.request", "kind": "raise",
                 "count": len(canary_keys)}])
    for k in canary_keys:
        futs.append(reg.submit(xa, xb, model="m", route_key=k))
        with pytest.raises(FaultInjected):
            futs[-1].result(WAIT)
    faults.disarm()
    t[0] = 5.0                        # well inside the bake window
    out = g.tick()
    assert len(out) == 1 and out[0]["action"] == "rollback"
    assert out[0]["version"] == version and "err_rate" in out[0]["reason"]
    assert out[0]["evidence"]["canary"]["failed"] == len(canary_keys)
    assert reg.health()["m"]["canary"] is None
    futs.append(reg.submit(xa, xb, model="m", route_key=live_keys[0]))
    np.testing.assert_array_equal(futs[-1].result(WAIT).flow, ref)
    assert all(f.done() for f in futs)
    reg.close()
    snap = reg.snapshot()["m"]
    assert snap["accounting_ok"] and snap["totals"]["submitted"] == len(futs)
    assert snap["totals"]["failed"] == len(canary_keys)
    rb = next(json.loads(line) for line in open(mpath)
              if '"guardian_rollback"' in line)
    assert rb["evidence"]["canary"]["err_rate"] == 1.0


def test_clean_canary_auto_promotes_capturing_nothing(engines):
    live_w, canary_w, build = engines
    live_eng, canary_eng = build(live_w), build(canary_w)
    xa, xb = _pair(np.random.RandomState(13))
    ref_canary = canary_eng.infer_batch(xa[None], xb[None])[0]
    program = live_eng._programs[(2, *HW)]
    captures = live_eng.capture_count
    reg = ModelRegistry(max_batch=2, gather_window_s=0.0, device="cpu")
    reg.add_model("m", live_w, SMALL, iters=1, engine=live_eng)
    reg.deploy("m", canary_w, canary_fraction=0.5, engine=canary_eng)
    t = [0.0]
    g = SLOGuardian(reg, GuardianPolicy(bake_window_s=10.0, min_requests=4,
                                        p99_ratio=50.0, p99_slack_ms=1e5,
                                        err_rate_margin=0.5),
                    clock=lambda: t[0])
    g.tick()
    futs = [reg.submit(xa, xb, model="m", route_key=k) for k in range(16)]
    for f in futs:
        f.result(WAIT)
    t[0] = 5.0
    assert g.tick() == []
    t[0] = 10.5
    out = g.tick()
    assert len(out) == 1 and out[0]["action"] == "promote"
    assert out[0]["mode"] == "weights_swap"
    assert live_eng._programs[(2, *HW)] is program
    assert live_eng.capture_count == captures
    f = reg.submit(xa, xb, model="m")
    np.testing.assert_array_equal(f.result(WAIT).flow, ref_canary)
    reg.close()
    assert reg.snapshot()["m"]["accounting_ok"]
    assert all(x.done() for x in futs)
