"""The port's multi-model registry (``raft_tpu_torch.serving.registry``)
against ``raft_tpu.serving.registry`` on the CPU, mirroring
``tests/test_registry.py`` without its AOT-store cases:

- ``canary_hash_fraction`` equal for 1000 keys of two models;
- one scripted rollout (two models, deploy, the one-rollout rule, a
  failed deploy at ``registry.load``, rollback, promote, close) through
  both registries over fake engines: the same routing of every token,
  the same versions, states, errors, per-model accounting and rollout
  events;
- the lifecycle on the port's fake engines: rollback drains with zero
  futures stranded, a session sticks to one variant, a rollout
  cold-restarts a session's recurrence, ``artifact_dir=`` raises naming
  M11c;
- the two-model drill on CPU engines with the small trained fixture (a
  fast tier at 1 refinement step beside the model at 2, and a canary of
  perturbed fixture weights): each future within 5e-4 px of
  ``raft_tpu``'s registry on the same inputs and route keys; a same-arch
  promote captures nothing;
- ``cli/serve_bench``'s registry drill: summary keys equal to the JAX
  drill's for the same flags, and the ``--models`` CLI with the guardian,
  and its ``--chaos`` rounds, on the CPU.
"""

import json
import os.path as osp
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.serving import registry as jax_registry
from raft_tpu.serving.engine import RAFTEngine as JaxEngine
from raft_tpu.testing import faults as jax_faults
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.serving import RAFTEngine, VideoSession, registry
from raft_tpu_torch.serving.registry import (DeployError, ModelRegistry,
                                             RolloutInProgress, UnknownModel,
                                             canary_hash_fraction)
from raft_tpu_torch.testing import faults
from raft_tpu_torch.tools.convert import state_dict_from_flax
from tests.test_scheduler import _FakeEngine as _JaxFakeEngine
from tests.test_torch_scheduler import _FakeEngine, _pad8, _wait

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained")
HW = (32, 32)
Z = np.zeros((*HW, 3), np.float32)
TOL = 5e-4
WAIT = 120.0


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    faults.disarm()
    jax_faults.disarm()


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the routing hash ----------------------------------------------------------

@pytest.mark.parametrize("model", ["m", "basic", "small@v2"])
def test_canary_hash_matches_jax(model):
    keys = list(range(500)) + [f"session-{k}" for k in range(500)]
    vals = [canary_hash_fraction(model, k) for k in keys]
    assert vals == [jax_registry.canary_hash_fraction(model, k)
                    for k in keys]
    assert all(0.0 <= v < 1.0 for v in vals)
    assert abs(sum(v < 0.25 for v in vals) / len(vals) - 0.25) < 0.04


# -- one scripted rollout through both registries -----------------------------

def _script(pkg, fake, faults_mod, tmp_path):
    """Drive one rollout; return everything observable about it."""
    mpath = str(tmp_path / "metrics.jsonl")
    kw = {"device": "cpu"} if pkg is registry else {}
    reg = pkg.ModelRegistry(gather_window_s=0.0, metrics_path=mpath, **kw)
    out = {}
    reg.add_model("a", {}, engine=fake())
    reg.add_model("b", {}, engine=fake())
    errors = []
    for call in (lambda: reg.submit(Z, Z),
                 lambda: reg.submit(Z, Z, model="nope"),
                 lambda: reg.add_model("a", {}, engine=fake()),
                 lambda: reg.rollback("a"),
                 lambda: reg.deploy("a", {}, engine=fake(),
                                    canary_fraction=1.5)):
        try:
            call()
        except Exception as exc:
            errors.append((type(exc).__name__, str(exc)))
    out["errors"] = errors
    out["v2"] = reg.deploy("a", {}, engine=fake(), canary_fraction=0.3)
    try:
        reg.deploy("a", {}, engine=fake())
    except Exception as exc:
        out["second_deploy"] = (type(exc).__name__, str(exc))
    tokens = list(range(64)) + [f"user-{k}" for k in range(32)]
    out["routes"] = [reg.routes_to_canary("a", t) for t in tokens]
    out["versions"] = [reg.variant_version("a", t) for t in tokens]
    futs = [reg.submit(Z, Z, model="a", route_key=t) for t in tokens[:24]]
    futs += [reg.submit(Z, Z, model="b") for _ in range(5)]
    for f in futs:
        f.result(WAIT)
    out["health"] = {m: {k: ({x: v[x] for x in ("version", "state",
                                                 "fraction") if x in v}
                             if v else v) for k, v in blk.items()}
                     for m, blk in reg.health().items()}
    out["rollback"] = reg.rollback("a")
    faults_mod.arm([{"site": "registry.load", "kind": "raise"}])
    try:
        reg.deploy("a", {}, engine=fake(), canary_fraction=0.5)
    except Exception as exc:
        out["failed_deploy"] = type(exc).__name__
    faults_mod.disarm()
    out["after_failure"] = reg.health()["a"]["canary"]
    out["v4"] = reg.deploy("b", {}, engine=fake(), canary_fraction=0.5)
    out["promote"] = reg.promote("b")
    for f in [reg.submit(Z, Z, model="b", route_key=k) for k in range(6)]:
        f.result(WAIT)
    reg.close()
    snap = reg.snapshot()
    out["totals"] = {m: (blk["totals"], blk["accounting_ok"],
                         len(blk["retired"])) for m, blk in snap.items()}
    events = []
    with open(mpath) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("kind") == "serving_event":
                rec.pop("time", None)
                events.append(rec)
    out["events"] = events
    return out


def test_scripted_rollout_matches_jax(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = _script(registry, _FakeEngine, faults, tmp_path / "p")
    want = _script(jax_registry, _JaxFakeEngine, jax_faults, tmp_path / "j")
    assert got == want
    assert got["failed_deploy"] == "DeployError"
    assert got["after_failure"] is None
    assert any(got["routes"]) and not all(got["routes"])
    assert {e["event"] for e in got["events"]} >= {
        "model_state", "model_deploy", "model_deploy_failed",
        "model_rollback", "model_promote", "registry_closed"}


# -- the lifecycle on the port's fakes ----------------------------------------

class _WarmFakeEngine(_FakeEngine):
    """The fake with the warm-start surface (a ``flow_low`` output)."""

    warm_start = True

    def infer_batch_async(self, i1, i2, flow_init=None, return_low=False,
                          low_device=False):
        inner = super().infer_batch_async(i1, i2)

        class _P:
            bucket = inner.bucket
            h2d_bytes = inner.h2d_bytes
            t_ready = None

            def fetch(p):
                flow = inner.fetch()
                b, h, w = flow.shape[:3]
                p.t_ready = time.monotonic()
                return flow, np.zeros((b, _pad8(h) // 8, _pad8(w) // 8, 2),
                                      np.float32)

        return _P()


def test_rollback_drains_canary_zero_stranded():
    ceng = _FakeEngine()
    gate = threading.Event()
    ceng.gates[HW] = gate
    reg = ModelRegistry(gather_window_s=0.0, max_batch=2, device="cpu")
    reg.add_model("m", {}, engine=_FakeEngine())
    reg.deploy("m", {}, engine=ceng, canary_fraction=1.0)
    futs = [reg.submit(Z, Z, route_key=i) for i in range(12)]
    assert _wait(lambda: ceng.calls)
    t = threading.Thread(target=reg.rollback, args=("m",))
    t.start()
    # routing is off before the drain: new traffic already serves live
    assert _wait(lambda: reg.health()["m"]["canary"] is None)
    reg.submit(Z, Z, route_key=3).result(WAIT)
    gate.set()
    t.join(WAIT)
    assert not t.is_alive()
    assert all(f.done() and f.exception() is None for f in futs)
    reg.close()
    snap = reg.snapshot()["m"]
    assert snap["accounting_ok"] and snap["totals"]["completed"] == 13
    assert snap["retired"][0]["completed"] == 12


def test_session_sticks_to_one_variant():
    reg = ModelRegistry(gather_window_s=0.0, device="cpu")
    reg.add_model("m", {}, engine=_FakeEngine())
    reg.deploy("m", {}, engine=_FakeEngine(), canary_fraction=0.5)
    m = reg._models["m"]

    def run_session(**kw):
        live0 = m.live.scheduler.metrics.submitted
        can0 = m.canary.scheduler.metrics.submitted
        sess = VideoSession(reg, warm_start=False, **kw)
        for _ in range(4):
            f = sess.submit_frame(Z)
            if f is not None:
                f.result(WAIT)
        return (m.live.scheduler.metrics.submitted - live0,
                m.canary.scheduler.metrics.submitted - can0)

    keys = [f"s{i}" for i in range(8)]
    sides = {k: canary_hash_fraction("m", k) < 0.5 for k in keys}
    assert len(set(sides.values())) == 2
    for k in keys:
        assert run_session(route_key=k) == ((0, 3) if sides[k] else (3, 0))
    assert run_session() in ((3, 0), (0, 3))
    with pytest.raises(ValueError, match="ModelRegistry"):
        VideoSession(m.live.scheduler, model="m")
    reg.close()


def test_rollout_cold_restarts_session_recurrence():
    reg = ModelRegistry(gather_window_s=0.0, device="cpu")
    reg.add_model("m", {}, engine=_WarmFakeEngine())
    reg.deploy("m", {}, engine=_WarmFakeEngine(), canary_fraction=1.0)
    sess = VideoSession(reg)
    for _ in range(3):
        f = sess.submit_frame(Z)
        if f is not None:
            f.result(WAIT)
    assert sess.warm_submits == 1
    reg.rollback("m")                 # the stream moves to live
    sess.submit_frame(Z).result(WAIT)
    assert sess.warm_submits == 1     # cold: no canary flow_low crossed
    sess.submit_frame(Z).result(WAIT)
    assert sess.warm_submits == 2
    reg.close()


def test_artifact_store_is_m11c(tmp_path):
    reg = ModelRegistry(device="cpu")
    with pytest.raises(NotImplementedError, match="M11c"):
        reg.add_model("m", {}, engine=_FakeEngine(),
                      artifact_dir=str(tmp_path))
    reg.add_model("m", {}, engine=_FakeEngine())
    with pytest.raises(NotImplementedError, match="M11c"):
        reg.deploy("m", {}, engine=_FakeEngine(),
                   artifact_dir=str(tmp_path))
    assert reg.health()["m"]["canary"] is None
    reg.close()


# -- the two-model drill on CPU engines, held to raft_tpu ----------------------

@pytest.fixture(scope="module")
def fixture_weights():
    with open(FIXTURE + ".msgpack", "rb") as fh:
        tree = serialization.msgpack_restore(fh.read())
    rng = np.random.RandomState(5)
    # the canary: the fixture with every weight moved by up to 0.1%
    canary = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * (1 + 1e-3 * rng.uniform(
            -1, 1, np.shape(x)).astype(np.float32)), tree)
    out = []
    for t in (tree, canary):
        jt = jax.tree_util.tree_map(jnp.asarray, t)
        out.append((jt, state_dict_from_flax(jt)))
    return out


def _drill_pairs(seed, n):
    """``n`` integer-valued frame pairs of a texture moved (1, 2) px."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        base = np.floor(rng.rand(HW[0] + 4, HW[1] + 4, 3) * 256).astype(
            np.float32)
        out.append((base[:HW[0], :HW[1]], base[2:HW[0] + 2, 4:HW[1] + 4]))
    return out


MODELS = (("small", 2), ("fast", 1))


def _registry_drill(pkg, weights, pairs, engines):
    kw = {"device": "cpu"} if pkg is registry else {}
    reg = pkg.ModelRegistry(gather_window_s=0.0, max_batch=2, **kw)
    for name, iters in MODELS:
        reg.add_model(name, weights[0], engine=engines[name])
    reg.deploy("small", weights[1], canary_fraction=0.5,
               engine=engines["canary"])
    futs = []
    for k, (a, b) in enumerate(pairs):
        name = MODELS[k % 2][0]
        prio = ("interactive", "batch")[(k // 2) % 2]
        futs.append(reg.submit(a, b, model=name, priority=prio,
                               route_key=f"r{k}"))
    flows = [f.result(WAIT).flow for f in futs]
    routed = [reg.routes_to_canary("small", f"r{k}")
              for k in range(len(pairs))]
    promote = reg.promote("small")
    after = reg.submit(*pairs[0], model="small").result(WAIT).flow
    reg.close()
    return flows, routed, promote, after, reg.snapshot()


def test_two_model_drill_matches_jax(fixture_weights):
    pairs = _drill_pairs(9, 12)
    env = [(2, *HW)]
    jw = [w[0] for w in fixture_weights]
    pw = [w[1] for w in fixture_weights]
    jeng = {"small": JaxEngine(jw[0], JaxConfig(small=True), iters=2,
                               envelope=env, precompile=True),
            "fast": JaxEngine(jw[0], JaxConfig(small=True), iters=1,
                              envelope=env, precompile=True),
            "canary": JaxEngine(jw[1], JaxConfig(small=True), iters=2,
                                envelope=env, precompile=True)}
    small = RAFTConfig(small=True)
    peng = {"small": RAFTEngine(pw[0], small, iters=2, envelope=env,
                                device="cpu"),
            "fast": RAFTEngine(pw[0], small, iters=1, envelope=env,
                               device="cpu"),
            "canary": RAFTEngine(pw[1], small, iters=2, envelope=env,
                                 device="cpu")}
    captures = peng["small"].capture_count
    want = _registry_drill(jax_registry, jw, pairs, jeng)
    got = _registry_drill(registry, pw, pairs, peng)
    assert got[1] == want[1] and any(got[1]) and not all(got[1])
    for g, w in zip(got[0], want[0]):
        assert g.shape == (*HW, 2)
        assert float(np.abs(g - np.asarray(w)).max()) <= TOL
    # a same-arch promote is a weight swap: nothing is captured, and the
    # live engine now serves the canary's weights
    assert got[2] == {"model": "small", "version": "v2",
                      "mode": "weights_swap"} == want[2]
    assert peng["small"].capture_count == captures
    canary_flow = peng["canary"].infer_batch(*[x[None] for x in pairs[0]])
    np.testing.assert_array_equal(got[3], canary_flow[0])
    assert float(np.abs(got[3] - np.asarray(want[3])).max()) <= TOL
    for name in ("small", "fast"):
        g, w = got[4][name], want[4][name]
        assert g["totals"] == w["totals"] and g["accounting_ok"]


# -- cli/serve_bench's registry drills ----------------------------------------

def test_registry_drill_summary_keys_match_jax():
    from raft_tpu.cli.serve_bench import run_registry_drill as jax_drill
    from raft_tpu_torch.cli.serve_bench import run_registry_drill

    kw = dict(shapes=[HW], requests=12, submitters=2, bucket_batch=2,
              priority_mix=(1, 1), canary_fraction=0.5,
              canary_variables={}, gather_window_s=0.0,
              admission_budget=64)
    s = run_registry_drill(
        [("a", {}, RAFTConfig()), ("b", {}, RAFTConfig())],
        engines={"a": _FakeEngine(), "b": _FakeEngine()},
        canary_engine=_FakeEngine(), device="cpu", **kw)
    js = jax_drill([("a", {}, JaxConfig()), ("b", {}, JaxConfig())],
                   engines={"a": _JaxFakeEngine(), "b": _JaxFakeEngine()},
                   canary_engine=_JaxFakeEngine(), **kw)
    assert set(s) == set(js)
    for k in ("models", "priorities", "canary", "admission"):
        assert set(s[k]) == set(js[k]), k
    assert set(s["models"]["a"]) == set(js["models"]["a"])
    assert s["canary"]["resolution"] == js["canary"]["resolution"] \
        == "engine_swap"
    assert s["served"] == s["accepted"] == 12 and not s["stranded"]
    assert s["accounting_ok"] and s["admission"]["in_use"] == 0
    assert {m: b["submitted"] for m, b in s["models"].items()} == {
        m: b["submitted"] for m, b in js["models"].items()}


def test_serve_bench_models_cli_with_guardian(capsys):
    from raft_tpu_torch.cli import serve_bench

    serve_bench.main(["--device", "cpu", "--models", "small,basic",
                      "--shapes", "32x32,24x40", "--requests", "12",
                      "--iters", "1", "--bucket-batch", "2", "--canary",
                      "0.5", "--priority-mix", "1:1", "--guardian",
                      "--bake-ms", "200", "--admission-budget", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["registry"] and out["model_names"] == ["small", "basic"]
    assert out["served"] == out["accepted"] == 12 and not out["stranded"]
    assert out["accounting_ok"] and out["abandoned_inflight"] == 0
    assert out["canary"]["resolution"] in ("guardian_promote",
                                           "guardian_rollback")
    assert set(out["priorities"]) == {"interactive", "batch"}
    assert out["admission"]["capacity"] == 16


def test_serve_bench_registry_chaos_cli(capsys):
    from raft_tpu_torch.cli import serve_bench

    serve_bench.main(["--device", "cpu", "--models", "small,basic",
                      "--shapes", "32x32,24x40", "--requests", "12",
                      "--iters", "1", "--bucket-batch", "2", "--chaos", "1",
                      "--guardian", "--bake-ms", "200", "--seed", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["violations"] == [] and out["registry"]
    assert out["deploys"]["auto_rolled_back"] >= 1   # round 0 is forced
    assert out["per_round"][-1]["canary"]["resolution"] == \
        "guardian_promote"
    assert out["executables"] == out["documented_buckets"]
