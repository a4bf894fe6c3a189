"""Follower ranks (``parallel/follow.py``): the scheduler's ``"shard"``
route and its replica lanes over a multi-rank mesh, rank 0 leading and
every other rank following, against the port's one-device engine and
JAX's ``RAFT``.

Ranks are gloo processes on the CPU, launched as
``tests/test_torch_spatial.py`` launches them: a ``FileStore`` under the
test's directory, ``jax``, ``flax`` and ``raft_tpu`` blocked in each, each
killed after WORKER_TIMEOUT_S. Two worlds run at once, 2 ranks (mesh
``(1, 2)``) and 4 (mesh ``(2, 2)``); each rank runs :func:`worker_main`
of this module, while this process computes the references. Rank 0 runs
``MicroBatchScheduler`` over a leading engine, with ``shard_px_threshold``
set to the shard bucket's pixels; every other rank runs
``follow.follow`` on its copy of the engine and records each dispatch's
flow. Sessions, one channel each:

- ``small``: the small trained fixture at iters 12, a fleet of one lane
  growing to three. Wave A: two 128x64 pairs on the ``"shard"`` route
  (bucket ``(2, 128, 64)``, pinned to the primary lane) and four 64x96
  pairs on the ``"replicate"`` route (two micro-batches, bucket ``(2, 64,
  96)``, on replica lanes grown on sibling meshes or on the primary);
  ``update_weights`` to a second weight set; wave B, the same pairs. Then
  an idle retirement; a wedge verdict on the primary lane (its bucket
  dropped on every rank) and one on a replica lane (dropped, and the
  replica closed on every rank); one more replicate pair, on a lane
  grown or reactivated for it; a clean close.
- ``basic``: the basic model at random init, iters 1, the two 128x64
  pairs on the ``"shard"`` route.
- ``depth2``: the small fixture at iters 2, wire u8, under one lane at
  ``pipeline_depth=2`` (no placement): the followers' dispatches in the
  primary's dispatch order.
- ``kill`` (world 2): the basic model with two lanes; rank 1 is SIGKILLed
  with futures in flight: each future settles once, with an error, and
  the scheduler closes.

Each future is held to the port's one-device engine on its own
micro-batch and bucket (SMALL_TOL, BASIC_TOL: PR 12's), the small
fixture's shard futures of wave A also to JAX's ``RAFT``; every rank's
flows are bitwise the primary's futures; every rank's tables and weight
versions are equal.
"""

import json
import os
import os.path as osp
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models import RAFT

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained")
WORKER_TIMEOUT_S = 150
SMALL_TOL = 5e-4
BASIC_TOL = 2e-3
SHARD_HW = (128, 64)
REPL_HW = (64, 96)
SHARD_PX = SHARD_HW[0] * SHARD_HW[1]
SHARD_BUCKET = (2, 128, 64)
REPL_BUCKET = (2, 64, 96)
N_SHARD = 2
N_REPL = 4
MAX_BATCH = 2
ITERS = {"small": 12, "basic": 1, "depth2": 2, "kill": 1}
#: the depth-2 session ships u8 frames: each follower's block of both
#: frames then ends on an odd byte, and its ``flow_init``-free payload
#: unpacks from there
WIRE = {"depth2": "u8"}
#: the watchdog's deadline under traffic (far above a CPU dispatch here),
#: and the one the wedges run under
DISPATCH_TIMEOUT_S = 60.0
WEDGE_TIMEOUT_S = 1.0
RETIRE_S = 1.0
GATHER_S = 0.3
#: the kill drill's watchdog deadline, and the margin over it a future
#: may take to settle after the SIGKILL
KILL_TIMEOUT_S = 10.0
KILL_MARGIN_S = 10.0
KILL_REQUESTS = 8
#: a rank's exit code once its results are saved (``os._exit``: a process
#: group a dead peer left cannot be torn down cleanly)
RANK_DONE_EXIT_CODE = 0


def _pairs(hw, n, seed):
    """``n`` pairs of ``hw`` frames: smooth random images, the second
    shifted by (2, 3) px."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        small = rng.rand(hw[0] // 8 + 2, hw[1] // 8 + 2, 3)
        big = np.kron(small, np.ones((8, 8, 1)))[:hw[0] + 2, :hw[1] + 3]
        img = (255 * big).astype(np.float32)
        out.append((img[2:2 + hw[0], 3:3 + hw[1]].copy(),
                    img[:hw[0], :hw[1]].copy()))
    return out


def _inputs():
    return {"shard": _pairs(SHARD_HW, N_SHARD, 1),
            "repl": _pairs(REPL_HW, N_REPL, 2),
            "extra": _pairs(REPL_HW, 1, 3)}


def _weights(name):
    """``(config, state dict)``: the small fixture (``small``), the same
    scaled by 0.9 (``small_b``, wave B's), the basic model at random init
    (``basic``)."""
    if name == "basic":
        cfg = RAFTConfig()
        return cfg, RAFT(cfg, torch.Generator().manual_seed(0)).state_dict()
    from raft_tpu_torch.tools.convert import load_pth

    cfg = RAFTConfig(small=True)
    state = load_pth(FIXTURE + ".pth", cfg).state_dict()
    if name == "small_b":
        state = {k: v * 0.9 if v.is_floating_point() else v
                 for k, v in state.items()}
    return cfg, state


# -- the ranks ------------------------------------------------------------


def _events(path):
    if not osp.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh if '"event"' in line]


def _submit(sched, pairs):
    return [sched.submit(a, b) for a, b in pairs]


def _flows(futs, timeout=WORKER_TIMEOUT_S):
    return [f.result(timeout=timeout).flow for f in futs]


def _engine_state(eng):
    return {"tables": eng.tables(), "weights_version": eng.weights_version,
            "retired": eng._closed}


def _hang(eng, release):
    """Make ``eng``'s next dispatch block until ``release`` is set (and
    then fail): a wedge after the bucket was routed. Returns the undo."""
    real = eng.infer_batch_async

    def undo():
        eng.infer_batch_async = real

    def hung(*a, **k):
        undo()
        release.wait(WORKER_TIMEOUT_S)
        raise RuntimeError("released after the wedge verdict")
    eng.infer_batch_async = hung
    return undo


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("condition not met")
        time.sleep(0.05)


def _primary_small(eng, d):
    from raft_tpu_torch.parallel import follow
    from raft_tpu_torch.parallel.placement import Placement
    from raft_tpu_torch.serving.scheduler import MicroBatchScheduler

    channel = follow.lead(eng)
    path = osp.join(d, "metrics_small.jsonl")
    sched = MicroBatchScheduler(
        eng, max_batch=MAX_BATCH, gather_window_s=GATHER_S,
        dispatch_timeout_s=DISPATCH_TIMEOUT_S,
        replica_idle_retire_s=RETIRE_S, metrics_path=path,
        placement=Placement(eng, replicas=1, ceiling=3,
                            shard_px_threshold=SHARD_PX))
    x = _inputs()
    out = {"routes": {k: sched.placement.decide(hw) for k, hw in
                      (("shard", SHARD_HW), ("repl", REPL_HW))}}
    for wave, weights in (("a", None), ("b", "small_b")):
        if weights is not None:
            sched.update_weights(_weights(weights)[1])
        futs = {k: _submit(sched, x[k]) for k in ("shard", "repl")}
        out[wave] = {k: _flows(f) for k, f in futs.items()}
    # idle: the grown lanes retire back to the floor (the primary's)
    _wait(lambda: len(sched._lanes) > 1 and not any(
        ln.active for ln in sched._lanes[1:]), 30)
    # the watchdog's deadline for the wedges alone (no other traffic):
    # a shard pair wedges the primary lane; then, the primary quarantined,
    # a replicate pair reactivates a retired replica and wedges it
    sched.dispatch_timeout_s = WEDGE_TIMEOUT_S
    wedged = []
    for lanes, pair in (([0], x["shard"][0]), (range(1, 3), x["extra"][0])):
        release = threading.Event()
        undo = [_hang(sched._lanes[k].engine, release) for k in lanes
                if k < len(sched._lanes)]
        fut = sched.submit(*pair)
        try:
            fut.result(timeout=30)
            wedged.append(None)
        except Exception as exc:  # noqa: BLE001 — the verdict's error
            wedged.append(type(exc).__name__)
        for u in undo:
            u()
        release.set()
    sched.dispatch_timeout_s = DISPATCH_TIMEOUT_S
    out["wedged"] = wedged
    out["after"] = _flows(_submit(sched, x["extra"]))
    out["lanes"] = [(ln.index, ln.engine._eid, ln.quarantined)
                    for ln in sched._lanes]
    out["engines"] = {e._eid: _engine_state(e)
                      for e in sched.placement.engines}
    sched.close()
    out["events"] = [e["event"] + ("_grown" if e.get("grown") else "")
                     for e in _events(path)]
    out["channel"] = dict(channel.stats)
    out["closed"] = channel.closed
    return out


def _primary_basic(eng, d):
    from raft_tpu_torch.parallel import follow
    from raft_tpu_torch.parallel.placement import Placement
    from raft_tpu_torch.serving.scheduler import MicroBatchScheduler

    follow.lead(eng)
    sched = MicroBatchScheduler(
        eng, max_batch=MAX_BATCH, gather_window_s=GATHER_S,
        placement=Placement(eng, replicas=1, ceiling=1,
                            shard_px_threshold=SHARD_PX))
    flows = _flows(_submit(sched, _inputs()["shard"]))
    out = {"shard": flows, "engines": {0: _engine_state(eng)}}
    sched.close()
    return out


def _primary_depth2(eng, d):
    from raft_tpu_torch.parallel import follow
    from raft_tpu_torch.serving.scheduler import MicroBatchScheduler

    follow.lead(eng)
    sched = MicroBatchScheduler(eng, max_batch=MAX_BATCH,
                                gather_window_s=GATHER_S, pipeline_depth=2)
    flows = _flows(_submit(sched, _inputs()["repl"]))
    out = {"repl": flows, "engines": {0: _engine_state(eng)}}
    sched.close()
    return out


def _primary_kill(eng, d, pids):
    from raft_tpu_torch.parallel import follow
    from raft_tpu_torch.parallel.placement import Placement
    from raft_tpu_torch.serving.scheduler import MicroBatchScheduler

    channel = follow.lead(eng)
    sched = MicroBatchScheduler(
        eng, max_batch=1, gather_window_s=0.0,
        dispatch_timeout_s=KILL_TIMEOUT_S,
        placement=Placement(eng, replicas=2, shard_px_threshold=SHARD_PX))
    x = _inputs()
    pairs = (x["shard"] + x["repl"]) * 2
    settled = []
    futs = []
    for a, b in pairs[:KILL_REQUESTS]:
        f = sched.submit(a, b)
        f.add_done_callback(lambda f: settled.append(
            (time.monotonic(), type(f.exception()).__name__
             if f.exception() is not None else None)))
        futs.append(f)
    _wait(lambda: channel.stats.get("infer", [0])[0] >= 1, 60)
    t_kill = time.monotonic()
    os.kill(pids[1], signal.SIGKILL)
    for f in futs:
        try:
            f.result(timeout=KILL_TIMEOUT_S + KILL_MARGIN_S)
        except Exception:  # noqa: BLE001 — the drill's errors
            pass
    t0 = time.monotonic()
    sched.close(timeout=30)
    return {"settled": [(t - t_kill, e) for t, e in settled],
            "close_s": time.monotonic() - t0,
            "failed": repr(channel.failed), "futures": len(futs)}


def _follower(eng, session, outs):
    from raft_tpu_torch.parallel import follow

    got = []
    ends = follow.follow(eng, on_output=lambda eid, f: got.append((eid, f)))
    outs[session] = {"outputs": got, "engines": ends}


def worker_main(d: str, rank: int, world: int) -> None:
    """One rank of a world of ``world`` gloo processes: every session,
    its results saved to ``d/rank<r>.pt`` (the kill drill's to
    ``d/kill.pt``)."""
    import torch.distributed as tdist

    from raft_tpu_torch.parallel import distributed
    from raft_tpu_torch.parallel.mesh import make_mesh
    from raft_tpu_torch.serving import RAFTEngine

    torch.set_num_threads(1)
    distributed.initialize(f"file://{d}/store", world, rank, backend="gloo")
    pids = [None] * world
    tdist.all_gather_object(pids, os.getpid())
    mesh = make_mesh(spatial=2)
    out = {"mesh": repr(mesh)}
    sessions = (("small", "small", _primary_small),
                ("basic", "basic", _primary_basic),
                ("depth2", "small", _primary_depth2))
    for session, weights, primary in sessions:
        cfg, state = _weights(weights)
        eng = RAFTEngine(state, cfg, iters=ITERS[session], mesh=mesh,
                         wire=WIRE.get(session, "f32"), device="cpu")
        if rank == 0:
            out[session] = primary(eng, d)
        else:
            _follower(eng, session, out)
    torch.save(out, osp.join(d, f"rank{rank}.pt"))
    if world == 2:
        cfg, state = _weights("basic")
        eng = RAFTEngine(state, cfg, iters=ITERS["kill"], mesh=mesh,
                         device="cpu")
        if rank == 0:
            torch.save(_primary_kill(eng, d, pids), osp.join(d, "kill.pt"))
        else:
            _follower(eng, "kill", {})
    sys.stdout.flush()
    os._exit(RANK_DONE_EXIT_CODE)


WORKER = """
import sys
BLOCKED = ("jax", "flax", "raft_tpu")
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Blocker())
sys.path.insert(0, sys.argv[1])
import test_torch_follow
test_torch_follow.worker_main(sys.argv[2], int(sys.argv[3]),
                              int(sys.argv[4]))
"""


def _start(d: str, world: int):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, osp.join(REPO, "tests"), d, str(r),
         str(world)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _finish(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:         # a rank that failed leaves the others hung
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


# -- the references, in this process ---------------------------------------


def _one_device(name, bucket, iters, pairs, wire="f32"):
    """The port's one-device engine on ``pairs`` as one micro-batch in
    ``bucket``."""
    from raft_tpu_torch.serving import RAFTEngine

    cfg, state = _weights(name)
    eng = RAFTEngine(state, cfg, iters=iters, envelope=[bucket],
                     precompile=False, wire=wire, device="cpu")
    return list(eng.infer_batch(np.stack([a for a, _ in pairs]),
                                np.stack([b for _, b in pairs])))


def _port_references():
    x = _inputs()
    out = {}
    for wave, name in (("a", "small"), ("b", "small_b")):
        out[wave] = {
            "shard": _one_device(name, SHARD_BUCKET, ITERS["small"],
                                 x["shard"]),
            "repl": sum((_one_device(name, REPL_BUCKET, ITERS["small"],
                                     x["repl"][i:i + MAX_BATCH])
                         for i in range(0, N_REPL, MAX_BATCH)), [])}
    out["after"] = _one_device("small_b", REPL_BUCKET, ITERS["small"],
                               x["extra"])
    out["basic"] = _one_device("basic", SHARD_BUCKET, ITERS["basic"],
                               x["shard"])
    out["depth2"] = sum((_one_device("small", REPL_BUCKET, ITERS["depth2"],
                                     x["repl"][i:i + MAX_BATCH],
                                     WIRE["depth2"])
                         for i in range(0, N_REPL, MAX_BATCH)), [])
    return out


def _jax_reference():
    """JAX's ``RAFT`` on the small fixture: the shard pairs, unsharded."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from raft_tpu.config import RAFTConfig as JaxConfig
    from raft_tpu.evaluation.evaluate import make_forward

    with open(FIXTURE + ".msgpack", "rb") as fh:
        variables = jax.tree_util.tree_map(
            jnp.asarray, serialization.msgpack_restore(fh.read()))
    fwd, _ = make_forward(JaxConfig(small=True), ITERS["small"])
    x = _inputs()["shard"]
    _, up = fwd(variables, np.stack([a for a, _ in x]),
                np.stack([b for _, b in x]))
    return list(np.asarray(up))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in (2, 4)}
    procs = {w: _start(d, w) for w, d in dirs.items()}
    try:
        port = _port_references()
        jax_ = _jax_reference()
    finally:
        ends = {w: _finish(procs[w]) for w in procs}
        torch.set_num_threads(n)
    for w, res in ends.items():
        for r, (rc, text) in enumerate(res):
            if not (w == 2 and r == 1):
                assert rc == 0, f"world {w} rank {r}: {text[-4000:]}"
    ranks = {w: [torch.load(osp.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(w)] for w, d in dirs.items()}
    kill = torch.load(osp.join(dirs[2], "kill.pt"), weights_only=False)
    return {"ranks": ranks, "port": port, "jax": jax_, "ends": ends,
            "kill": kill}


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


WORLDS = [2, 4]


# -- routes -----------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_placement_routes_by_the_threshold(runs, world):
    routes = runs["ranks"][world][0]["small"]["routes"]
    assert routes == {"shard": "shard", "repl": "replicate"}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("wave", ["a", "b"])
def test_shard_route_matches_one_device(runs, world, wave):
    got = runs["ranks"][world][0]["small"][wave]["shard"]
    want = runs["port"][wave]["shard"]
    assert len(got) == N_SHARD
    for g, w in zip(got, want):
        assert g.shape == SHARD_HW + (2,)
        assert _err(g, w) <= SMALL_TOL
    assert max(float(np.abs(w).max()) for w in want) > 1.0


@pytest.mark.parametrize("world", WORLDS)
def test_shard_route_small_fixture_matches_jax(runs, world):
    got = runs["ranks"][world][0]["small"]["a"]["shard"]
    for g, w in zip(got, runs["jax"]):
        np.testing.assert_allclose(g, w, atol=SMALL_TOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_route_basic_model_matches_one_device(runs, world):
    got = runs["ranks"][world][0]["basic"]["shard"]
    for g, w in zip(got, runs["port"]["basic"]):
        assert _err(g, w) <= BASIC_TOL


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("wave", ["a", "b"])
def test_replicate_route_matches_its_micro_batch(runs, world, wave):
    got = runs["ranks"][world][0]["small"][wave]["repl"]
    want = runs["port"][wave]["repl"]
    assert len(got) == N_REPL
    for g, w in zip(got, want):
        assert g.shape == REPL_HW + (2,)
        assert _err(g, w) <= SMALL_TOL


@pytest.mark.parametrize("world", WORLDS)
def test_weight_swap_mid_stream(runs, world):
    """Wave B ran the second weight set: each future within the tolerance
    of its own set's forward and far from the other's."""
    small = runs["ranks"][world][0]["small"]
    port = runs["port"]
    for k in ("shard", "repl"):
        for g, a, b in zip(small["b"][k], port["a"][k], port["b"][k]):
            assert _err(a, b) > 100 * SMALL_TOL
            assert _err(g, b) <= SMALL_TOL
    assert _err(small["after"][0], port["after"][0]) <= SMALL_TOL
    for state in small["engines"].values():
        assert state["weights_version"] == 1


# -- every rank --------------------------------------------------------------


def _rows(flows):
    return sorted(np.ascontiguousarray(f).tobytes() for f in flows)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("session", ["small", "basic", "depth2"])
def test_every_rank_bitwise_the_primary(runs, world, session):
    """Each follower ran every dispatch, and its flows are bitwise the
    primary's futures (as a multiset of rows: the lanes interleave)."""
    ranks = runs["ranks"][world]
    p = ranks[0][session]
    futures = [f for k in ("a", "b") if k in p for v in p[k].values()
               for f in v]
    futures += p.get("after", []) + p.get("shard", []) + p.get("repl", [])
    for rank in ranks[1:]:
        rows = [row for _, flow in rank[session]["outputs"] for row in flow]
        assert _rows(rows) == _rows(futures)


@pytest.mark.parametrize("world", WORLDS)
def test_depth2_keeps_the_dispatch_order(runs, world):
    """One lane at ``pipeline_depth=2``: each follower's dispatches in the
    primary's order, and each micro-batch within SMALL_TOL of its
    one-device forward."""
    ranks = runs["ranks"][world]
    got = ranks[0]["depth2"]["repl"]
    for g, w in zip(got, runs["port"]["depth2"]):
        assert _err(g, w) <= SMALL_TOL
    for rank in ranks[1:]:
        rows = [row for _, flow in rank["depth2"]["outputs"] for row in flow]
        assert len(rows) == len(got)
        for a, b in zip(rows, got):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("session", ["small", "basic", "depth2"])
def test_every_rank_holds_the_same_engines(runs, world, session):
    """Tables (built buckets and placeholders), weight versions and
    retirements of every engine, equal on every rank after the session's
    wedges, grows and retirement."""
    ranks = runs["ranks"][world]
    want = ranks[0][session]["engines"]
    for rank in ranks[1:]:
        ends = rank[session]["engines"]
        assert sorted(ends) == sorted(want)
        for eid, state in want.items():
            got = ends[eid]
            assert got["tables"] == state["tables"], eid
            assert got["weights_version"] == state["weights_version"], eid
            assert got["retired"] == state["retired"], eid


@pytest.mark.parametrize("world", WORLDS)
def test_wedges_grow_and_retirement(runs, world):
    """The idle retirement came, then a wedge on the primary lane dropped
    the shard bucket from engine 0 on every rank (the primary stays, the
    spawn source), a wedge on a replica lane dropped its bucket and closed
    the replica on every rank, and a lane grown or reactivated served the
    next pair."""
    small = runs["ranks"][world][0]["small"]
    assert small["wedged"] == ["DispatchWedged", "DispatchWedged"]
    events = small["events"]
    assert "replica_activated_grown" in events
    assert "replica_retired" in events
    assert events.count("replica_quarantined") == 2
    engines = small["engines"]
    assert (SHARD_BUCKET, True) not in engines[0]["tables"]["plain"]
    assert not engines[0]["retired"]
    quarantined = [eid for _, eid, q in small["lanes"] if q]
    assert quarantined[0] == 0 and len(quarantined) == 2
    rep = engines[quarantined[1]]
    assert rep["retired"]
    assert (REPL_BUCKET, True) not in rep["tables"]["plain"]
    assert len(engines) >= 2


@pytest.mark.parametrize("world", WORLDS)
def test_clean_close_ends_every_follower(runs, world):
    small = runs["ranks"][world][0]["small"]
    assert small["closed"]
    assert small["channel"]["close"][0] == 1
    assert small["channel"]["infer"][0] >= 6
    for r, (rc, _) in enumerate(runs["ends"][world]):
        if not (world == 2 and r == 1):
            assert rc == 0


def test_killed_follower_settles_every_future_once(runs):
    """Rank 1 SIGKILLed with futures in flight: every future settled
    exactly once, with an error, within the watchdog's deadline and a
    margin; the channel is failed; the scheduler closed."""
    kill = runs["kill"]
    assert runs["ends"][2][1][0] == -signal.SIGKILL
    assert kill["futures"] == KILL_REQUESTS
    settled = kill["settled"]
    assert len(settled) == KILL_REQUESTS
    late = [(t, e) for t, e in settled if t >= 0]
    assert late and all(e is not None for _, e in late)
    assert max(t for t, _ in settled) <= KILL_TIMEOUT_S + KILL_MARGIN_S
    assert kill["failed"] != "None"
    assert kill["close_s"] < 30


# -- in this process ---------------------------------------------------------


class _Partitioner:
    def __init__(self, ranks):
        self.mesh = type("M", (), {"size": ranks})()


class _Engine:
    def __init__(self, ranks, leads):
        self.partitioner = _Partitioner(ranks)
        self.leads = leads


@pytest.mark.parametrize("key", [(64, 64), (2159, 3840), (2160, 3840),
                                 (4320, 7680), (2160, 3840, "cache")])
def test_decide_matches_jax(key):
    """The port's ``Placement.decide`` is JAX's on a mesh-armed primary
    (one device, or leading follower ranks)."""
    from raft_tpu.parallel.placement import Placement as JaxPlacement

    from raft_tpu_torch.parallel.placement import Placement

    class _Jax:
        partitioner = object()

    want = JaxPlacement(_Jax()).decide(key)
    for ranks in (1, 2, 4):
        assert Placement(_Engine(ranks, ranks > 1)).decide(key) == want


def test_torchrun_idiom_refuses_the_shard_route():
    """A multi-rank primary that leads no followers (every rank calls the
    engine itself) still refuses a 4K-class bucket, naming why."""
    from raft_tpu_torch.parallel import mesh as port_mesh
    from raft_tpu_torch.parallel.placement import Placement
    from raft_tpu_torch.serving import RAFTEngine

    hand = port_mesh.Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(
        2, 2), 0, "cpu")
    eng = RAFTEngine(RAFT(RAFTConfig(small=True),
                          torch.Generator().manual_seed(0)),
                     RAFTConfig(small=True), iters=1, mesh=hand,
                     device="cpu")
    place = Placement(eng)
    assert not eng.leads
    assert place.decide((64, 64)) == "replicate"
    with pytest.raises(NotImplementedError, match="parallel.follow"):
        place.decide((2160, 3840))
    assert Placement(_Engine(2, False)).decide((64, 64)) == "replicate"


def test_lead_and_follow_need_a_multi_rank_engine():
    from raft_tpu_torch.parallel import follow
    from raft_tpu_torch.serving import RAFTEngine

    eng = RAFTEngine(RAFT(RAFTConfig(small=True),
                          torch.Generator().manual_seed(0)),
                     RAFTConfig(small=True), iters=1, device="cpu")
    with pytest.raises(ValueError, match="more than one rank"):
        follow.lead(eng)
    with pytest.raises(ValueError, match="multi-rank"):
        follow.follow(eng)
    assert not eng.leads and eng.channel is None
    eng.close()                 # leads nothing: nothing changes
    assert eng.drop_bucket((1, 32, 32)) is False


def test_store_refusal_names_the_nccl_capture_row(tmp_path):
    """The store stays refused under a multi-rank mesh: a multi-rank
    program is eager, so there is nothing to store until one is
    captured."""
    from raft_tpu_torch.parallel import mesh as port_mesh
    from raft_tpu_torch.serving import RAFTEngine

    hand = port_mesh.Mesh(np.asarray(["cpu"] * 2, dtype=object).reshape(
        1, 2), 0, "cpu")
    with pytest.raises(NotImplementedError,
                       match="capture a multi-rank bucket under NCCL, and "
                             "the store"):
        RAFTEngine(RAFT(RAFTConfig(small=True),
                        torch.Generator().manual_seed(0)),
                   RAFTConfig(small=True), iters=1, mesh=hand,
                   aot_cache=str(tmp_path), device="cpu")


def test_channel_keeps_each_op_whole_under_threads(monkeypatch):
    """Lanes announce at once: each op's header and payload stay together
    on the channel, and each engine's ops keep its order (16 threads on
    a fake control group, the switch interval shortened)."""
    from raft_tpu_torch.parallel import follow

    sent = []

    class _Dist:
        @staticmethod
        def broadcast(t, src, group):
            time.sleep(0)
            sent.append(("header", int(t[1]), int(t[5])))

        @staticmethod
        def scatter(out, tensors, src, group):
            time.sleep(0)
            sent.append(("payload", int(tensors[1][0]), int(tensors[1][1])))

    monkeypatch.setattr(follow, "dist", _Dist)
    channel = follow.Channel(type("M", (), {"control_group": object(),
                                            "size": 2})())

    def lane(eid):
        for seq in range(50):
            blocks = [torch.zeros(2, dtype=torch.int64),
                      torch.tensor([eid, seq])]
            channel.send(follow.INFER, eid, (1, 8, 8, seq), scatter=blocks)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lane, args=(e,))
                   for e in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(sent) == 2 * 16 * 50
    seqs = {}
    for (h, eid, seq), (p, peid, pseq) in zip(sent[::2], sent[1::2]):
        assert (h, p) == ("header", "payload") and (eid, seq) == (peid, pseq)
        assert seq == seqs.get(eid, -1) + 1
        seqs[eid] = seq
    assert channel.stats["infer"][0] == channel.stats["infer 1x8x8"][0] \
        == 16 * 50


def test_swap_payload_round_trips_the_state_bitwise():
    from raft_tpu_torch.parallel.follow import pack_state, unpack_state

    cfg, state = _weights("basic")
    assert any(v.dtype == torch.int64 for v in state.values())
    model = RAFT(cfg, torch.Generator().manual_seed(9)).state_dict()
    buf = pack_state(state, model)
    assert buf.dtype == torch.uint8
    back = unpack_state(buf, model)
    assert list(back) == list(model)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="bytes"):
        unpack_state(buf[:-4], model)
