"""The port's host fleet (``raft_tpu_torch/serving/transport.py``,
``hosts.py``, ``host_worker.py`` and the scheduler's host lanes) against
``tests/test_hosts.py``, case for case where the case applies, on the CPU.

- The transport: the wire round trip, corruption in either direction as a
  clean ``TransportError``, the length guard, sockets; and one protocol
  with the JAX package's (its ``SocketTransport`` drives the port's
  ``serve_forever``, and the port's drives JAX's).
- The worker: no traffic before ``prewarm``; an artifact verified before a
  byte lands; ``AOTCache.push`` retrying a corrupted transfer into
  identical bytes; its handlers are ``schema.WIRE_METHODS``.
- The heartbeat ladder on an injected clock (healthy -> suspect -> dead,
  one verdict, a breaker-paced rejoin), and the degradation states.
- The scheduler over loopback host lanes: a dead host's in-flight batch
  fails over, every future settles once and bitwise the stub's output; a
  ``host.infer`` fault fails over and recovers; no fleet leaves no trace;
  ragged with hosts raises.
- Processes: a SIGKILL drill with two ``--stub`` workers and a rejoin; the
  real stack (two ``--device cpu`` workers: push, prewarm with
  ``compiles == 0``, SIGKILL mid-traffic, failover, rejoin), the
  counterpart of the JAX package's real-stack drill.

Every wait is bounded and waits for the event itself (a future's result,
the verdict's last consequence), never for a wall-clock margin; every
subprocess is killed in a ``finally``.
"""

import json
import os
import os.path as osp
import random
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu.serving.hosts import HostWorker as JaxHostWorker
from raft_tpu.serving.transport import SocketTransport as JaxSocket
from raft_tpu.serving.transport import serve_forever as jax_serve_forever
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.serving import schema
from raft_tpu_torch.serving.aot import AOTCache
from raft_tpu_torch.serving.engine import RAFTEngine
from raft_tpu_torch.serving.host_worker import StubEngine
from raft_tpu_torch.serving.hosts import (HOST_DEAD, HOST_HEALTHY,
                                          HOST_SUSPECT, HostFleet,
                                          HostWorker, RemoteEngine)
from raft_tpu_torch.serving.metrics import ServingMetrics
from raft_tpu_torch.serving.scheduler import (ConfigError,
                                              MicroBatchScheduler)
from raft_tpu_torch.serving.transport import (MAX_MESSAGE_BYTES, _LEN,
                                              LoopbackTransport,
                                              SocketTransport,
                                              TransportError, _recv_msg,
                                              serve_forever)
from raft_tpu_torch.testing import faults
from raft_tpu_torch.tools.convert import load_pth

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
WAIT = 120.0


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    faults.disarm()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _wait_for(pred, timeout=WAIT):
    """Poll ``pred`` until it holds (True) or ``timeout`` passes (False):
    the bound only matters when the event never comes."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


def _pairs(n, seed=0, h=32, w=32):
    rs = np.random.RandomState(seed)
    return [(rs.rand(h, w, 3).astype(np.float32) * 255,
             rs.rand(h, w, 3).astype(np.float32) * 255)
            for _ in range(n)]


def stub_flow(a, b):
    """The stub engine's output: the drills' exact oracle."""
    return ((np.asarray(a, np.float32) - np.asarray(b, np.float32))
            [..., :2] * 0.125).astype(np.float32)


def _events(mpath):
    if not osp.exists(mpath):
        return []
    recs = [json.loads(line) for line in open(mpath)]
    return [r["event"] for r in recs if r.get("kind") == "serving_event"]


def _accounting_ok(snap):
    return snap["submitted"] == (snap["completed"] + snap["failed"]
                                 + snap["deadline_missed"]
                                 + snap["cancelled"])


def _host_lane_block(sched, name):
    for blk in sched.health()["fleet"]["lanes"].values():
        if blk.get("host") == name:
            return blk
    raise AssertionError(f"no lane carries host {name}")


def _failed_over(fleet, name):
    """The dead verdict's LAST consequence has landed: the scheduler's
    ``_wedge_host`` reported the failover to the fleet."""
    return lambda: fleet.hosts[name].failovers >= 1


class _ReadyPort:
    """serve_forever's ready_fh hook, captured to an event."""

    def __init__(self):
        self.evt = threading.Event()
        self.port = None

    def write(self, s):
        self.port = int(s.split()[1])

    def flush(self):
        self.evt.set()


def _serve_in_thread(serve, worker):
    """``serve(0, worker)`` (a ``serve_forever``) on a daemon thread: it
    serves until the process ends, as a worker process does; returns the
    port once bound."""
    ready = _ReadyPort()
    th = threading.Thread(target=serve, args=(0, worker),
                          kwargs={"ready_fh": ready}, daemon=True)
    try:
        th.start()
    finally:
        bound = ready.evt.wait(30.0)
    assert bound and th.is_alive()
    return ready.port


# -- the transport seam ---------------------------------------------------------


class TestTransport:
    def test_loopback_roundtrip_error_close_reopen(self):
        t = LoopbackTransport(HostWorker(StubEngine()))
        assert t.call("ping") == {"seq": 1, "ready": True}
        # worker-side exceptions come back as clean error replies
        with pytest.raises(TransportError, match="worker error"):
            t.call("definitely_not_a_method")
        t.close()
        assert t.closed
        with pytest.raises(TransportError, match="closed"):
            t.call("ping")
        # reopen targets the SAME worker object (state preserved)
        assert t.reopen().call("ping")["seq"] == 2

    @pytest.mark.parametrize("site", ["transport.send", "transport.recv"])
    def test_corruption_reads_as_transport_error(self, site):
        t = LoopbackTransport(HostWorker(StubEngine()))
        faults.arm([{"site": site, "kind": "corrupt", "count": 1}])
        with pytest.raises(TransportError, match="corrupted"):
            t.call("ping")
        # the plan is spent: the retry is clean
        assert t.call("ping")["ready"] is True

    def test_remote_lanes_serve_the_plain_kind_only(self):
        """The routing calls take the engine's program ``kind``: a remote
        engine and the stub worker serve ``"plain"`` only and refuse the
        other kinds before anything is sent; a plain call's messages are
        the ones a kind-less call sent."""
        t = LoopbackTransport(HostWorker(StubEngine()))
        sent = []
        call = t.call
        t.call = lambda m, p=None, **kw: sent.append((m, p)) or call(
            m, p, **kw)
        eng = RemoteEngine(t, "h0")
        assert eng.ensure_bucket(2, 30, 30) == (2, 32, 32)
        assert eng.bucket_capacity(30, 30, kind="plain") == 2
        assert eng.route_bucket(1, 30, 30) == (1, 32, 32)
        eng.drop_bucket((2, 32, 32), kind="plain")
        assert sent == [
            ("ensure", {"n": 2, "h": 30, "w": 30, "kw": {}}),
            ("capacity", {"h": 30, "w": 30, "kw": {}}),
            ("route", {"n": 1, "h": 30, "w": 30}),
            ("drop", {"bucket": (2, 32, 32), "kw": {}})]
        for kind in ("ragged", "cached"):
            for engine in (eng, StubEngine()):
                for refused in (lambda: engine.bucket_capacity(
                                    30, 30, kind=kind),
                                lambda: engine.ensure_bucket(
                                    1, 30, 30, kind=kind),
                                lambda: engine.route_bucket(
                                    1, 30, 30, kind=kind),
                                lambda: engine.drop_bucket(
                                    (2, 32, 32), kind=kind)):
                    with pytest.raises(ValueError, match="'plain'"):
                        refused()
        assert len(sent) == 4

    def test_length_guard_rejects_corrupt_prefix(self):
        a, b = socket.socketpair()
        try:
            a.sendall(_LEN.pack(MAX_MESSAGE_BYTES + 1))
            with pytest.raises(TransportError, match="length"):
                _recv_msg(b)
        finally:
            a.close()
            b.close()

    def test_socket_transport_roundtrip(self):
        port = _serve_in_thread(serve_forever, HostWorker(StubEngine()))
        t = SocketTransport("127.0.0.1", port, call_timeout_s=10)
        try:
            assert t.call("ping")["ready"] is True
            assert t.call("stats")["ready"] is True
            with pytest.raises(TransportError, match="worker error"):
                t.call("nope")
            # the stream survived the error reply: still usable
            assert t.call("ping")["seq"] == 2
            # u8 frames out, fp32 flow back
            a, b = _pairs(1)[0]
            got = t.call("infer", {"image1": a[None].astype(np.uint8),
                                   "image2": b[None].astype(np.uint8)})
            want = stub_flow(a[None].astype(np.uint8),
                             b[None].astype(np.uint8))
            assert got.dtype == np.float32 and np.array_equal(got, want)
        finally:
            t.close()

    def test_dead_peer_is_a_transport_error(self):
        """A refused connection and a peer that closes mid-message both
        surface as ``TransportError``, never a hang."""
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        srv.close()
        with pytest.raises(TransportError, match="connect failed"):
            SocketTransport("127.0.0.1", port, connect_timeout_s=2).call(
                "ping")
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)

        def _hang_up():
            conn, _ = srv.accept()
            conn.close()

        threading.Thread(target=_hang_up, daemon=True).start()
        t = SocketTransport("127.0.0.1", srv.getsockname()[1],
                            call_timeout_s=10)
        try:
            with pytest.raises(TransportError):
                t.call("ping")
        finally:
            t.close()
            srv.close()


class TestOneWireProtocol:
    def test_jax_socket_drives_the_port_worker(self):
        port = _serve_in_thread(serve_forever, HostWorker(StubEngine()))
        t = JaxSocket("127.0.0.1", port, call_timeout_s=10)
        try:
            assert t.call("ping") == {"seq": 1, "ready": True}
            assert tuple(t.call("ensure", {"n": 2, "h": 30, "w": 30})) \
                == (2, 32, 32)
            a, b = _pairs(1, seed=3)[0]
            got = t.call("infer", {"image1": a[None], "image2": b[None]})
            assert np.array_equal(got, stub_flow(a[None], b[None]))
        finally:
            t.close()

    def test_port_socket_drives_the_jax_worker(self):
        port = _serve_in_thread(jax_serve_forever,
                                JaxHostWorker(StubEngine()))
        t = SocketTransport("127.0.0.1", port, call_timeout_s=10)
        try:
            assert t.call("ping") == {"seq": 1, "ready": True}
            a, b = _pairs(1, seed=4)[0]
            got = t.call("infer", {"image1": a[None], "image2": b[None]})
            assert np.array_equal(got, stub_flow(a[None], b[None]))
        finally:
            t.close()


# -- the worker: pre-warm gating and the verified push ---------------------------


class TestHostWorker:
    def test_prewarm_gates_all_traffic(self):
        t = LoopbackTransport(HostWorker(
            engine_factory=lambda: StubEngine()))
        assert t.call("ping")["ready"] is False
        z = np.zeros((1, 32, 32, 3), np.float32)
        for method, payload in [("capacity", {"h": 32, "w": 32}),
                                ("infer", {"image1": z, "image2": z})]:
            with pytest.raises(TransportError, match="not prewarmed"):
                t.call(method, payload)
        stats = t.call("prewarm")
        assert stats["compiles"] == 0
        assert t.call("ping")["ready"] is True
        flow = t.call("infer", {"image1": np.ones_like(z), "image2": z})
        assert flow.shape == (1, 32, 32, 2)

    def test_handlers_are_the_wire_table(self):
        assert schema.check_wire_handlers(HostWorker) == []
        assert schema.check_wire_handlers(JaxHostWorker) == []

    def _artifact(self, n=256, seed=7):
        import hashlib

        blob = np.random.RandomState(seed).bytes(n)
        sha = hashlib.sha256(blob).hexdigest()
        manifest = {"format": "test", "key": {"k": 1}, "sha256": sha,
                    "blob_bytes": n}
        return blob, sha, json.dumps(manifest).encode("utf-8")

    def test_put_artifact_verifies_before_any_byte_lands(self, tmp_path):
        w = HostWorker(StubEngine(), aot_root=str(tmp_path / "aot"))
        blob, sha, mb = self._artifact()
        with pytest.raises(ValueError, match="mismatch"):
            w.handle("put_artifact", {"digest": "d0", "blob": blob,
                                      "manifest": mb, "sha256": "0" * 64})
        with pytest.raises(ValueError, match="disagree"):
            w.handle("put_artifact",
                     {"digest": "d0", "blob": blob, "sha256": sha,
                      "manifest": json.dumps(
                          {"sha256": "f" * 64}).encode("utf-8")})
        # nothing landed from the rejected pushes
        assert not osp.exists(osp.join(w.aot_root, "objects", "d0"))
        reply = w.handle("put_artifact", {"digest": "d0", "blob": blob,
                                          "manifest": mb, "sha256": sha})
        assert reply == {"sha256": sha, "bytes": len(blob)}
        edir = osp.join(w.aot_root, "objects", "d0")
        assert open(osp.join(edir, "executable.bin"), "rb").read() == blob
        assert open(osp.join(edir, "manifest.json"), "rb").read() == mb
        # idempotent re-push (the retry-after-corruption path)
        assert w.handle("put_artifact", {"digest": "d0", "blob": blob,
                                         "manifest": mb,
                                         "sha256": sha}) == reply

    def test_aot_push_retries_corruption_into_identical_bytes(
            self, tmp_path):
        src = AOTCache(str(tmp_path / "src"))
        blob, sha, mb = self._artifact(n=512)
        edir = osp.join(src.objects, "d" + "0" * 63)
        os.makedirs(edir)
        with open(osp.join(edir, "executable.bin"), "wb") as fh:
            fh.write(blob)
        with open(osp.join(edir, "manifest.json"), "wb") as fh:
            fh.write(mb)
        # a torn entry (no manifest) must be skipped, never shipped
        os.makedirs(osp.join(src.objects, "torn"))
        with open(osp.join(src.objects, "torn", "executable.bin"),
                  "wb") as fh:
            fh.write(b"half")
        w = HostWorker(StubEngine(), aot_root=str(tmp_path / "dst"))
        faults.arm([{"site": "transport.send", "kind": "corrupt",
                     "count": 1}])
        out = src.push(LoopbackTransport(w), attempts=3, base_s=0.0,
                       rng=random.Random(0), sleep=lambda s: None)
        assert out == {"entries": 1, "bytes": len(blob), "retries": 1}
        got = osp.join(w.aot_root, "objects", "d" + "0" * 63)
        assert open(osp.join(got, "executable.bin"), "rb").read() == blob
        assert open(osp.join(got, "manifest.json"), "rb").read() == mb
        assert not osp.exists(osp.join(w.aot_root, "objects", "torn"))


# -- the liveness ladder (injected clock, no sleeping) ---------------------------


class TestHeartbeatLadder:
    def _fleet(self, transports, mpath=None, **kw):
        kw.setdefault("heartbeat_s", 1.0)
        kw.setdefault("suspect_after", 2)
        kw.setdefault("dead_after", 4)
        kw.setdefault("reconnect_backoff_s", 4.0)
        kw.setdefault("rng", random.Random(0))
        metrics = ServingMetrics(mpath) if mpath else None
        return HostFleet(transports, metrics=metrics, **kw)

    def test_ladder_verdict_once_and_breaker_paced_rejoin(self, tmp_path):
        mpath = str(tmp_path / "metrics.jsonl")
        clock = _Clock()
        t = LoopbackTransport(HostWorker(StubEngine()))
        fleet = self._fleet({"h0": t}, mpath, clock=clock)
        fleet.admit_all()
        h = fleet.hosts["h0"]
        assert h.ready and fleet.degradation() == "healthy"
        assert fleet.beat("h0") and h.beats == 1

        t.close()
        assert fleet.beat_all() == ["h0"]          # miss 1
        assert h.state == HOST_HEALTHY
        fleet.beat("h0")                           # miss 2: suspect
        assert h.state == HOST_SUSPECT
        fleet.beat("h0")                           # miss 3
        fleet.beat("h0")                           # miss 4: dead
        assert h.state == HOST_DEAD and not h.ready
        assert fleet.pop_notices() == [("dead", "h0")]
        assert fleet.pop_notices() == []           # the verdict once
        assert fleet.beat_all() == []              # dead hosts skipped
        assert fleet.degradation() == "partitioned"
        ev = _events(mpath)
        assert ev.count("host_suspect") == 1 and ev.count("host_dead") == 1

        # the reconnect is PACED: inside the breaker backoff, no probe
        fleet.tick()
        assert h.state == HOST_DEAD and h.rejoins == 0
        # backoff expired (half-open): reopen, ping, full rejoin
        clock.advance(1000.0)
        fleet.tick()
        assert h.state == HOST_HEALTHY and h.ready and h.rejoins == 1
        assert fleet.pop_notices() == [("rejoined", "h0")]
        assert "host_rejoined" in _events(mpath)
        health = fleet.health()
        assert health["state"] == "healthy"
        assert health["hosts"]["h0"]["rejoins"] == 1

    def test_suspect_recovers_on_clean_beat(self):
        t = LoopbackTransport(HostWorker(StubEngine()))
        fleet = self._fleet({"h0": t}, clock=_Clock())
        fleet.admit_all()
        # transient heartbeat faults (the host.heartbeat site)
        faults.arm([{"site": "host.heartbeat", "kind": "raise",
                     "count": 2}])
        fleet.beat("h0")
        fleet.beat("h0")
        h = fleet.hosts["h0"]
        assert h.state == HOST_SUSPECT and h.missed == 2
        assert fleet.beat("h0")                    # the plan is spent
        assert h.state == HOST_HEALTHY and h.missed == 0
        assert not fleet.pop_notices()             # never verdicted

    def test_degradation_states_across_two_hosts(self):
        t0 = LoopbackTransport(HostWorker(StubEngine()))
        t1 = LoopbackTransport(HostWorker(StubEngine()))
        fleet = self._fleet([t0, t1], clock=_Clock(), suspect_after=1,
                            dead_after=2)
        fleet.admit_all()
        assert fleet.degradation() == "healthy"
        t0.close()
        fleet.beat("h0")
        fleet.beat("h0")
        assert fleet.hosts["h0"].state == HOST_DEAD
        assert fleet.degradation() == "degraded"   # h1 still serves
        t1.close()
        fleet.beat("h1")
        fleet.beat("h1")
        assert fleet.degradation() == "partitioned"

    def test_threshold_validation(self):
        t = LoopbackTransport(HostWorker(StubEngine()))
        with pytest.raises(ValueError, match="suspect_after"):
            HostFleet([t], suspect_after=3, dead_after=3)


# -- the scheduler over loopback host lanes ----------------------------------------


class TestFleetFailoverLoopback:
    def _stack(self, mpath):
        t0 = LoopbackTransport(HostWorker(StubEngine(0.02)), name="h0")
        t1 = LoopbackTransport(HostWorker(StubEngine(0.02)), name="h1")
        fleet = HostFleet(
            {"h0": t0, "h1": t1}, heartbeat_s=0.05,
            heartbeat_timeout_s=0.5, suspect_after=1, dead_after=2,
            reconnect_backoff_s=600.0, rng=random.Random(0))
        fleet.admit_all()
        sched = MicroBatchScheduler(
            StubEngine(), max_batch=2, gather_window_s=0.0,
            dispatch_timeout_s=60.0, breaker_failures=2,
            metrics_path=mpath, host_fleet=fleet)
        return sched, fleet, t0

    def test_dead_host_fails_over_all_futures_settle_bitwise(
            self, tmp_path):
        mpath = str(tmp_path / "metrics.jsonl")
        sched, fleet, t0 = self._stack(mpath)
        try:
            pairs = _pairs(30)
            futs = []
            for i, (a, b) in enumerate(pairs):
                futs.append(sched.submit(a, b))
                if i == 9:
                    fleet.poison("h0")   # kill mid-traffic
            for (a, b), f in zip(pairs, futs):
                assert np.array_equal(np.asarray(f.result(WAIT).flow),
                                      stub_flow(a, b))
            assert _wait_for(_failed_over(fleet, "h0"))
            assert fleet.hosts["h0"].state == HOST_DEAD
            assert _host_lane_block(sched, "h0")["quarantined"]
            h = sched.health()
            assert h["state"] == "degraded"
            assert h["hosts"]["state"] == "degraded"
            assert h["hosts"]["hosts"]["h0"]["state"] == "dead"
            assert h["hosts"]["hosts"]["h1"]["state"] == "healthy"
            assert _host_lane_block(sched, "h1")["active"]

            snap = sched.metrics.snapshot()
            assert snap["submitted"] == 30 == snap["completed"]
            assert snap["failed"] == 0
            assert snap["abandoned_inflight"] == 0   # nothing stranded
            assert _accounting_ok(snap)
            ev = _events(mpath)
            assert {"host_dead", "failover", "replica_quarantined"} \
                <= set(ev)
            assert snap["hosts"]["h0"]["state"] == "dead"

            # an explicit rejoin over a fresh transport to the SAME
            # worker: the full protocol, then the lane serves again
            fleet.rejoin("h0", t0.reopen())
            assert _wait_for(lambda: _host_lane_block(sched, "h0")
                             ["active"])
            futs2 = [sched.submit(a, b) for a, b in pairs[:8]]
            for (a, b), f in zip(pairs, futs2):
                assert np.array_equal(np.asarray(f.result(WAIT).flow),
                                      stub_flow(a, b))
            assert fleet.hosts["h0"].rejoins == 1
            assert "host_rejoined" in _events(mpath)
            assert _wait_for(lambda: sched.health()["state"] == "healthy")
        finally:
            sched.close()

    def test_infer_fault_fails_over_and_recovers(self, tmp_path):
        """The ``host.infer`` site end to end: a worker-side raise crosses
        the wire as a ``TransportError`` mid-dispatch, the batch fails over
        by requeue before any heartbeat verdict, and every future settles
        bitwise the stub's output with the accounting identity intact."""
        mpath = str(tmp_path / "metrics.jsonl")
        sched, fleet, _ = self._stack(mpath)
        try:
            faults.arm([{"site": "host.infer", "kind": "raise",
                         "count": 1}])
            pairs = _pairs(30)
            futs = [sched.submit(a, b) for a, b in pairs]
            for (a, b), f in zip(pairs, futs):
                assert np.array_equal(np.asarray(f.result(WAIT).flow),
                                      stub_flow(a, b))
            assert not faults.armed("host.infer")   # the drill drew it
            snap = sched.metrics.snapshot()
            assert snap["submitted"] == 30 == snap["completed"]
            assert snap["failed"] == 0 and snap["abandoned_inflight"] == 0
            assert _accounting_ok(snap)
            assert "failover" in _events(mpath)
        finally:
            sched.close()

    def test_hosts_zero_is_bitwise_pr9(self, tmp_path):
        """No fleet: no hosts surface at all, the single-engine path."""
        sched = MicroBatchScheduler(StubEngine(), gather_window_s=0.0)
        try:
            assert sched.host_fleet is None and not sched._lanes
            assert "hosts" not in sched.health()
            a, b = _pairs(1)[0]
            flow = np.asarray(sched.submit(a, b).result(WAIT).flow)
            assert np.array_equal(flow, stub_flow(a, b))
            assert "hosts" not in sched.metrics.snapshot()
        finally:
            sched.close()

    def test_ragged_with_host_fleet_raises_config_error(self):
        eng = StubEngine()
        eng.ragged = True
        fleet = HostFleet({"h0": LoopbackTransport(
            HostWorker(StubEngine()))})
        with pytest.raises(ConfigError, match="host_fleet"):
            MicroBatchScheduler(eng, ragged=True, host_fleet=fleet)


# -- worker processes: the SIGKILL drills ------------------------------------------


def _read_port(proc, timeout=120.0):
    out = []

    def _read():
        out.append(proc.stdout.readline())

    th = threading.Thread(target=_read, daemon=True)
    try:
        th.start()
        th.join(timeout)
    finally:
        if th.is_alive():
            proc.kill()        # EOF unblocks the pending readline
            th.join(5)
    assert out and out[0].startswith("PORT "), \
        f"worker never reported a port: {out!r}"
    return int(out[0].split()[1])


def _spawn(procs, names, args, env=None):
    """Start one worker process per name (all at once, into ``procs``,
    which the caller's ``finally`` kills) and return their ports."""
    for name in names:
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.serving.host_worker",
             *args(name)], cwd=REPO, stdout=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": REPO, **(env or {})})
    return [_read_port(procs[name]) for name in names]


def _kill_all(procs):
    for p in procs.values():
        p.kill()
        p.wait(timeout=10)


class TestSubprocessKillDrill:
    def test_sigkill_one_of_two_workers_failover_then_rejoin(
            self, tmp_path):
        """Real processes and sockets (stub engines, exact numpy math):
        SIGKILL one of two workers mid-traffic; its lane quarantines with
        ``host_dead`` and ``failover`` in metrics.jsonl, every request
        settles exactly once (bitwise, the accounting identity, nothing
        stranded), and a RESTARTED worker rejoins through a new transport
        and takes traffic again."""
        mpath = str(tmp_path / "metrics.jsonl")
        procs = {}
        sched = None
        def stub(name):
            return ["--stub", "--infer-delay-s", "0.05"]

        try:
            p0, p1 = _spawn(procs, ["h0", "h1"], stub)
            fleet = HostFleet(
                {"h0": SocketTransport("127.0.0.1", p0, call_timeout_s=30,
                                       name="h0"),
                 "h1": SocketTransport("127.0.0.1", p1, call_timeout_s=30,
                                       name="h1")},
                heartbeat_s=0.05, heartbeat_timeout_s=5.0,
                suspect_after=1, dead_after=2, reconnect_backoff_s=600.0,
                rng=random.Random(0))
            fleet.admit_all()
            sched = MicroBatchScheduler(
                StubEngine(), max_batch=2, gather_window_s=0.0,
                dispatch_timeout_s=60.0, breaker_failures=2,
                metrics_path=mpath, host_fleet=fleet)
            pairs = _pairs(30)
            futs = []
            for i, (a, b) in enumerate(pairs):
                futs.append(sched.submit(a, b))
                if i == 9:
                    procs["h0"].kill()             # SIGKILL mid-batch
            for (a, b), f in zip(pairs, futs):
                assert np.array_equal(np.asarray(f.result(WAIT).flow),
                                      stub_flow(a, b))
            assert _wait_for(_failed_over(fleet, "h0"))
            assert _wait_for(lambda: fleet.hosts["h0"].state == HOST_DEAD)
            assert _wait_for(lambda: _host_lane_block(sched, "h0")
                             ["quarantined"])
            snap = sched.metrics.snapshot()
            assert snap["submitted"] == 30 == snap["completed"]
            assert snap["failed"] == 0 and snap["abandoned_inflight"] == 0
            assert _accounting_ok(snap)
            assert {"host_dead", "failover"} <= set(_events(mpath))

            # restart the worker (a fresh process, a NEW port) and rejoin
            (p0b,) = _spawn(procs, ["h0b"], stub)
            fleet.rejoin("h0", SocketTransport("127.0.0.1", p0b,
                                               call_timeout_s=30,
                                               name="h0"))
            assert fleet.hosts["h0"].rejoins == 1
            assert "host_rejoined" in _events(mpath)
            assert _wait_for(lambda: _host_lane_block(sched, "h0")
                             ["active"])
            futs2 = [sched.submit(a, b) for a, b in pairs[:10]]
            for (a, b), f in zip(pairs, futs2):
                assert np.array_equal(np.asarray(f.result(WAIT).flow),
                                      stub_flow(a, b))
            assert _wait_for(lambda: sched.health()["state"] == "healthy")
        finally:
            if sched is not None:
                sched.close()
            _kill_all(procs)


def _tf32_flag() -> str:
    """This process's TF32 flags as host_worker's ``--tf32`` (they are
    part of every program-store key)."""
    if torch.backends.cuda.matmul.allow_tf32:
        return "all"
    return "cudnn" if torch.backends.cudnn.allow_tf32 else "off"


class TestRealStackKillDrill:
    def test_push_prewarm_kill_failover_rejoin_zero_compiles(
            self, tmp_path):
        """The real stack end to end: the primary's program store ships
        to two worker processes running ``RAFTEngine`` on the CPU (sha256
        verified), both prewarm with ZERO traces (store loads only), the
        remote flow is bitwise the primary's, a SIGKILL mid-traffic fails
        over with every request settling exactly once, and the restarted
        worker rejoins through a verified re-push, again tracing
        nothing."""
        cfg = RAFTConfig(small=True)
        rs = np.random.RandomState(3)
        i1 = (rs.rand(32, 32, 3) * 255).round().astype(np.float32)
        i2 = (rs.rand(32, 32, 3) * 255).round().astype(np.float32)
        art = str(tmp_path / "artifacts")
        primary = RAFTEngine(load_pth(FIXTURE, cfg), cfg, iters=1,
                             envelope=[(1, 32, 32)], precompile=True,
                             aot_cache=art, device="cpu")
        assert primary.aot_stats()["compiles"] == 1
        oracle = primary.infer_batch(i1[None], i2[None])[0]

        # the workers' CPU math must match this process's thread count
        # for the flow to be bitwise
        env = {"OMP_NUM_THREADS": str(torch.get_num_threads())}
        mpath = str(tmp_path / "metrics.jsonl")
        procs = {}
        sched = None

        def real(name):
            return ["--weights", FIXTURE, "--small",
                    "--aot-root", str(tmp_path / f"aot_{name}"),
                    "--iters", "1", "--envelope", "1x32x32",
                    "--tf32", _tf32_flag(), "--device", "cpu"]

        try:
            p0, p1 = _spawn(procs, ["h0", "h1"], real, env)
            fleet = HostFleet(
                {"h0": SocketTransport("127.0.0.1", p0,
                                       call_timeout_s=300, name="h0"),
                 "h1": SocketTransport("127.0.0.1", p1,
                                       call_timeout_s=300, name="h1")},
                aot_cache=AOTCache(art), heartbeat_s=0.1,
                heartbeat_timeout_s=10.0, suspect_after=1, dead_after=2,
                reconnect_backoff_s=600.0, rng=random.Random(0))
            stats = fleet.admit_all()
            for name in ("h0", "h1"):
                assert stats[name]["compiles"] == 0, stats[name]
                assert stats[name]["aot_hits"] >= 1, stats[name]
                assert fleet.hosts[name].push_entries >= 1
                assert fleet.hosts[name].push_bytes > 0

            sched = MicroBatchScheduler(
                primary, max_batch=1, gather_window_s=0.0,
                dispatch_timeout_s=300.0, breaker_failures=1,
                metrics_path=mpath, host_fleet=fleet)
            futs = []
            for i in range(16):
                futs.append(sched.submit(i1, i2))
                if i == 5:
                    procs["h0"].kill()             # SIGKILL mid-batch
            for f in futs:
                assert np.array_equal(np.asarray(f.result(WAIT).flow),
                                      oracle)      # bitwise
            assert _wait_for(_failed_over(fleet, "h0"))
            assert _wait_for(lambda: fleet.hosts["h0"].state == HOST_DEAD)
            assert _wait_for(lambda: _host_lane_block(sched, "h0")
                             ["quarantined"])
            snap = sched.metrics.snapshot()
            assert snap["submitted"] == 16 == snap["completed"]
            assert snap["failed"] == 0 and snap["abandoned_inflight"] == 0
            assert _accounting_ok(snap)
            assert {"host_dead", "failover"} <= set(_events(mpath))

            # restart on a fresh port: the full rejoin protocol (re-push,
            # idempotent on the worker, and prewarm), again no trace
            (p0b,) = _spawn(procs, ["h0b"], real, env)
            rstats = fleet.rejoin(
                "h0", SocketTransport("127.0.0.1", p0b,
                                      call_timeout_s=300, name="h0"))
            assert rstats["compiles"] == 0, rstats
            assert rstats["aot_hits"] >= 1, rstats
            assert "host_rejoined" in _events(mpath)
            assert _wait_for(lambda: _host_lane_block(sched, "h0")
                             ["active"])
            futs2 = [sched.submit(i1, i2) for _ in range(6)]
            for f in futs2:
                assert np.array_equal(np.asarray(f.result(WAIT).flow),
                                      oracle)
            assert _wait_for(lambda: sched.health()["state"] == "healthy")
        finally:
            if sched is not None:
                sched.close()
            _kill_all(procs)
