"""The host fleet: replica lanes in other host processes behind the
transport seam; port of ``raft_tpu/serving/hosts.py``.

The replica fleet of ``parallel/placement.py`` is engines in ONE process;
this module is the other half, replicas in other processes (on this card,
or on another machine's). Three pieces:

- :class:`HostWorker`: the worker-side method table, one per host process
  (``python -m raft_tpu_torch.serving.host_worker`` serves one over a
  socket; the CPU tests hold one behind a
  :class:`~raft_tpu_torch.serving.transport.LoopbackTransport`). It
  enforces **pre-warm-before-traffic**: until the program store's entries
  are pushed (sha256-verified, written blob first and manifest last into
  its own store) and ``prewarm`` has built its engine, every routing and
  infer method refuses, so a joining host takes no request until its
  programs verify.
- :class:`RemoteEngine`: an engine-shaped proxy over a transport. The
  scheduler's fleet lanes drive it like a local engine, through the
  synchronous ``infer_batch`` (the blocking RPC rides the lane's
  supervised executor, so the fleet watchdog covers transport hangs). It
  sends numpy frames (u8 or fp32, the queue's wire dtype) and receives
  fp32 flow: tensors never cross the wire.
- :class:`HostFleet`: liveness and membership. Per host: heartbeat probes
  (the ``host.heartbeat`` fault site), a missed-beat ladder ``healthy ->
  suspect -> dead`` with thresholds on an injectable clock, a per-host
  :class:`~raft_tpu_torch.serving.resilience.CircuitBreaker` whose
  jittered backoff paces reconnect probes, and the push and prewarm on
  (re)join. Dead-host verdicts are queued as *notices*; the scheduler
  drains them on its dispatcher tick and lands the consequences before
  any future (``MicroBatchScheduler._wedge_host``: quarantine the lane,
  poison the transport, THEN fail the in-flight batch over by requeue).

Degradation states (:meth:`HostFleet.health`, the scheduler's
``health()["hosts"]``): ``healthy`` (every host ready and beating),
``degraded`` (some host suspect, dead or not ready while others serve),
``partitioned`` (NO host reachable; the local lanes keep serving).

metrics.jsonl events: ``host_suspect``, ``host_dead``, ``host_rejoined``
(emitted here), ``failover`` (by the scheduler, with the requeue count).
Without a fleet none of this is built.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch.serving.resilience import BREAKER_HALF_OPEN, CircuitBreaker
from raft_tpu_torch.serving.transport import TransportError
from raft_tpu_torch.testing.faults import fault_point

#: ``HostFleet._lock`` guards the notices and the membership snapshots
#: only; it is NEVER held across a transport call (heartbeat, push and
#: prewarm RPCs run lock-free, so a hung host stalls one probe, not the
#: fleet's bookkeeping). It is a leaf under the scheduler's locks: the
#: dispatcher drains notices holding nothing.
LOCK_ORDER = (
    ("hosts.HostFleet._lock",),
)

#: heartbeat verdicts ride the scheduler's verdict discipline: the fleet
#: only queues them (``pop_notices``); their consequences land in
#: ``scheduler._wedge_host`` before any future is touched.
GRAFTTHREAD = {
    "locks": ("_lock",),
}

#: graftwire declarations. Every worker method is idempotent by contract
#: (a TransportError is always retryable): ping, stats and capacity are
#: reads; put_artifact re-verifies and does nothing for a digest already
#: installed; prewarm re-warms to the same engine; ensure, route and drop
#: converge on the same bucket table; infer is pure; update_weights sets
#: the same value on a re-send. A method that is not safe to re-send must
#: carry a request_id in its payload instead of a row here (W2 holds every
#: call site to one or the other). ``_emit`` wraps
#: ``metrics.record_event``, so its literals are schema-checked (W6).
GRAFTWIRE = {
    "idempotent": ("ping", "put_artifact", "prewarm", "capacity",
                   "ensure", "route", "drop", "infer",
                   "update_weights", "stats"),
    "event_emitters": ("_emit",),
}

HOST_HEALTHY = "healthy"
HOST_SUSPECT = "suspect"
HOST_DEAD = "dead"

FLEET_HEALTHY = "healthy"
FLEET_DEGRADED = "degraded"
FLEET_PARTITIONED = "partitioned"


class HostDead(RuntimeError):
    """The request's host lane was verdicted dead (the missed-beat ladder
    ran out). In-flight work fails over to surviving lanes; this only
    surfaces when NO lane can ever serve the work."""


def _host_array(x):
    """A reply's array as numpy on the host (tensors never cross the
    wire)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- worker side ----------------------------------------------------------


class HostWorker:
    """The worker-side method table behind ``Transport.call``:
    ``handle(method, payload)`` is the single entry
    (:func:`~raft_tpu_torch.serving.transport.serve_connection` dispatches
    into it; a ``LoopbackTransport`` holds one directly). Every method is
    idempotent by contract, since a ``TransportError`` is always retried:
    ping, stats and capacity read; ``put_artifact`` re-verifies and does
    nothing for a digest already installed; ``prewarm`` re-warms to the
    same engine; ensure, route and drop converge on one bucket table;
    infer is pure; ``update_weights`` sets the same weights on a re-send.
    The methods are ``schema.WIRE_METHODS``.

    ``engine_factory`` builds the serving engine at *prewarm*, AFTER the
    programs land, so a real worker's ``RAFTEngine(aot_cache=aot_root,
    precompile=True)`` builds every bucket from verified pushed programs
    (no trace: the ``prewarm`` reply's ``compiles`` is 0). Until
    ``prewarm`` succeeds every routing and infer method raises, the
    transport relays it as an error reply, and the host takes no traffic.
    """

    def __init__(self, engine=None, *,
                 engine_factory: Optional[Callable[[], Any]] = None,
                 aot_root: Optional[str] = None):
        if engine is None and engine_factory is None:
            raise ValueError("HostWorker needs an engine or an "
                             "engine_factory")
        self._engine = engine
        self._factory = engine_factory
        self.aot_root = aot_root
        self._ready = engine is not None
        self._seq = 0
        #: seconds the factory took at prewarm (None: not built here)
        self.build_s: Optional[float] = None
        #: the worker process's own start-up seconds (``cuda_init_s``),
        #: reported by ``prewarm``
        self.startup: Dict[str, float] = {}

    # -- protocol ---------------------------------------------------------

    def handle(self, method: str, payload: Any):
        fn = getattr(self, f"_m_{method}", None)
        if fn is None:
            raise ValueError(f"unknown worker method {method!r}")
        return fn(payload or {})

    def _eng(self):
        if not self._ready or self._engine is None:
            raise RuntimeError(
                "host not prewarmed — push artifacts and call prewarm "
                "before routing traffic (pre-warm-before-traffic)")
        return self._engine

    def _m_ping(self, payload) -> Dict:
        self._seq += 1
        return {"seq": self._seq, "ready": self._ready}

    def _m_put_artifact(self, payload) -> Dict:
        """Receive one program-store entry, verified BEFORE any byte lands
        under the store (the blob's sha256 against both the message and
        the manifest), then written atomically: blob first, manifest
        LAST, a temporary directory renamed, so a crash mid-push never
        leaves a loadable-looking torn entry. Re-pushing a digest already
        installed does nothing (the retry-after-corruption path)."""
        if self.aot_root is None:
            raise RuntimeError("worker has no aot_root to receive "
                               "artifacts into")
        digest = payload["digest"]
        blob = payload["blob"]
        manifest_bytes = payload["manifest"]
        want = payload["sha256"]
        got = hashlib.sha256(blob).hexdigest()
        if got != want:
            raise ValueError(
                f"artifact {digest}: blob sha256 mismatch (corrupted "
                f"in transit): got {got[:12]} want {want[:12]}")
        manifest = json.loads(manifest_bytes.decode("utf-8"))
        if manifest.get("sha256") != want:
            raise ValueError(
                f"artifact {digest}: manifest/message sha256 disagree")
        objects = os.path.join(self.aot_root, "objects")
        edir = os.path.join(objects, digest)
        if not os.path.exists(os.path.join(edir, "manifest.json")):
            tmp = os.path.join(objects, f".push-{digest}-{os.getpid()}")
            os.makedirs(tmp, exist_ok=True)
            try:
                with open(os.path.join(tmp, "executable.bin"),
                          "wb") as fh:
                    fh.write(blob)
                    fh.flush()
                    os.fsync(fh.fileno())
                with open(os.path.join(tmp, "manifest.json"),
                          "wb") as fh:
                    fh.write(manifest_bytes)
                    fh.flush()
                    os.fsync(fh.fileno())
                try:
                    os.rename(tmp, edir)
                except OSError:
                    pass   # a racer installed it first: theirs verified
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        return {"sha256": want, "bytes": len(blob)}

    def _m_prewarm(self, payload) -> Dict:
        """Build and warm the engine (the programs must already be in
        place: the factory's store-armed engine loads instead of tracing)
        and reply the counters the no-trace contract pins, with where the
        build's seconds went."""
        if self._engine is None:
            t0 = time.perf_counter()
            self._engine = self._factory()
            self.build_s = time.perf_counter() - t0
        self._ready = True
        eng = self._engine
        stats = (eng.aot_stats() if hasattr(eng, "aot_stats")
                 else {"enabled": 0})
        out = {
            "compiles": int(stats.get("compiles",
                                      getattr(eng, "compile_count", 0))),
            "aot_hits": int(stats.get("aot_hits", 0)),
            "aot_misses": int(stats.get("aot_misses", 0)),
            "executables": int(eng.executable_count()
                               if hasattr(eng, "executable_count")
                               else len(getattr(eng, "_compiled", ()))),
        }
        if self.build_s is not None:
            out["build_s"] = self.build_s
        if self.startup:
            out["startup"] = dict(self.startup)
        for name in ("aot_seconds", "capture_seconds"):
            # per phase (load, export, store; warmup, capture), summed
            # over the programs built
            totals: Dict[str, float] = {}
            for d in (getattr(eng, name, None) or {}).values():
                for k, v in d.items():
                    totals[k] = totals.get(k, 0.0) + v
            if totals:
                out[name] = totals
        return out

    def _m_capacity(self, payload):
        return self._eng().bucket_capacity(payload["h"], payload["w"],
                                           **payload.get("kw", {}))

    def _m_ensure(self, payload):
        return tuple(self._eng().ensure_bucket(
            payload["n"], payload["h"], payload["w"],
            **payload.get("kw", {})))

    def _m_route(self, payload):
        return tuple(self._eng().route_bucket(
            payload["n"], payload["h"], payload["w"]))

    def _m_drop(self, payload):
        self._eng().drop_bucket(tuple(payload["bucket"]),
                                **payload.get("kw", {}))
        return True

    def _m_infer(self, payload):
        fault_point("host.infer")
        eng = self._eng()
        i1 = payload["image1"]
        i2 = payload["image2"]
        if payload.get("return_low"):
            flow, low = eng.infer_batch(
                i1, i2, flow_init=payload.get("flow_init"),
                return_low=True)
            return (_host_array(flow), _host_array(low))
        return _host_array(eng.infer_batch(i1, i2))

    def _m_update_weights(self, payload):
        self._eng().update_weights(payload["variables"])
        return True

    def _m_stats(self, payload) -> Dict:
        eng = self._engine
        if eng is None:
            return {"ready": False, "executables": 0}
        return {
            "ready": self._ready,
            "executables": int(eng.executable_count()
                               if hasattr(eng, "executable_count")
                               else len(getattr(eng, "_compiled", ()))),
            "aot": (eng.aot_stats() if hasattr(eng, "aot_stats")
                    else {"enabled": 0}),
        }


# -- scheduler side -------------------------------------------------------


def require_plain(kind: str) -> None:
    """Remote lanes serve the plain kind of program only (a fleet refuses
    ragged scheduling and the feature cache)."""
    if kind != "plain":
        raise ValueError(f"kind={kind!r}: a remote engine serves the "
                         "'plain' kind of program only")


class RemoteEngine:
    """Engine-shaped proxy over a transport: what a host lane's
    ``_ReplicaLane.engine`` is. Deliberately the *synchronous* engine
    surface only (no ``infer_batch_async``): the scheduler's fleet path
    then runs the blocking RPC on the lane's supervised executor thread,
    where the fleet watchdog and the dead-host verdict both reach it.
    ``warm_start`` is False: remote lanes serve the cold-start path (warm
    start and feature-cache state are device-resident and one-process by
    design)."""

    wire = "f32"
    warm_start = False
    feature_cache = False
    ragged = False

    def __init__(self, transport, name: str, *,
                 call_timeout_s: Optional[float] = None):
        self._transport = transport
        self.name = name
        self._timeout = call_timeout_s

    def _call(self, method: str, payload=None):
        return self._transport.call(method, payload,
                                    timeout_s=self._timeout)

    def rebind(self, transport) -> None:
        """Point the proxy at a restarted worker's transport (the
        explicit-rejoin path)."""
        self._transport = transport

    def poison(self) -> None:
        """Close the transport out from under any in-flight RPC: the
        dead-host verdict's way of unsticking a lane blocked on a
        zombie's socket (the blocked recv raises, and the lane's except
        path sees ``job.abandoned`` and settles nothing)."""
        self._transport.close()

    def bucket_capacity(self, h: int, w: int, kind: str = "plain"):
        require_plain(kind)
        return self._call("capacity", {"h": h, "w": w, "kw": {}})

    def ensure_bucket(self, n: int, h: int, w: int,
                      kind: str = "plain") -> Tuple:
        require_plain(kind)
        return tuple(self._call("ensure",
                                {"n": n, "h": h, "w": w, "kw": {}}))

    def route_bucket(self, n: int, h: int, w: int,
                     kind: str = "plain") -> Tuple:
        require_plain(kind)
        return tuple(self._call("route", {"n": n, "h": h, "w": w}))

    def drop_bucket(self, bucket, kind: str = "plain") -> None:
        require_plain(kind)
        # best-effort: this runs from verdict paths where the host is
        # typically already unreachable, and the worker's table is
        # rebuilt on rejoin anyway (prewarm from the store)
        try:
            self._call("drop", {"bucket": tuple(bucket), "kw": {}})
        except TransportError:
            pass

    def infer_batch(self, image1, image2, **kw):
        return self._call("infer", dict(image1=np.asarray(image1),
                                        image2=np.asarray(image2), **kw))

    def update_weights(self, weights) -> None:
        """Send a state dict (as numpy arrays) to the worker's engine."""
        state = weights.state_dict() if hasattr(weights, "state_dict") \
            else weights
        self._call("update_weights",
                   {"variables": {k: _host_array(v)
                                  for k, v in state.items()}})

    def executable_count(self) -> int:
        try:
            return int(self._call("stats").get("executables") or 0)
        except TransportError:
            return 0

    def aot_stats(self) -> Dict:
        try:
            return dict(self._call("stats").get("aot")
                        or {"enabled": 0})
        except TransportError:
            return {"enabled": 0}


class _Host:
    __slots__ = ("name", "transport", "engine", "breaker", "state",
                 "missed", "beats", "last_beat", "ready", "failovers",
                 "push_entries", "push_bytes", "push_retries",
                 "prewarm", "rejoins")

    def __init__(self, name: str, transport, breaker: CircuitBreaker,
                 call_timeout_s: Optional[float]):
        self.name = name
        self.transport = transport
        self.engine = RemoteEngine(transport, name,
                                   call_timeout_s=call_timeout_s)
        self.breaker = breaker
        self.state = HOST_HEALTHY
        self.missed = 0
        self.beats = 0
        self.last_beat: Optional[float] = None
        #: takes no traffic until its programs verified and it prewarmed
        self.ready = False
        self.failovers = 0
        self.push_entries = 0
        self.push_bytes = 0
        self.push_retries = 0
        self.prewarm: Dict = {}
        self.rejoins = 0


class HostFleet:
    """Liveness and membership of the remote lanes.

    ``transports``: ``{name: Transport}`` (insertion-ordered: the lane
    order) or a plain list (named ``h0``, ``h1``, ...).

    Missed-beat ladder (per host, consecutive misses): ``suspect_after``
    gives ``suspect``, ``dead_after`` gives ``dead`` and a queued verdict
    notice. ``clock`` is injectable: tests walk the ladder with
    ``beat_all()`` and a fake clock, with no sleeping. The per-host
    breaker's jittered backoff paces reconnect probes after a dead
    verdict; a probe that answers runs the full rejoin protocol (re-push,
    verify, prewarm), never a bare "it pinged once" revival.

    The fleet NEVER settles futures or touches scheduler state: it queues
    ``("dead"|"rejoined", name)`` notices that the scheduler's dispatcher
    drains (``_host_notices``), so every consequence lands on the one
    thread that owns the lanes."""

    def __init__(self, transports, *, aot_cache=None,
                 heartbeat_s: float = 0.5,
                 heartbeat_timeout_s: float = 2.0,
                 suspect_after: int = 2, dead_after: int = 4,
                 reconnect_backoff_s: float = 0.5,
                 reconnect_backoff_max_s: float = 30.0,
                 rng=None, clock: Callable[[], float] = time.monotonic,
                 metrics=None, call_timeout_s: Optional[float] = 60.0,
                 push_attempts: int = 4):
        if not isinstance(transports, dict):
            transports = {f"h{k}": t for k, t in enumerate(transports)}
        if suspect_after < 1 or dead_after <= suspect_after:
            raise ValueError(
                f"need 1 <= suspect_after ({suspect_after}) < "
                f"dead_after ({dead_after})")
        self.aot_cache = aot_cache
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.push_attempts = int(push_attempts)
        self._rng = rng
        self._clock = clock
        self.metrics = metrics
        self._lock = threading.Lock()
        self._notices: List[Tuple[str, str]] = []
        self.hosts: Dict[str, _Host] = {}
        for name, t in transports.items():
            br = CircuitBreaker(
                failures=self.dead_after, base_s=reconnect_backoff_s,
                max_s=reconnect_backoff_max_s, rng=rng, clock=clock,
                label=f"host/{name}")
            self.hosts[name] = _Host(name, t, br, call_timeout_s)
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- membership / artifact push ---------------------------------------

    def admit(self, name: str) -> Dict:
        """Bring one host to ready: push every stored program (sha256
        verified end to end, retried with backoff inside
        ``AOTCache.push``), then ``prewarm``; only a host whose programs
        verified takes traffic. Raises ``TransportError`` if the host
        cannot be brought up (it stays not ready)."""
        host = self.hosts[name]
        push = {"entries": 0, "bytes": 0, "retries": 0}
        if self.aot_cache is not None:
            push = self.aot_cache.push(
                host.transport, attempts=self.push_attempts,
                rng=self._rng)
        host.push_entries += push["entries"]
        host.push_bytes += push["bytes"]
        host.push_retries += push["retries"]
        host.prewarm = host.transport.call(
            "prewarm", timeout_s=max(self.heartbeat_timeout_s, 300.0))
        host.ready = True
        host.state = HOST_HEALTHY
        host.missed = 0
        host.last_beat = self._clock()
        if self.metrics is not None:
            self.metrics.record_host_push(
                name, entries=push["entries"], bytes=push["bytes"],
                retries=push["retries"])
            self.metrics.record_host_state(name, host.state,
                                           missed=0, ready=True)
        return host.prewarm

    def admit_all(self) -> Dict[str, Dict]:
        return {name: self.admit(name) for name in self.hosts}

    def rejoin(self, name: str, transport=None) -> Dict:
        """Re-admit a dead host, through a NEW transport when its worker
        restarted elsewhere (the SIGKILL drill) or the existing one after
        a partition healed. The full protocol: re-push and prewarm; only
        then does the lane reactivate (the scheduler drains the
        ``rejoined`` notice)."""
        host = self.hosts[name]
        if transport is not None:
            host.transport = transport
            host.engine.rebind(transport)
        stats = self.admit(name)
        host.rejoins += 1
        host.breaker.record_success()
        if self.metrics is not None:
            self.metrics.record_host_rejoin(name)
        self._emit("host_rejoined", host=name,
                   push_entries=host.push_entries,
                   push_bytes=host.push_bytes,
                   push_retries=host.push_retries,
                   compiles=int(stats.get("compiles", 0)))
        with self._lock:
            self._notices.append(("rejoined", name))
        return stats

    def poison(self, name: str) -> None:
        """Close the host's transport (a dead-host verdict consequence:
        unsticks any lane blocked on the zombie's socket)."""
        self.hosts[name].engine.poison()

    # -- heartbeats --------------------------------------------------------

    def beat(self, name: str) -> bool:
        """One heartbeat probe. Walks the missed-beat ladder on failure,
        emits ``host_suspect`` / ``host_dead`` and queues the dead notice
        exactly once per death."""
        host = self.hosts[name]
        host.last_beat = self._clock()
        ok = True
        try:
            fault_point("host.heartbeat")
            host.transport.call("ping",
                                timeout_s=self.heartbeat_timeout_s)
        except (TransportError, RuntimeError):
            # a transport failure or an injected fault: a missed beat
            ok = False
        if ok:
            host.beats += 1
            host.missed = 0
            host.breaker.record_success()
            if host.state == HOST_SUSPECT:
                host.state = HOST_HEALTHY
                self._record_state(host)
            return True
        host.missed += 1
        host.breaker.record_failure()
        if host.state != HOST_DEAD and host.missed >= self.dead_after:
            host.state = HOST_DEAD
            host.ready = False
            self._record_state(host)
            self._emit("host_dead", host=name, missed=host.missed)
            with self._lock:
                self._notices.append(("dead", name))
        elif (host.state == HOST_HEALTHY
                and host.missed >= self.suspect_after):
            host.state = HOST_SUSPECT
            self._record_state(host)
            self._emit("host_suspect", host=name, missed=host.missed)
        return False

    def beat_all(self) -> List[str]:
        """Probe every non-dead host once (tests drive the ladder with
        this and an injected clock); returns the hosts that missed."""
        return [name for name, h in self.hosts.items()
                if h.state != HOST_DEAD and not self.beat(name)]

    def tick(self) -> None:
        """One monitor pass: beat every live host that is due, and pace a
        reconnect probe for every dead one (gated on its breaker's
        jittered backoff having expired: the half-open promotion)."""
        now = self._clock()
        for name, host in self.hosts.items():
            if host.state == HOST_DEAD:
                self._try_reconnect(host)
            elif (host.last_beat is None
                    or now - host.last_beat >= self.heartbeat_s):
                self.beat(name)

    def _try_reconnect(self, host: _Host) -> None:
        if host.breaker.state() != BREAKER_HALF_OPEN:
            return   # backoff not expired: no probe yet
        transport = host.transport
        if getattr(transport, "closed", False):
            reopen = getattr(transport, "reopen", None)
            if reopen is None:
                host.breaker.record_failure()
                return
            try:
                transport = reopen()
            except TransportError:
                host.breaker.record_failure()
                return
        try:
            transport.call("ping", timeout_s=self.heartbeat_timeout_s)
            self.rejoin(host.name,
                        transport if transport is not host.transport
                        else None)
        except TransportError:
            host.breaker.record_failure()

    # -- verdict seam ------------------------------------------------------

    def pop_notices(self) -> List[Tuple[str, str]]:
        """Drain the queued ``("dead"|"rejoined", name)`` notices: called
        from the scheduler's dispatcher tick, which owns every
        consequence."""
        with self._lock:
            out, self._notices = self._notices, []
        return out

    def record_failover(self, name: str, requeued: int) -> None:
        """Scheduler callback: one failover (in-flight requests requeued)
        was applied against this host."""
        host = self.hosts.get(name)
        if host is not None:
            host.failovers += 1
        if self.metrics is not None:
            self.metrics.record_host_failover(name, requeued=requeued)

    # -- observability -----------------------------------------------------

    def degradation(self) -> str:
        states = [h.state for h in self.hosts.values()]
        if not states:
            return FLEET_HEALTHY
        if all(s == HOST_DEAD for s in states):
            return FLEET_PARTITIONED
        if any(s != HOST_HEALTHY for s in states) \
                or any(not h.ready for h in self.hosts.values()):
            return FLEET_DEGRADED
        return FLEET_HEALTHY

    def health(self) -> Dict:
        return {
            "state": self.degradation(),
            "heartbeat_s": self.heartbeat_s,
            "suspect_after": self.suspect_after,
            "dead_after": self.dead_after,
            "hosts": {
                name: {
                    "state": h.state,
                    "ready": h.ready,
                    "missed_beats": h.missed,
                    "beats": h.beats,
                    "failovers": h.failovers,
                    "rejoins": h.rejoins,
                    "push_entries": h.push_entries,
                    "push_bytes": h.push_bytes,
                    "push_retries": h.push_retries,
                    "breaker": h.breaker.snapshot(),
                } for name, h in self.hosts.items()},
        }

    def _record_state(self, host: _Host) -> None:
        if self.metrics is not None:
            self.metrics.record_host_state(host.name, host.state,
                                           missed=host.missed,
                                           ready=host.ready)

    def _emit(self, kind: str, **fields) -> None:
        if self.metrics is not None:
            self.metrics.record_event(kind, **fields)

    # -- monitor thread ----------------------------------------------------

    def start(self) -> None:
        """Run ``tick()`` on a daemon monitor thread (deployments and
        drills; the CPU tests drive ``tick`` directly)."""
        if self._monitor is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.heartbeat_s / 4):
                self.tick()

        self._monitor = threading.Thread(
            target=_loop, name="HostFleet-monitor", daemon=True)
        self._monitor.start()

    def close(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
            self._monitor = None
        for host in self.hosts.values():
            try:
                host.transport.close()
            except Exception:  # noqa: BLE001 — best-effort shutdown
                pass
