"""Placement: device assignment + dispatch-mode decisions for the
replica fleet; port of ``raft_tpu/parallel/placement.py``.

On one card every replica's nominal device is ``cuda:0``: the fleet
there is a failure domain (a wedged lane is quarantined while another
serves), not more devices.

The scheduler used to own these decisions implicitly — ``_route`` /
``ensure_bucket`` calls straight into ONE engine meant "this bucket
runs on that engine's device, data-parallel never, always". With the
fleet (``MicroBatchScheduler(replicas=N)``) those are real decisions,
and this module is their single owner, sitting over the engine's
``partitioner`` (the mesh seam, ROADMAP M9):

- **Replica construction + device assignment**: replicas 2..N are
  siblings of the primary engine (``RAFTEngine.spawn_replica``: a copy
  of its weights and its own capture of each of its programs). Each
  replica gets a NOMINAL device from a
  round-robin over the local device table (``cuda:i``): on a CPU-only
  host the assignment is observability (it names which device a real
  multi-card deployment would pin), on real hardware it is the
  pinning input.
- **Per-bucket dispatch mode** (:meth:`decide`): data-parallel
  ``"replicate"`` by default — N replicas each run whole micro-batches
  — versus ``"shard"`` for 4K-class frames whose single-pair FLOPs are
  worth splitting across the mesh: those buckets pin to the PRIMARY
  lane (the engine that carries the partitioner/mesh, running a
  sharded batch), because a spatially-sharded program and a
  replica-local program are different executables with different
  failure domains.
- **Bucket capacity/warming** (:meth:`bucket_fit`): the
  capacity-probe-or-ensure logic refactored OUT of the scheduler's
  ``_shape_capacity`` — one copy, engine-parametric, so every replica
  warms its bucket exactly the way the single engine always did
  (byte-identical at ``replicas=1``).
- **Scaling policy** (:meth:`want_scale_up` / :meth:`want_retire`):
  queue-depth-driven activation up to a configured ceiling, idle-time
  retirement back down to the configured floor.

Nothing here builds programs or moves tensors; the engines do. A
duck-typed engine without ``spawn_replica`` works at
``replicas=1`` (no spawning happens) or with an explicit ``engines``
list (the tests' fake-fleet path).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: Placement is deliberately LOCK-FREE — the scheduler calls every
#: method here while holding its own locks, so this layer must never
#: acquire anything of its own.
LOCK_ORDER = ()

GRAFTTHREAD = {
    "locks": (),
}

#: padded H*W at/above which a bucket is 4K-class: one pair's FLOPs are
#: worth sharding across the mesh instead of replicating the whole
#: micro-batch (2160x3840 = UHD)
SHARD_PX_THRESHOLD = 2160 * 3840


class Placement:
    """Device assignment + per-bucket dispatch mode for one variant's
    engine fleet.

    ``engine``: the primary (replica 0 — the one the registry built,
    possibly mesh-armed). ``replicas``: fleet floor — how many engines
    exist and start active. ``ceiling``: how many the scheduler may
    grow to under queue pressure (default: the floor — no growth).
    ``engines``: pre-built engine list overriding spawning (primary
    first; for tests/fakes). ``shard_px_threshold``: the 4K-class
    boundary for :meth:`decide`.
    """

    def __init__(self, engine, *, replicas: int = 1,
                 ceiling: Optional[int] = None,
                 engines: Optional[List] = None,
                 shard_px_threshold: int = SHARD_PX_THRESHOLD):
        self.primary = engine
        self.replicas = max(1, int(replicas))
        self.ceiling = (self.replicas if ceiling is None
                        else max(self.replicas, int(ceiling)))
        self.shard_px_threshold = int(shard_px_threshold)
        self.partitioner = getattr(engine, "partitioner", None)
        if engines is not None:
            if not engines or engines[0] is not engine:
                raise ValueError(
                    "engines must be the fleet's engine list with the "
                    "primary first")
            if len(engines) < self.replicas:
                raise ValueError(
                    f"engines has {len(engines)} entries but "
                    f"replicas={self.replicas}")
            self.engines = list(engines)
        else:
            self.engines = [engine]
            for _ in range(1, self.replicas):
                self.engines.append(self._spawn())
        #: replica index -> nominal device label (round-robin)
        self.assignments: Dict[int, str] = {
            k: self._device_label(k) for k in range(len(self.engines))}
        #: host name -> {"lane": index, "state": ...} for lanes that
        #: live on REMOTE hosts (serving/hosts.py); empty at hosts=0
        self.hosts: Dict[str, Dict] = {}

    # -- multi-host lanes ---------------------------------------------------

    def attach_host(self, name: str, engine) -> int:
        """Append a remote host's engine as one more fleet lane (after
        the local lanes, so local indices never move). The ceiling
        grows with it — host lanes are extra capacity, not consumers
        of the local-replica growth headroom. Returns the lane
        index."""
        k = len(self.engines)
        self.engines.append(engine)
        self.ceiling += 1
        self.assignments[k] = f"host:{name}"
        self.hosts[name] = {"lane": k, "state": "healthy"}
        return k

    def mark_host(self, name: str, state: str) -> None:
        """Record a host's liveness verdict (``healthy``/``suspect``/
        ``dead``) against its lane — the quarantine-on-the-placement-
        layer half of a dead-host verdict."""
        if name in self.hosts:
            self.hosts[name]["state"] = state

    def host_lane(self, name: str) -> Optional[int]:
        h = self.hosts.get(name)
        return None if h is None else h["lane"]

    # -- replica construction ---------------------------------------------

    def _spawn(self):
        spawn = getattr(self.primary, "spawn_replica", None)
        if spawn is None:
            raise ValueError(
                "replicas>1 needs an engine with spawn_replica (or an "
                "explicit engines list)")
        return spawn()

    def grow(self):
        """Build one more replica engine (scheduler scale-up past the
        constructed fleet, bounded by ``ceiling``); returns the new
        engine and records its nominal device."""
        if len(self.engines) >= self.ceiling:
            raise ValueError(
                f"fleet at ceiling ({self.ceiling}) — cannot grow")
        eng = self._spawn()
        k = len(self.engines)
        self.engines.append(eng)
        self.assignments[k] = self._device_label(k)
        return eng

    def _device_label(self, k: int) -> str:
        """Nominal device for replica ``k``: round-robin over the local
        device table. On the forced-host-platform CPU gate every label
        is ``device:k`` — the assignment a real deployment pins
        replicas by is ``cuda:i``."""
        devs = self._devices()
        if not devs:
            return f"device:{k}"
        return str(devs[k % len(devs)])

    def _devices(self) -> List:
        import torch

        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    # -- per-bucket dispatch mode -----------------------------------------

    def decide(self, key: Tuple) -> str:
        """Dispatch mode for a coalescing-group key (``(H, W)`` or the
        longer cached/ragged forms — dims 0/1 are always the spatial
        extents): ``"replicate"`` (default — whole micro-batches fan
        out across replica lanes) or ``"shard"`` (4K-class frames on a
        mesh-armed primary: the batch shards, so the bucket pins
        to the primary lane). On a mesh of more than one rank the
        primary must lead follower ranks (``parallel.follow``), which
        repeat its dispatches: a ``"shard"`` bucket there raises
        ``NotImplementedError`` when it leads none (the ``torchrun``
        idiom, where every rank calls the engine itself and no
        scheduler can drive the other ranks)."""
        if self.partitioner is None:
            return "replicate"
        h, w = int(key[0]), int(key[1])
        if h * w < self.shard_px_threshold:
            return "replicate"
        ranks = getattr(getattr(self.partitioner, "mesh", None), "size", 1)
        if ranks > 1 and not getattr(self.primary, "leads", False):
            raise NotImplementedError(
                f"the 'shard' route for a {h}x{w} bucket on a mesh of "
                f"{ranks} ranks whose primary leads no follower ranks: a "
                "scheduler on one rank reaches the others only through "
                "parallel.follow (follow.lead on rank 0, follow.follow on "
                "every other rank)")
        return "shard"

    # -- bucket capacity / warming (ex scheduler._shape_capacity) ---------

    @staticmethod
    def bucket_fit(engine, key: Tuple, max_batch: int) -> int:
        """Capacity-probe-or-warm for one coalescing key on ONE engine
        — the logic the scheduler's ``_shape_capacity`` carried, now
        engine-parametric so each replica warms its own table (an AOT
        store would turn the warm into a load). Returns the
        bucket/class batch fit; may capture a program (never call
        under a lock)."""
        h, w = key[0], key[1]
        if len(key) > 2 and key[2] == "ragged":
            # capacity-class group: key dims ARE the class box.
            # Pre-warm ONE class at max_batch so every later fill
            # count (and shape mix) batch-fills into it — one
            # program per class, across shapes.
            fit = engine.ragged_capacity(h, w)
            if fit is None:
                fit = engine.ensure_ragged(max_batch, h, w)[0]
        elif len(key) > 2:
            # feature-cache group: its own signature table — the
            # plain kwarg-less calls below stay byte-identical for
            # duck-typed engines without the cached API
            fit = engine.bucket_capacity(h, w, cached=True)
            if fit is None:
                fit = engine.ensure_bucket(max_batch, h, w,
                                           cached=True)[0]
        else:
            fit = engine.bucket_capacity(h, w)
            if fit is None:
                # no built bucket fits this spatial shape: pre-warm
                # exactly one at max_batch so every later fill count
                # batch-fills into it (one program per shape). After a
                # wedge dropped the bucket, this is also the half-open
                # probe's lazy recapture.
                fit = engine.ensure_bucket(max_batch, h, w)[0]
        return fit

    # -- scaling policy ----------------------------------------------------

    def want_scale_up(self, queue_depth: int, active: int,
                      max_batch: int) -> bool:
        """Activate another replica when the queue holds more work
        than the active lanes can coalesce in one dispatch round each
        — sustained pressure, not a blip — and the ceiling allows."""
        return (active < self.ceiling
                and queue_depth > active * max(1, max_batch))

    def want_retire(self, idle_s: float, active: int,
                    idle_retire_s: float) -> bool:
        """Retire an idle lane back toward the configured floor."""
        return active > self.replicas and idle_s >= idle_retire_s

    # -- observability -----------------------------------------------------

    def snapshot(self) -> Dict:
        return {
            "replicas": len(self.engines),
            "floor": self.replicas,
            "ceiling": self.ceiling,
            "shard_px_threshold": self.shard_px_threshold,
            "mesh": self.partitioner is not None,
            "assignments": {f"r{k}": v
                            for k, v in sorted(self.assignments.items())},
            **({"hosts": {name: dict(h)
                          for name, h in sorted(self.hosts.items())}}
               if self.hosts else {}),
        }
