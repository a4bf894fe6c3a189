"""Deterministic fault injection for crash-safety drills, port of
``raft_tpu/testing/faults.py`` (the trainer's, the serving stack's, the
program store's and the host fleet's sites).

The watchdog, the atomic checkpoints, the restore sandbox, the supervisor
and the loader's policies are only trustworthy if their failure paths run.
This module arms *named* fault sites on the training path from a JSON plan
(the JAX package's format and site names, so one plan drives either
package)::

    RAFT_FAULT_PLAN='[{"site": "ckpt.orbax_save", "at": 2,
                       "kind": "corrupt"}]' python -m raft_tpu_torch.cli.train ...

The entry point arms the plan (``cli/train`` calls :func:`arm_from_env`);
importing this module arms nothing.

Plan entries (a list of dicts, or ``{"faults": [...], "seed": N}``):

``site``
    A dotted name from :data:`KNOWN_SITES`. Undotted names are legal for
    the harness's own tests, which arm sites that exist only there.
``at``
    1-based occurrence at which the entry becomes eligible (default 1).
``count``
    Most fires (default 1; ``0`` is unlimited): with ``at``, occurrences
    ``at`` through ``at + count - 1``.
``p``
    Fire probability per eligible call, in ``(0, 1]`` (default 1), drawn
    from a ``random.Random`` seeded by the plan's ``"seed"`` (default 0).
``kind``
    ``"raise"`` (:class:`FaultInjected`), ``"hang"`` (sleep ``hang_s``,
    default 3600 s: what a wedged device looks like to the loop),
    ``"crash"`` (``os._exit(CRASH_EXIT_CODE)``: no atexit, no finally, as
    power loss or a preemption leaves things), ``"corrupt"`` (zero-fills
    the artifact at a site that writes or reads one, or the bytes in
    transit at a transport site).
``attempt``
    The supervisor attempt (0-based, ``$RAFT_SUPERVISOR_ATTEMPT``) the
    entry arms in; without it, every attempt. A drill wedges the first run
    and lets the restarted one recover.

Disarmed, a site costs one module-global ``is None`` check.
"""

from __future__ import annotations

import difflib
import json
import os
import random
import threading
import time
from typing import List, Optional

#: simulated abrupt death; distinct from the watchdog's exit 3 so the
#: supervisor and runbooks can tell a drill's crash from a wedge
CRASH_EXIT_CODE = 41

#: every site armed in raft_tpu_torch, one line each. Plans are checked
#: against it when armed, so a typo'd site fails instead of arming nothing.
#: Add the row with the ``fault_point``/``fault_file``/``fault_data`` call.
KNOWN_SITES = {
    "loader.sample": "per-sample decode and augmentation in the "
                     "PrefetchLoader's workers, under on_bad_sample",
    "trainer.step": "top of the training loop, once per step",
    "ckpt.msgpack_write": "weights-only .pth save (point: between the "
                          "fsync'd temporary file and the rename; corrupt: "
                          "the finished file)",
    "ckpt.orbax_save": "full-state save (corrupt zero-fills the step "
                       "directory's state file after it is committed)",
    "serve.request": "per micro-batch dispatch in the serving scheduler's "
                     "worker (MicroBatchScheduler._dispatch, every kind "
                     "of program)",
    "serve.dispatch_exec": "top of the supervised dispatch executor's job "
                           "loop (resilience.DispatchExecutor; watchdog "
                           "quarantine drill)",
    "scheduler.swap": "MicroBatchScheduler.swap_weights, before each "
                      "engine's weights are touched (raise: the swap fails; "
                      "a fleet rolls the lanes already swapped back, so "
                      "every lane keeps the old weights)",
    "serve.fetch": "PendingBatch.fetch in "
                   "serving/engine.py, before waiting for the device result "
                   "(hang: a dispatch that never completes)",
    "engine.compile": "RAFTEngine._get_program in serving/engine.py, before "
                      "a bucket's program is built (on the card, a CUDA graph "
                      "captured)",
    "registry.load": "ModelRegistry._build_variant in serving/registry.py, "
                     "before a variant's engine and scheduler are built "
                     "(raise: a failed deploy rolls back automatically, "
                     "live traffic untouched)",
    "guardian.decide": "SLOGuardian._decide in serving/guardian.py, after "
                       "judgment and before the registry's promote or "
                       "rollback (raise/hang: routing stays as it was)",
    "aot.load": "AOTCache.load in serving/aot.py, the verified load of a "
                "stored program (corrupt: the entry's blob zero-filled on "
                "disk before the read; raise: inside the verification "
                "scope; either reads as a clean miss)",
    "transport.send": "Transport.call in serving/transport.py, request side "
                      "(corrupt zero-fills the encoded request in transit: "
                      "a clean TransportError the caller retries)",
    "transport.recv": "Transport.call in serving/transport.py, reply side "
                      "(same retry contract)",
    "host.heartbeat": "one heartbeat probe in HostFleet.beat "
                      "(serving/hosts.py; the missed-beat ladder drill)",
    "host.infer": "HostWorker's infer in serving/hosts.py, on the worker "
                  "side of the wire (a host dying mid-batch: failover by "
                  "requeue)",
}

_POINT_KINDS = ("raise", "hang", "crash")
_ALL_KINDS = _POINT_KINDS + ("corrupt",)


class FaultInjected(RuntimeError):
    """Raised at an armed ``kind="raise"`` fault site."""


class _Entry:
    __slots__ = ("site", "at", "kind", "hang_s", "p", "count", "seen",
                 "fires")

    def __init__(self, spec: dict):
        self.site = spec["site"]
        if "." in self.site and self.site not in KNOWN_SITES:
            near = difflib.get_close_matches(self.site, KNOWN_SITES, n=1)
            hint = f" — did you mean {near[0]!r}?" if near else ""
            raise ValueError(
                f"unknown fault site {self.site!r}: not in "
                f"faults.KNOWN_SITES{hint} (a typo'd site arms nothing and "
                "the drill silently tests less than it claims)")
        self.at = int(spec.get("at", 1))
        self.kind = spec["kind"]
        self.hang_s = float(spec.get("hang_s", 3600.0))
        self.p = float(spec.get("p", 1.0))
        self.count = int(spec.get("count", 1))
        if self.kind not in _ALL_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} at site {self.site!r}: choose "
                f"one of {_ALL_KINDS}")
        if self.at < 1:
            raise ValueError(f"fault at={self.at} at site {self.site!r}: "
                             "occurrence counts are 1-based")
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"fault p={self.p} at site {self.site!r}: "
                             "must be in (0, 1]")
        if self.count < 0:
            raise ValueError(f"fault count={self.count} at site "
                             f"{self.site!r}: must be >= 0 (0=unlimited)")
        self.seen = 0
        self.fires = 0

    @property
    def exhausted(self) -> bool:
        return self.count > 0 and self.fires >= self.count


_PLAN: Optional[List[_Entry]] = None
_RNG = random.Random(0)
_LOCK = threading.Lock()


def arm(plan) -> None:
    """Arm ``plan`` (a list of entry dicts, or ``{"faults": [...], "seed":
    N}``); entries scoped to another supervisor attempt are dropped."""
    global _PLAN, _RNG
    seed = 0
    if isinstance(plan, dict):
        seed = int(plan.get("seed", 0))
        plan = plan.get("faults", [])
    attempt = int(os.environ.get("RAFT_SUPERVISOR_ATTEMPT", "0"))
    entries = [_Entry(spec) for spec in plan
               if int(spec.get("attempt", attempt)) == attempt]
    _RNG = random.Random(seed)
    _PLAN = entries or None


def disarm() -> None:
    global _PLAN
    _PLAN = None


def arm_from_env() -> None:
    """Arm from ``$RAFT_FAULT_PLAN`` (inline JSON) or
    ``$RAFT_FAULT_PLAN_FILE``; neither set arms nothing."""
    raw = os.environ.get("RAFT_FAULT_PLAN")
    if not raw:
        path = os.environ.get("RAFT_FAULT_PLAN_FILE")
        if path:
            with open(path, encoding="utf-8") as fh:
                raw = fh.read()
    if raw:
        arm(json.loads(raw))


def armed(site: str) -> bool:
    """True iff an un-exhausted entry for ``site`` exists."""
    if _PLAN is None:
        return False
    with _LOCK:
        return any(e.site == site and not e.exhausted for e in _PLAN)


def _match(site: str, kinds) -> Optional[_Entry]:
    """Count this call against every matching entry of a kind the call can
    serve; return the first whose occurrence just came due (and whose
    ``p`` draw fired)."""
    due = None
    with _LOCK:
        for e in _PLAN or ():
            if e.site != site or e.exhausted or e.kind not in kinds:
                continue
            e.seen += 1
            if due is None and e.seen >= e.at:
                if e.p < 1.0 and _RNG.random() >= e.p:
                    continue
                e.fires += 1
                due = e
    return due


def fault_point(site: str) -> None:
    """crash/hang/raise injection point: a no-op unless a plan is armed."""
    if _PLAN is None:
        return
    e = _match(site, _POINT_KINDS)
    if e is None:
        return
    if e.kind == "raise":
        raise FaultInjected(
            f"injected fault at {site} (occurrence {e.seen})")
    if e.kind == "hang":
        time.sleep(e.hang_s)
        return
    os._exit(CRASH_EXIT_CODE)


def fault_file(site: str, path: str) -> Optional[str]:
    """Corruption point for a finished on-disk artifact: zero-fills
    ``path`` (for a directory, a ``_METADATA`` file under it if there is
    one, else its largest file), keeping its size, so the load-time size
    check passes and the sha256 check is what has to catch it. Call sites
    place it after the artifact and its manifest are complete. Returns the
    victim's path when the entry fired, else None."""
    if _PLAN is None:
        return None
    if _match(site, ("corrupt",)) is None:
        return None
    victim = path
    if os.path.isdir(path):
        victim, size, meta = None, -1, None
        for root, _, files in os.walk(path):
            for f in sorted(files):
                p = os.path.join(root, f)
                if f == "_METADATA" and meta is None:
                    meta = p
                s = os.path.getsize(p)
                if s > size:
                    victim, size = p, s
        victim = meta or victim
        if victim is None:
            return None
    n = os.path.getsize(victim)
    with open(victim, "r+b") as fh:
        fh.write(b"\x00" * n if n else b"\x00")
    return victim


def fault_data(site: str, payload: bytes) -> bytes:
    """Corruption point for bytes in transit: ``payload`` zero-filled
    (size kept) when a ``kind="corrupt"`` entry for ``site`` fires, else
    untouched."""
    if _PLAN is None:
        return payload
    if _match(site, ("corrupt",)) is None:
        return payload
    return b"\x00" * len(payload) if payload else b"\x00"
