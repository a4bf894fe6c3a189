"""Follower ranks: the port's form of the JAX engine's single controller.

A JAX engine over a mesh is one process driving every device, so a
scheduler in that process reaches the whole mesh. Here a process drives
one device: a sharded engine's collectives meet only if every rank makes
the same engine calls in the same order. Every rank may do so itself
(the ``torchrun`` idiom, ``serving/engine.py``), but a scheduler runs on
one rank. So rank 0, the primary, *leads* (:func:`lead`): each call it
makes on a sharded engine that issues collectives, or changes what later
ones see, is announced on the mesh's control group (gloo, CPU tensors)
before it runs. Every other rank *follows* (:func:`follow`): it receives
each op and repeats it on its own copy of that engine.

An op is a header of :data:`HEADER` int64s broadcast from rank 0 (op
code, engine id, arguments), then its payload where it has one:

- ``INFER`` (bucket, crop, bytes a rank): each follower's block of the
  bucket the primary filled on the host (its ``data`` rows and its
  ``spatial`` band; frames in the wire dtype, ``flow_init`` in fp32), one
  ``scatter``; the follower runs its block of the program;
- ``ENSURE`` (table, bucket, built): a table entry, built or a
  placeholder, so every rank's tables stay equal (building a multi-rank
  program runs nothing: it is eager);
- ``DROP`` (table, bucket): a bucket forgotten (a wedge verdict's);
- ``SWAP`` (bytes): ``update_weights``, the state dict in one broadcast;
- ``SPAWN`` (new id): ``spawn_replica``; each follower makes the sibling
  mesh's groups (``Mesh.sibling``, in the primary's order) and its own
  replica from its copy of the source's weights;
- ``RETIRE``: an engine closed (a quarantined lane's replica);
- ``CLOSE``: the channel ends, and :func:`follow` returns.

On the primary an op and the engine's own part of it are one atom under
the engine's lock, so each engine's ops reach the channel in its call
order; the channel's lock keeps one op's header and payload together
while the lanes' ops interleave. A follower receives on one thread and
hands each op to a worker thread per engine, in order: the primary's
lanes run their engines at once, each blocked in its own groups'
collectives, and one follower thread would deadlock on the second.

A follower that fails an op prints the reason and ends its process with
exit code 1, so it never sits in a collective; the primary's next
collective or send then fails, the channel is marked failed, and every
later call on its engines raises :class:`ChannelDead` at once, without
the engine's lock or the channel.
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist

#: the channel's lock is a leaf: nothing is acquired under it but the
#: control group's sends (it nests inside each engine's lock)
LOCK_ORDER = (("follow.Channel._lock",),)

#: int64 slots of an op's header
HEADER = 16
HELLO, INFER, ENSURE, DROP, SWAP, SPAWN, RETIRE, CLOSE = range(1, 9)
OP_NAMES = {INFER: "infer", ENSURE: "ensure", DROP: "drop", SWAP: "swap",
            SPAWN: "spawn", RETIRE: "retire", CLOSE: "close",
            HELLO: "hello"}
#: how long a call that must not stall the scheduler's dispatcher (a
#: wedge verdict's ``drop_bucket``, a lane's ``close``) waits for a
#: leading engine's lock before it gives the channel up as failed: a
#: lane that holds the lock past this is blocked in a collective
LOCK_WAIT_S = 5.0
#: a follower's exit code when an op or the channel failed
FOLLOWER_FAILED_EXIT_CODE = 1


class ChannelDead(RuntimeError):
    """The op channel failed (a follower died, or a collective of a
    sharded program failed) or was closed: the ranks are out of step, and
    no call on a leading engine can run."""


class Channel:
    """The primary's side of the op channel over ``mesh``'s control
    group. ``stats``: per op name (and per ``"infer BxHxW"`` bucket),
    ``[ops, bytes sent to the followers, seconds in the sends]``."""

    def __init__(self, mesh):
        if mesh.control_group is None:
            raise ValueError("a channel needs a mesh of more than one rank")
        self.group = mesh.control_group
        self.followers = mesh.size - 1
        self._lock = threading.Lock()
        self._ids = itertools.count()
        #: the exception that failed the channel (None while it works)
        self.failed: Optional[BaseException] = None
        self.closed = False
        self.stats: Dict[str, list] = {}

    def new_id(self) -> int:
        return next(self._ids)

    def alive(self) -> None:
        """Raise :class:`ChannelDead` unless the channel works."""
        if self.failed is not None:
            raise ChannelDead(f"the follower channel failed: "
                              f"{self.failed!r}") from self.failed
        if self.closed:
            raise ChannelDead("the follower channel is closed")

    def fail(self, exc: BaseException) -> None:
        if self.failed is None:
            self.failed = exc

    def send(self, op: int, eid: int, args=(), scatter=None,
             payload: Optional[torch.Tensor] = None) -> None:
        """Announce one op: its header, then ``scatter`` (one tensor a
        rank, rank 0's first) or ``payload`` (broadcast whole)."""
        header = torch.zeros(HEADER, dtype=torch.int64)
        header[0], header[1] = op, eid
        if args:
            header[2:2 + len(args)] = torch.tensor(args, dtype=torch.int64)
        with self._lock:
            self.alive()
            t0 = time.perf_counter()
            try:
                dist.broadcast(header, 0, group=self.group)
                nbytes = header.nbytes * self.followers
                if scatter is not None:
                    out = torch.empty_like(scatter[0])
                    dist.scatter(out, list(scatter), src=0, group=self.group)
                    nbytes += sum(t.nbytes for t in scatter[1:])
                if payload is not None:
                    dist.broadcast(payload, 0, group=self.group)
                    nbytes += payload.nbytes * self.followers
            except Exception as exc:
                self.fail(exc)
                raise ChannelDead(f"the follower channel failed in "
                                  f"{OP_NAMES[op]}: {exc!r}") from exc
            seconds = time.perf_counter() - t0
            names = [OP_NAMES[op]]
            if op == INFER:     # and by bucket
                names.append("infer {}x{}x{}".format(*args[:3]))
            for name in names:
                s = self.stats.setdefault(name, [0, 0, 0.0])
                s[0] += 1
                s[1] += nbytes
                s[2] += seconds

    def close(self) -> None:
        """End the channel: the followers' :func:`follow` returns. A
        failed or closed channel sends nothing."""
        if self.failed is not None or self.closed:
            return
        try:
            self.send(CLOSE, -1)
        except ChannelDead:
            return
        self.closed = True


def _hello(engine) -> list:
    """What every rank's engine must agree on before the channel opens."""
    mesh = engine.mesh
    return [mesh.shape["data"], mesh.shape["spatial"], engine.iters,
            int(engine.warm_start), int(engine.wire == "u8"),
            int(engine.exact_shapes), engine.executable_count()]


def lead(engine) -> Channel:
    """Make rank 0's multi-rank ``engine`` the primary of a new channel:
    every other rank must call :func:`follow` with the same engine (same
    weights, config and flags, the same mesh). Returns the channel (the
    scheduler's ``close`` closes it)."""
    mesh = engine.mesh
    if mesh is None or mesh.size == 1:
        raise ValueError("lead: an engine on a mesh of more than one rank")
    if mesh.rank != 0:
        raise ValueError(f"lead on rank {mesh.rank}: rank 0 leads, every "
                         "other rank follows")
    channel = Channel(mesh)
    channel.send(HELLO, -1, _hello(engine))
    engine._lead(channel, channel.new_id())
    return channel


def _die(what: str) -> None:
    """A follower that cannot go on: the reason, then exit code 1, so it
    never sits in a collective its peers wait on."""
    traceback.print_exc()
    print(f"follower rank {dist.get_rank()}: {what} failed; exiting",
          file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(FOLLOWER_FAILED_EXIT_CODE)


class _Worker:
    """One engine's ops on a follower, in order, on a thread of its own."""

    def __init__(self, eid: int, engine=None):
        self.eid = eid
        self.engine = engine
        self.q: "queue.Queue[Optional[Callable]]" = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"follow-e{eid}")
        self.thread.start()

    def stop(self) -> None:
        """End the thread once it has run the ops queued before this."""
        self.q.put(None)

    def join(self) -> None:
        self.thread.join()

    def _run(self) -> None:
        task = None
        try:
            while True:
                task = self.q.get()
                if task is None:
                    return
                task(self)
        except Exception:   # noqa: BLE001 — never sit in a collective
            _die(f"engine {self.eid}'s op {getattr(task, 'op', '?')}")


def _task(op: str, fn: Callable) -> Callable:
    fn.op = op
    return fn


def follow(engine, on_output: Optional[Callable] = None) -> Dict[int, Dict]:
    """Run, on a rank other than 0, every op the primary announces for its
    engines, until it closes the channel; ``engine`` is this rank's copy
    of the primary's engine (same weights, config, flags and mesh).

    ``on_output(engine_id, flow)``: called with each dispatch's flow
    (whole, cropped to the request, host numpy), bitwise the primary's.
    Returns each engine's end state by id: its ``tables``,
    ``weights_version``, ``dispatches`` and whether it was ``retired``.
    A failed op ends the process with exit code 1."""
    mesh = engine.mesh
    if mesh is None or mesh.size == 1 or mesh.rank == 0:
        raise ValueError("follow: a multi-rank engine on a rank other "
                         "than 0")
    group = mesh.control_group
    meshes = {0: mesh}
    workers = {0: _Worker(0, engine)}
    retired = set()
    ends: Dict[int, Dict] = {}
    header = torch.zeros(HEADER, dtype=torch.int64)

    def end(eid: int, retired: bool) -> Callable:
        def record(w):
            ends[eid] = dict(w.engine.follower_state(), retired=retired)
        return _task("end", record)

    def infer(args, packed):
        bucket, crop = tuple(args[:3]), tuple(args[3:8])

        def run(w):
            flow = w.engine._follow_infer(bucket, crop, packed)
            if on_output is not None:
                on_output(w.eid, flow)
        return _task("infer", run)

    def spawn(src: int, new: int):
        # the sibling's groups: made here, in the channel's order, as
        # the primary makes them right after announcing the spawn
        sib = meshes[src].sibling()
        meshes[new] = sib
        # the source's worker hands its engine and weights to the new one
        got: "queue.SimpleQueue" = queue.SimpleQueue()
        workers[src].q.put(_task("spawn", lambda w: got.put(
            (w.engine, w.engine.weights_copy()))))
        workers[new] = _Worker(new)

        def build(w):
            source, weights = got.get()
            w.engine = source._sibling(weights, sib)
        workers[new].q.put(_task("spawn", build))

    try:
        dist.broadcast(header, 0, group=group)
        want = _hello(engine)
        got_hello = header[2:2 + len(want)].tolist()
        if int(header[0]) != HELLO or got_hello != want:
            raise ValueError(f"follow: the primary's engine {got_hello} "
                             f"and this rank's {want} differ (mesh, iters, "
                             "warm_start, wire, exact_shapes, buckets)")
        while True:
            dist.broadcast(header, 0, group=group)
            op, eid = int(header[0]), int(header[1])
            args = header[2:].tolist()
            if op == CLOSE:
                break
            if op == INFER:
                packed = torch.empty(args[8], dtype=torch.uint8)
                dist.scatter(packed, None, src=0, group=group)
                workers[eid].q.put(infer(args, packed))
            elif op == ENSURE:
                workers[eid].q.put(_task("ensure", lambda w, a=args:
                                         w.engine._follow_ensure(*a[:5])))
            elif op == DROP:
                workers[eid].q.put(_task("drop", lambda w, a=args:
                                         w.engine._follow_drop(*a[:4])))
            elif op == SWAP:
                payload = torch.empty(args[0], dtype=torch.uint8)
                dist.broadcast(payload, 0, group=group)
                workers[eid].q.put(_task("swap", lambda w, p=payload:
                                         w.engine._follow_swap(p)))
            elif op == SPAWN:
                spawn(eid, args[0])
            elif op == RETIRE:
                retired.add(eid)
                workers[eid].q.put(end(eid, True))
                workers[eid].stop()
            else:
                raise ValueError(f"follow: unknown op {op}")
    except Exception:   # noqa: BLE001 — never sit in a collective
        _die("the op channel")
    for eid, w in workers.items():
        if eid not in retired:
            w.q.put(end(eid, False))
            w.stop()
    for w in workers.values():
        w.join()
    return ends


def pack_state(state: Mapping[str, torch.Tensor], keys) -> torch.Tensor:
    """``state``'s tensors in ``keys``' order as one uint8 tensor on the
    host (a SWAP's payload)."""
    return torch.cat([state[k].detach().cpu().contiguous().reshape(-1)
                      .view(torch.uint8) for k in keys])


def unpack_state(buf: torch.Tensor, like: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """:func:`pack_state`'s inverse over ``like``'s keys, shapes and
    dtypes (host tensors)."""
    sizes = [v.numel() * v.element_size() for v in like.values()]
    if sum(sizes) != buf.numel():
        raise ValueError(f"a swap of {buf.numel()} bytes for a state of "
                         f"{sum(sizes)}")
    out, off = {}, 0
    for (k, v), n in zip(like.items(), sizes):
        out[k] = buf[off:off + n].clone().view(v.dtype).reshape(v.shape)
        off += n
    return out
