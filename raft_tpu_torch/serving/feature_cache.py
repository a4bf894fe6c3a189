"""Cross-frame device feature cache: per-stream encoder state; port of
``raft_tpu/serving/feature_cache.py``.

RAFT's encoders are roughly half the serve FLOPs, and consecutive
video pairs share a frame — frame t's ``fmap2`` (plus a speculative
context encoding of frame t) ARE pair (t, t+1)'s ``fmap1``/context
inputs (models/raft.py ``forward_cached``). This module is the state
side of that reuse (the compiler-first O(1) autoregressive-cache
discipline of arXiv 2603.09555): a capacity-managed pool of per-stream
**slots**, each holding the stream's last frame's feature map, its
speculative context encoding, and the recurrence's ``flow_low`` — all
as DEVICE arrays, so warm-stream state never crosses the host boundary
between frames.

Validity is structural, not hopeful. A slot is keyed by stream id and
stamped with:

- the request geometry (``key`` = (H, W)) — a mid-stream resolution
  change can never feed old-geometry features to a new-geometry pair;
- a **sequence number** (the session's frame counter) — a pair at seq
  t only matches a slot at seq t-1, so ANY missed store (failed pair,
  queued-deadline expiry, wedge) turns into a clean submit-time miss
  instead of silently correlating against the wrong frame's features;
- the engine's **weights version** — features computed by one weight
  tree must never feed a refinement running another (the registry's
  promote/rollback flush is the broom; this stamp is the backstop the
  flush drill pins).

Any mismatch drops the slot and reads as a miss: the stream
cold-restarts (re-primes) — the pool never serves stale state.

Eviction is LRU at ``capacity``: ``store`` always lands (stream
continuity first), then evicts least-recently-used slots down to the
bound — thousands of concurrent sessions degrade to cache churn
(visible in ``hit_rate``), never to unbounded device memory. Arrays
evicted while a dispatch still references them stay alive until that
dispatch completes (the caching allocator's stream bookkeeping: the
engine records its stream on every cache row it reads). A slot holds
its OWN tensors — clones of its row, never views into a dispatch's
batch output (the scheduler clones at store) — so evicting a slot
frees its memory: at 440x1024 a basic-model slot is about 14.5 MB,
a view into a batch-4 output would pin about 58 MB.

Slots store opaque tensor handles.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Hashable, Optional, Tuple

#: the pool lock is a LEAF. The scheduler takes it from
#: submit (validity probe, before its queue lock), dispatch assembly
#: and completion store (neither holds a scheduler lock), and the
#: metrics snapshot reads it with NO metrics lock held (the provider
#: runs before the snapshot's own lock — metrics.ServingMetrics).
#: Nothing may call back into scheduler/registry/metrics from under it.
LOCK_ORDER = (("feature_cache.FeatureCachePool._lock",),)

#: graftthread declarations: one lock, no callbacks, no threads, no
#: futures; every method is dict bookkeeping under ``_lock``.
GRAFTTHREAD = {"locks": ("_lock",)}


class FeatureCacheMiss(RuntimeError):
    """A cached submit found no valid slot for its stream (never
    primed, LRU-evicted, flushed by a weight swap, seq hole from a
    failed pair, or a geometry change): cold-restart the stream —
    re-prime its previous frame, then resubmit the pair. The
    ``VideoSession(feature_cache=True)`` state machine does exactly
    that; the error is the signal, not a failure of the request's
    frame data."""


class _Slot:
    """One stream's cached state. Arrays are device handles at the
    stream's 1/8-res ÷8-padded geometry; ``flow_low`` is None when the
    recurrence is cold (the slot came from a PRIME dispatch, whose
    flow output is meaningless)."""

    __slots__ = ("key", "seq", "version", "fmap", "ctx", "flow_low")

    def __init__(self, key: Tuple[int, int], seq: int, version: int,
                 fmap, ctx, flow_low):
        self.key = key
        self.seq = seq
        self.version = version
        self.fmap = fmap
        self.ctx = ctx
        self.flow_low = flow_low


class FeatureCachePool:
    """Capacity-bounded LRU pool of per-stream feature slots.

    Thread-safe; every operation is O(1) dict work under one lock (no
    device calls, no I/O). Counters cover the
    operator questions: ``hits``/``misses`` (and the derived
    ``hit_rate``) say whether streams are actually warm, ``stale``
    splits out validity kills (seq hole / geometry / weights version),
    ``evictions`` says the capacity is too small for the live stream
    population, ``flushes`` counts invalidation brooms (weight swaps,
    rollouts, close).
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity={capacity}: need >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._slots: "OrderedDict[Hashable, _Slot]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.evictions = 0
        self.flushes = 0
        self.stores = 0

    # -- read side ---------------------------------------------------------

    def valid(self, stream: Hashable, key: Tuple[int, int],
              seq: int) -> bool:
        """Would ``acquire`` succeed right now (version aside)? The
        submit-time probe behind the fail-fast ``FeatureCacheMiss`` —
        counts nothing (the dispatch-time ``acquire`` owns the
        hit/miss accounting; ``record_miss`` covers the raise)."""
        with self._lock:
            slot = self._slots.get(stream)
            return (slot is not None and slot.key == tuple(key)
                    and slot.seq == seq)

    def record_miss(self, stale: bool = False) -> None:
        """Count a submit-time miss (the ``valid`` probe failed and
        the submit raised)."""
        with self._lock:
            self.misses += 1
            if stale:
                self.stale += 1

    def acquire(self, stream: Hashable, key: Tuple[int, int], seq: int,
                version: int) -> Optional[_Slot]:
        """The dispatch-time read: the stream's slot if it matches
        ``key``/``seq``/``version``, else None. A mismatched slot is
        DROPPED (it can never become valid again — seq only moves
        forward, geometry changes restart streams, old-version
        features are poison) and counted stale."""
        with self._lock:
            slot = self._slots.get(stream)
            if slot is None:
                self.misses += 1
                return None
            if (slot.key != tuple(key) or slot.seq != seq
                    or slot.version != version):
                del self._slots[stream]
                self.misses += 1
                self.stale += 1
                return None
            self._slots.move_to_end(stream)
            self.hits += 1
            return slot

    # -- write side --------------------------------------------------------

    def store(self, stream: Hashable, key: Tuple[int, int], seq: int,
              version: int, fmap, ctx, flow_low) -> None:
        """Install/replace the stream's slot, then evict LRU slots
        down to ``capacity``. Store-first keeps the JUST-SERVED stream
        warm even under capacity pressure (evicting the newcomer would
        livelock every over-capacity stream into a re-prime loop);
        the transient overshoot is one slot, immediately corrected."""
        with self._lock:
            self._slots[stream] = _Slot(tuple(key), seq, version, fmap,
                                        ctx, flow_low)
            self._slots.move_to_end(stream)
            self.stores += 1
            while len(self._slots) > self.capacity:
                self._slots.popitem(last=False)
                self.evictions += 1

    def invalidate(self, stream: Hashable) -> bool:
        """Drop one stream's slot (session teardown hygiene). True if
        a slot was present."""
        with self._lock:
            return self._slots.pop(stream, None) is not None

    def flush(self) -> int:
        """Drop EVERY slot (weight swap, promote/rollback, close) —
        features from the old weight tree must never feed the new one.
        Returns how many slots were dropped. The caller owns the
        ``cache_flush`` metrics event (it knows the model/version to
        stamp)."""
        with self._lock:
            n = len(self._slots)
            self._slots.clear()
            self.flushes += 1
            return n

    # -- observability -----------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def snapshot(self) -> Dict:
        """The metrics.jsonl ``feature_cache`` block: counters plus
        the occupancy gauge."""
        with self._lock:
            looked = self.hits + self.misses
            return {
                "capacity": self.capacity,
                "occupancy": len(self._slots),
                "hits": self.hits,
                "misses": self.misses,
                "stale": self.stale,
                "evictions": self.evictions,
                "flushes": self.flushes,
                "stores": self.stores,
                "hit_rate": (round(self.hits / looked, 4) if looked
                             else 0.0),
            }
