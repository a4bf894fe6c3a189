"""Shape-bucketed serving engine, port of ``raft_tpu/serving/engine.py``:
the ``RAFTInferTRT`` analog.

The reference builds a TensorRT engine over a dynamic-shape envelope
(min/opt/max, ``cvt2trt.sh``) and binds I/O by name at run time
(raft_trt.py:12-39). The JAX engine AOT-compiles one executable per shape
bucket. Here each bucket is one CUDA graph on the card: the model's
test-mode forward captured once per bucket (and per table: plain, cached,
ragged), with static input buffers (the wire-dtype frames, ``flow_init``,
the ragged extents, the cached features) and static outputs. A request
routes to the smallest bucket that fits, is padded up on the host (batch
and spatial) and replays the bucket's graph: K1 and K2 (K5 under
``alternate_corr``) and every other launch of the forward, with no Python
between them. Nothing falls back: a capture or launch that fails raises.

On the CPU (``device="cpu"``, what the tests use) a bucket's program runs
the same forward eagerly on the same static buffers; no graph is captured.

A dispatch is one atom under the engine lock, on one stream the engine
owns: the padded frames go through a pinned buffer into the static inputs
(``non_blocking``), the graph replays, and the outputs the pending batch
hands back are cloned, since the next replay of the bucket overwrites the
static outputs. ``PendingBatch.fetch`` then waits on an event recorded
after the clone. Captures run outside the engine lock, as the JAX engine
compiles outside its lock: one at a time in the whole process (one lock
for every engine, so a replica capturing under load never races another
engine's capture, nor its attribution of kernel launches), each engine's
into its own memory pool (safe because that engine's replays are
serialised on its stream).

``update_weights`` copies a checkpoint into the module's own parameter and
buffer storage on the engine's stream, so every captured graph stays valid
(the analog of "swapping a checkpoint reuses every executable"), and stream
order makes each dispatch wholly old or wholly new.

Like the fork's single-output ONNX export (test_trt.py:131 names only
``flowup``), the engine returns only the upsampled flow unless
``warm_start``; the iteration count is baked at 20 (ITERS_EXPORT).

Replicas (``spawn_replica``, ``adopt_executables``) for the scheduler's
fleet: a JAX replica shares the primary's immutable executables, but a
captured graph has static buffers, one pool and one stream, and a weight
swap writes the module's own storage. So a replica here owns everything:
a copy of the parameters and buffers, its stream, its pool, its static
inputs and outputs, and its own capture of each of the primary's
programs (one capture per program, where JAX compiles none). A swap on
one lane then never writes a tensor another lane's replay reads.

The program store (``aot_cache=``, serving/aot.py): on a bucket's first
build the engine loads its exported program from the store (the
verification runs outside every lock) or, on a miss, exports the live
module with ``torch.export`` and stores it; either way it captures the
EXPORTED program, its parameters and buffers bound to the engine's live
tensors, so both paths capture one program and a weight swap reaches the
replay. A hit replaces the trace, not the capture: a CUDA graph never
outlives its process. Without a store nothing of this runs.

``mesh=`` takes a ``parallel.mesh.Mesh``: the engine then runs on the
mesh's device and asks its ``Partitioner`` for the bucket grain
(``validate_bucket``, ``validate_extent``, ``round_bucket`` for a
build-on-miss bucket), builds the model with ``mesh_model_config``, and
keys the store with the mesh's partition fingerprint, as the JAX engine
does (raft_tpu/serving/engine.py:444-456, :581). Without a mesh nothing of
this runs and the store keys say ``"single"``.

A mesh of more than one rank serves sharded buckets: every rank holds
an engine built the same way with the same mesh, runs its block of each
bucket (its rows of the ``data`` axis, its band of the ``spatial`` axis:
halo convs and the query-sharded volume, ``models.layers.set_spatial``)
and gathers every rank's block of the outputs, so every rank holds the
whole result, as JAX's single controller does. The ranks make the same
calls in one of two ways:

- the ``torchrun`` idiom: every rank calls ``infer_batch`` (and the rest)
  with the same whole inputs;
- follower ranks (``parallel.follow``): rank 0 leads (``follow.lead``),
  and runs the scheduler and its replica lanes; every other rank runs
  ``follow.follow(engine)``. Each call of rank 0's engines that issues
  collectives or changes what later ones see (a dispatch, a table entry
  built or dropped, a weight swap, a replica spawned, an engine closed)
  is announced on the channel under the engine's lock before it runs, a
  dispatch with each follower's block of the filled bucket, and the
  followers repeat it. A replica gets a sibling mesh (``Mesh.sibling``:
  the same layout over groups of its own), so two lanes' collectives
  never share a group. Once the channel fails (a follower died, or a
  sharded program's collective raised), every later call on a leading
  engine raises ``follow.ChannelDead`` at once.

Its programs run eagerly: gloo's host-side collectives cannot be
captured, and a capture under NCCL is not verified (ROADMAP.md §3,
"capture a multi-rank bucket under NCCL, and the store"), so
``captures`` stays 0, and the program store refuses a multi-rank mesh.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.config import ITERS_EXPORT, RAFTConfig
from raft_tpu_torch.evaluation.evaluate import resolve_device
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.models.layers import set_spatial
from raft_tpu_torch.ops.padding import pad_amounts
from raft_tpu_torch.parallel import follow as _follow
from raft_tpu_torch.parallel.halo import gather_blocks
from raft_tpu_torch.serving import aot as _aotmod
from raft_tpu_torch.serving.export import bind_program, export_bucket
from raft_tpu_torch.serving.trace import span as layer_span
from raft_tpu_torch.testing.faults import fault_point

#: the process's capture lock is taken before an engine's lock; a leading
#: engine announces each op on the follower channel under its own lock
#: (the channel's lock nests inside it: ``parallel/follow.py``), so the
#: engine's lock is not a leaf
LOCK_ORDER = (("engine._CAPTURE_LOCK", "engine.RAFTEngine._lock",
               "follow.Channel._lock"),)

# cvt2trt.sh:1 envelope (min 1x3x256x256 / opt 2x3x800x800 / max 8x3x1024x1024)
SHAPE_ENVELOPE_LINUX: List[Tuple[int, int, int]] = [
    (1, 256, 256), (2, 800, 800), (8, 1024, 1024)]
# cvt2trt.bat:1 envelope (max 1x3x512x1024)
SHAPE_ENVELOPE_WINDOWS: List[Tuple[int, int, int]] = [
    (1, 256, 256), (1, 512, 800), (1, 512, 1024)]

_KINDS = ("plain", "cached", "ragged")
#: the partition kind of each host input of a plain program
_INPUT_KINDS = {"image1": "frames", "image2": "frames",
                "flow_init": "flow_init"}

#: one capture at a time in the process: every engine's capture (a
#: replica's too) takes it, outside every engine lock, so no capture
#: overlaps another and each attributes only its own kernel launches
_CAPTURE_LOCK = threading.Lock()


class StaleFeatureError(RuntimeError):
    """A cached dispatch's feature rows were stamped with a weights
    version the engine has since moved past (a live weight swap raced the
    dispatch between cache assembly and the engine call). The batch fails
    before the program runs: features computed by one checkpoint must
    never feed a refinement running another. Streams recover by
    re-priming."""


def _handed(t: torch.Tensor) -> torch.Tensor:
    """A device output handed to the caller: its memory, allocated on the
    engine's stream, is not reused until the caller's stream is done."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


class PendingBatch:
    """One in-flight engine dispatch (``infer_batch_async``).

    The dispatch returns as soon as the bucket's program is queued on the
    engine's stream. ``fetch()`` waits for it and returns what
    ``infer_batch`` would: the flow (host numpy, cropped to the request),
    or ``(flow, flow_low)`` with ``return_low`` (``flow_low`` cropped to
    the ÷8-padded request, a device tensor with ``low_device``). A cached
    dispatch returns ``(flow, flow_low, fmap2, cnet2)``, the last three
    full-bucket device tensors. Two dispatches of one bucket may be in
    flight at once: each holds its own clone of the outputs.

    ``h2d_bytes``: host bytes shipped to the device (padded frames and any
    host-built ``flow_init``). ``t_synced``: monotonic time the outputs
    were known complete on the device, and ``t_ready``: the time they were
    handed over on the host, after the copies (both set by ``fetch``).
    ``span_ctx``: the request-trace spans of the batch, set by a tracing
    scheduler so its completion stage marks ``fetch_start`` on the pending
    it fetches.
    """

    __slots__ = ("bucket", "h2d_bytes", "t_synced", "t_ready", "span_ctx",
                 "_flow", "_flow_low", "_return_low", "_low_device",
                 "_cache", "_event")

    def __init__(self, flow, flow_low, bucket, h2d_bytes, return_low,
                 low_device, event, cache=None):
        self._flow = flow
        self._flow_low = flow_low
        self.bucket = bucket
        self.h2d_bytes = h2d_bytes
        self._return_low = return_low
        self._low_device = low_device
        self._event = event
        self._cache = cache
        self.t_synced: Optional[float] = None
        self.t_ready: Optional[float] = None
        self.span_ctx = None

    def fetch(self):
        """Wait for the device result and return it. One-shot."""
        if self._flow is None:
            raise RuntimeError("PendingBatch.fetch() already consumed")
        # chaos site: a hang here models a device whose compute (or D2H)
        # never completes
        fault_point("serve.fetch")
        with layer_span("engine.fetch_wait"):
            if self._event is not None:
                self._event.synchronize()
        self.t_synced = time.monotonic()
        with layer_span("engine.d2h"):
            flow = self._flow.cpu().numpy()
            if self._cache is not None:
                fmap2, cnet2 = self._cache
                out = (flow, _handed(self._flow_low), _handed(fmap2),
                       _handed(cnet2))
            elif self._return_low:
                low = (_handed(self._flow_low) if self._low_device
                       else self._flow_low.cpu().numpy())
                out = (flow, low)
            else:
                out = flow
        self._flow = self._flow_low = self._cache = None
        self.t_ready = time.monotonic()
        return out


class RaggedPendingBatch:
    """One in-flight ragged dispatch (``infer_ragged_async``): a
    mixed-shape micro-batch in one capacity class. Same contract as
    :class:`PendingBatch`, but ``fetch()`` returns a list of flows (and,
    with ``return_low``, a list of ``flow_low``), each cropped to its own
    request. ``real_px``/``padded_px``: request pixels against box
    pixels."""

    __slots__ = ("bucket", "h2d_bytes", "t_synced", "t_ready", "span_ctx",
                 "real_px", "padded_px", "_flows", "_lows", "_return_low",
                 "_low_device", "_event")

    def __init__(self, flows, lows, bucket, h2d_bytes, return_low,
                 low_device, event, real_px=0, padded_px=0):
        self._flows = flows
        self._lows = lows
        self.bucket = bucket
        self.h2d_bytes = h2d_bytes
        self._return_low = return_low
        self._low_device = low_device
        self._event = event
        self.real_px = real_px
        self.padded_px = padded_px
        self.t_synced: Optional[float] = None
        self.t_ready: Optional[float] = None
        self.span_ctx = None

    def fetch(self):
        """Wait for the device result; ``[flow_i]`` or ``([flow_i],
        [flow_low_i])`` with ``return_low``. One-shot."""
        if self._flows is None:
            raise RuntimeError("RaggedPendingBatch.fetch() already "
                               "consumed")
        fault_point("serve.fetch")
        with layer_span("engine.fetch_wait"):
            if self._event is not None:
                self._event.synchronize()
        self.t_synced = time.monotonic()
        with layer_span("engine.d2h"):
            out = [f.cpu().numpy() for f in self._flows]
            if self._return_low:
                lows = [_handed(lo) if self._low_device
                        else lo.cpu().numpy() for lo in self._lows]
                out = (out, lows)
        self._flows = self._lows = None
        self.t_ready = time.monotonic()
        return out


class _Program:
    """One bucket's serving program: static input buffers, the forward
    over them and, on the card, the CUDA graph that replays it into static
    outputs. ``launches``: each kernel's launches in one run (what the
    capture recorded into the graph)."""

    __slots__ = ("inputs", "fn", "graph", "outputs", "launches")

    def __init__(self, inputs, fn, graph=None, outputs=None, launches=None):
        self.inputs = inputs
        self.fn = fn
        self.graph = graph
        self.outputs = outputs
        self.launches = launches or {}

    def run(self):
        if self.graph is None:
            return self.fn(self.inputs)
        self.graph.replay()
        return self.outputs


def _state_dict(weights) -> Dict[str, torch.Tensor]:
    """A ``RAFT`` module's state dict, or the mapping of tensors given."""
    if isinstance(weights, torch.nn.Module):
        return weights.state_dict()
    if not isinstance(weights, Mapping):
        raise TypeError("weights: a RAFT module or a state dict of tensors")
    return {k: torch.as_tensor(v) for k, v in weights.items()}


class RAFTEngine:
    """Shape-bucketed engine over a RAFT checkpoint: one captured CUDA
    graph per bucket on the card, the eager forward on the CPU."""

    def __init__(self, weights, config: RAFTConfig = RAFTConfig(),
                 iters: int = ITERS_EXPORT,
                 envelope: Sequence[Tuple[int, int, int]] = (),
                 precompile: bool = True, mesh=None,
                 exact_shapes: bool = False, warm_start: bool = False,
                 wire: str = "f32", feature_cache: bool = False,
                 ragged: bool = False,
                 capacity_classes: Sequence[Tuple[int, int, int]] = (),
                 ragged_grain: int = 64, aot_cache=None,
                 device: str = "cuda"):
        """``weights``: a ``RAFT`` module or its state dict (the
        reference's key names), loaded with ``strict=True`` into the
        engine's own module on ``device``.

        ``envelope``: ``(B, H, W)`` buckets (H, W multiples of 8),
        captured now with ``precompile``, else at first use.

        ``exact_shapes``: never route to a spatially larger bucket; one
        program per exact ÷8-padded request shape (batch may still fill up
        to a same-spatial bucket). Spatial fill shifts the encoders'
        instance-norm statistics; this mode removes that.

        ``warm_start``: programs take a 1/8-resolution ``flow_init`` (a
        zero row is a cold start) and return ``(flow_low, flow_up)``.

        ``wire``: ``"f32"`` ships fp32 frames; ``"u8"`` ships uint8 frames
        (4x fewer bytes) and the program converts them on the card (exact,
        so integer frames give bitwise the f32 result).

        ``feature_cache`` (needs ``warm_start``): a second table of cached
        programs (``RAFT.forward_cached``) taking the new frame and
        device-resident ``(fmap1, cnet1, flow_init)`` rows, one encoder
        pass a pair.

        ``ragged``: a third table, one program per capacity class ``(B,
        Hcap, Wcap)`` (``capacity_classes``) serving any mix of request
        shapes that fits (``RAFT.forward_ragged``); a request outside
        every class rounds its box up to ``ragged_grain`` pixels.

        ``aot_cache``: the program store (a directory path or a
        :class:`~raft_tpu_torch.serving.aot.AOTCache`): each bucket's
        program is loaded from it on a hit, exported and stored on a
        miss, and captured either way; ``aot_stats()`` counts both.

        ``device``: the card unless ``"cpu"`` is asked for; on the CPU the
        programs run the eager forward.

        ``mesh``: a ``parallel.mesh.Mesh``; the engine runs on its device
        (``device`` is not read) under its ``Partitioner``. Over more than
        one rank every rank holds such an engine and gets the whole
        result; either every rank makes the same calls with the same whole
        inputs, or rank 0 leads and the others follow
        (``parallel.follow``). ``aot_cache`` then raises
        ``NotImplementedError``.
        """
        if wire not in ("f32", "u8"):
            raise ValueError(f"wire={wire!r}: choose 'f32' or 'u8'")
        if ragged and feature_cache:
            raise ValueError(
                "ragged=True with feature_cache=True is not supported "
                "yet: the cached signature keeps its per-shape bucket "
                "table. See ROADMAP 'Ragged serving, next bricks' (a) "
                "— the per-row descriptor subsuming the cached "
                "signature's bucket matrix is the next brick. Serve "
                "ragged one-shot traffic and cached video from two "
                "engines until it lands.")
        if feature_cache and not warm_start:
            raise ValueError("feature_cache=True needs warm_start=True "
                             "(the cached program carries the "
                             "flow_init/flow_low recurrence state)")
        if feature_cache and mesh is not None:
            raise ValueError("feature_cache is not supported under a "
                             "mesh yet — per-stream cache rows assume "
                             "single-device buckets")
        if ragged and mesh is not None:
            raise ValueError("ragged=True is not supported under a "
                             "mesh yet — capacity classes assume "
                             "single-device executables")
        if ragged and (ragged_grain <= 0 or ragged_grain % 8):
            raise ValueError(f"ragged_grain={ragged_grain}: must be a "
                             "positive multiple of 8 (capacity boxes "
                             "are ÷8-aligned)")
        if capacity_classes and not ragged:
            raise ValueError("capacity_classes given without "
                             "ragged=True — they would compile nothing")
        #: the sharding decisions of ``mesh`` (None without one)
        self.partitioner = None
        self._partition_fp = _aotmod.partition_fingerprint()
        if mesh is not None:
            from raft_tpu_torch.parallel.mesh import Mesh
            from raft_tpu_torch.parallel.partitioner import (
                Partitioner, mesh_model_config)

            if not isinstance(mesh, Mesh):
                raise TypeError("mesh: a raft_tpu_torch.parallel.mesh.Mesh")
            if mesh.size > 1 and aot_cache is not None:
                raise NotImplementedError(
                    f"aot_cache under a mesh of {mesh.size} ranks: a "
                    "multi-rank program is eager, neither traced nor "
                    "captured, so the store would have nothing to save; "
                    "ROADMAP.md §3 'capture a multi-rank bucket under "
                    "NCCL, and the store'")
            self.partitioner = Partitioner(mesh)
            self._partition_fp = _aotmod.partition_fingerprint(
                mesh, self.partitioner.declared_specs())
            config = mesh_model_config(config, mesh)
            device = str(mesh.device)
        self.config = config
        self.iters = iters
        self.exact_shapes = exact_shapes
        self.warm_start = warm_start
        self.wire = wire
        self.feature_cache = feature_cache
        self.ragged = ragged
        self.ragged_grain = int(ragged_grain)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        #: bumped on every update_weights (under the lock): cached rows are
        #: stamped with the version that produced their features
        self.weights_version = 0
        self._wire_np = np.uint8 if wire == "u8" else np.float32
        self._wire_torch = torch.uint8 if wire == "u8" else torch.float32
        #: guards the tables, the counters and the weight storage: a
        #: dispatch (copy in, run, clone out) and a weight swap are atoms
        self._lock = threading.RLock()
        #: the process's capture lock, taken before ``_lock`` (a leaf)
        self._capture_lock = _CAPTURE_LOCK
        self.model = RAFT(config)
        self.model.load_state_dict(_state_dict(weights), strict=True)
        self.model = self.model.to(dev).eval().requires_grad_(False)
        #: the mesh when it spans more than one rank: sharded eager
        #: programs, their outputs gathered (None otherwise)
        self._ranks = mesh if mesh is not None and mesh.size > 1 else None
        if self._ranks is not None:
            set_spatial(self.model, mesh.spatial_context())
        #: the follower channel this engine leads, and its id on it
        #: (``parallel.follow.lead``; None: it leads nothing)
        self._channel: Optional[_follow.Channel] = None
        self._eid: Optional[int] = None
        #: a leading engine that was closed (its followers' copies ended)
        self._closed = False
        #: dispatches run as a follower
        self._followed = 0
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            self._capture_stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
            self._used_by_replays(self.model.state_dict().values())
        #: programs built (graphs captured on the card, eager programs on
        #: the CPU), from the store or not
        self.capture_count = 0
        #: programs built by tracing the live module (every build without
        #: a store; a store's misses); ``compile_count`` is its alias
        self.compiles = 0
        #: the program store and its counters
        self._aot = _aotmod.as_cache(aot_cache)
        self.aot_hits = 0
        self.aot_misses = 0
        #: ``(table, bucket) -> {"load": s}`` on a store hit, ``{"export":
        #: s, "store": s}`` on a miss
        self.aot_seconds: Dict[tuple, Dict[str, float]] = {}
        if self._aot is not None:
            # a content fingerprint, not weights_version: a fresh process
            # re-derives the same key from the same checkpoint
            self._weights_fp = _aotmod.weights_fingerprint(self.model)
            self._config_fp = _aotmod.config_fingerprint(config, iters)
        #: ``(table, bucket) -> {"warmup": s, "capture": s}`` of each graph
        #: captured: the eager warm-up run and the capture itself
        self.capture_seconds: Dict[tuple, Dict[str, float]] = {}
        self._replayed: Dict[str, int] = {}
        self._tables: Dict[str, Dict[Tuple[int, int, int],
                                     Optional[_Program]]] = {
            k: {} for k in _KINDS}
        self._programs = self._tables["plain"]
        self._programs_cached = self._tables["cached"]
        self._programs_ragged = self._tables["ragged"]

        for shape in envelope:
            if precompile:
                self._get_program(shape)
                if feature_cache:
                    self._get_program(shape, "cached")
            else:
                self._programs.setdefault(shape, None)
        for cls in capacity_classes:
            b, ch, cw = cls
            if ch % 8 or cw % 8:
                raise ValueError(f"capacity class {cls}: Hcap/Wcap "
                                 "must be multiples of 8")
            if precompile:
                self._get_program((b, ch, cw), "ragged")
            else:
                self._programs_ragged.setdefault((b, ch, cw), None)

    @property
    def compile_count(self) -> int:
        """Programs built by tracing the live module (:attr:`compiles`),
        under the JAX engine's name: :attr:`capture_count` without a
        store."""
        return self.compiles

    # -- weights -------------------------------------------------------------

    def _check_weights(self, state: Mapping[str, torch.Tensor]) -> None:
        """Raise ``ValueError`` unless ``state`` has the engine's keys and
        each tensor's shape and dtype."""
        old = {k: (tuple(v.shape), v.dtype)
               for k, v in self.model.state_dict().items()}
        new = {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
        if old.keys() != new.keys():
            missing = sorted(old.keys() - new.keys())
            extra = sorted(new.keys() - old.keys())
            raise ValueError(
                "checkpoint structure mismatch: keys differ (missing "
                f"{missing[:3]}, unexpected {extra[:3]})")
        if old != new:
            diff = [f"{k}: {new[k]} vs engine's {old[k]}"
                    for k in old if old[k] != new[k]]
            raise ValueError(
                "checkpoint structure mismatch: " + "; ".join(diff[:5]))

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """The serving weights as a state dict: live views of the
        module's storage (the JAX engine's ``variables``). For a copy
        that a later swap cannot change, :meth:`weights_copy`."""
        return self.model.state_dict()

    def weights_copy(self) -> Dict[str, torch.Tensor]:
        """A copy of the serving weights, made on the caller's stream
        after everything queued on the engine's (every swap and replay
        before this call)."""
        with self._lock, torch.no_grad():
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).wait_stream(
                    self._stream)
            return {k: v.detach().clone()
                    for k, v in self.model.state_dict().items()}

    def compatible_weights(self, weights) -> bool:
        """True iff ``weights`` could be swapped in live with
        :meth:`update_weights` (same keys, shapes and dtypes)."""
        try:
            self._check_weights(_state_dict(weights))
        except ValueError:
            return False
        return True

    def update_weights(self, weights) -> None:
        """Swap checkpoints without invalidating a captured program.

        The new tensors are staged on the card outside the lock; under it
        they are copied into the module's own parameter and buffer storage
        on the engine's stream, where every captured graph reads them, and
        ``weights_version`` is bumped. A dispatch queued before the copy
        runs wholly on the old weights, one queued after wholly on the
        new."""
        state = _state_dict(weights)
        self._check_weights(state)
        staged = {k: v.detach().to(self.device) for k, v in state.items()}
        # outside the lock (it hashes every tensor): programs built after
        # the swap key to the new weights, so the old checkpoint's
        # entries are unreachable from here until it is swapped back
        new_fp = (_aotmod.weights_fingerprint(state)
                  if self._aot is not None else None)
        payload = (_follow.pack_state(state, self.model.state_dict())
                   if self._channel is not None else None)
        with self._lock:
            if payload is not None:
                self._announce(_follow.SWAP, payload.numel(),
                               payload=payload)
            with self._on_stream(), torch.no_grad():
                for k, t in self.model.state_dict().items():
                    src = staged[k]
                    t.copy_(src)
                    if src.is_cuda:
                        src.record_stream(self._stream)
            self.weights_version += 1
            if new_fp is not None:
                self._weights_fp = new_fp

    # -- programs ------------------------------------------------------------

    @contextlib.contextmanager
    def _on_stream(self):
        """The engine's stream, after the caller's stream's queued work (a
        device-resident input may come from it); nothing on the CPU."""
        if self.device.type != "cuda":
            yield
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            yield

    def _static_inputs(self, shape, kind: str) -> Dict[str, torch.Tensor]:
        b, h, w = shape
        if self._ranks is not None:     # this rank's block of the bucket
            b //= self._ranks.shape["data"]
            h //= self._ranks.shape["spatial"]
        dev = self.device

        def frames():
            return torch.zeros((b, h, w, 3), dtype=self._wire_torch,
                               device=dev)

        def low(c):
            return torch.zeros((b, h // 8, w // 8, c), dtype=torch.float32,
                               device=dev)

        if kind == "cached":
            return {"image2": frames(), "fmap1": low(self.config.fnet_dim),
                    "cnet1": low(self.config.cnet_dim), "flow_init": low(2)}
        inputs = {"image1": frames(), "image2": frames()}
        if kind == "ragged":
            inputs["valid_h8"] = torch.zeros(b, dtype=torch.int32, device=dev)
            inputs["valid_w8"] = torch.zeros(b, dtype=torch.int32, device=dev)
        if self.warm_start:
            inputs["flow_init"] = low(2)
        if dev.type == "cuda":
            self._used_by_replays(inputs.values())
        return inputs

    def _used_by_replays(self, tensors) -> None:
        """Mark device memory that the engine's replays read: when such a
        tensor is freed (a dropped bucket's static inputs, a dropped
        engine's weights), the caching allocator hands its memory out again
        only after the work queued on the engine's stream by then is done.
        Unmarked, memory allocated on another stream and freed while a
        replay may still read it is the allocating stream's to reuse at
        once (the caching allocator's rule; ``profile_graph_churn.py``
        drives drops and teardowns under replay). A captured graph and its
        pool need nothing: a graph destroyed while it runs is freed when it
        ends, and a pool's memory is released only by ``cudaFree``, which
        waits for the device."""
        for t in tensors:
            t.record_stream(self._stream)

    def _forward(self, kind: str) -> Callable[[Dict], tuple]:
        model, iters = self.model, self.iters
        if kind == "cached":
            return lambda x: model.forward_cached(
                x["image2"], x["fmap1"], x["cnet1"], x["flow_init"],
                iters=iters)
        if kind == "ragged":
            return lambda x: model.forward_ragged(
                x["image1"], x["image2"], x["valid_h8"], x["valid_w8"],
                x.get("flow_init"), iters=iters)
        if self._ranks is not None:
            return lambda x: self._gather(model(
                x["image1"], x["image2"], iters=iters,
                flow_init=x.get("flow_init"), test_mode=True))
        return lambda x: model(x["image1"], x["image2"], iters=iters,
                               flow_init=x.get("flow_init"), test_mode=True)

    def _gather(self, outputs):
        """Every rank's blocks of a sharded program's outputs, whole."""
        mesh = self._ranks
        grid = (mesh.shape["data"], mesh.shape["spatial"])
        return tuple(gather_blocks(t, grid, mesh.coords, mesh.world_group)
                     for t in outputs)

    def _build(self, shape, kind: str, inputs, fn) -> _Program:
        """A bucket's program over ``fn`` (the live forward, or an
        exported program bound to the live weights). On the card: one
        warm-up run on the capture stream (it builds the kernel library
        and the cuDNN and cuBLAS state, so nothing of that happens inside
        the capture), then the capture into the engine's shared pool."""
        if self.device.type != "cuda" or self._ranks is not None:
            return _Program(inputs, torch.no_grad()(fn))
        from raft_tpu_torch import kernels

        side = self._capture_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        with torch.no_grad(), torch.cuda.stream(side):
            fn(inputs)
        side.synchronize()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        with torch.no_grad(), torch.cuda.graph(
                graph, pool=self._pool, stream=side,
                capture_error_mode="thread_local"):
            outputs = fn(inputs)
        launches = {k: n - before[k]
                    for k, n in kernels.launch_counts().items()
                    if n != before[k]}
        with self._lock:
            self.capture_seconds[(kind, shape)] = {
                "warmup": t1 - t0, "capture": time.perf_counter() - t1}
        return _Program(inputs, fn, graph, outputs, launches)

    def _aot_key(self, shape: Tuple[int, int, int],
                 kind: str = "plain") -> Dict:
        """The store's key for one bucket's program: its full provenance,
        every component derivable by a fresh process holding the same
        checkpoint (``aot.REQUIRED_KEY_FIELDS``, and the TF32 flags)."""
        if kind == "ragged":
            program = ("serve_ragged_warm" if self.warm_start
                       else "serve_ragged")
        elif kind == "cached":
            program = "serve_cached"
        else:
            program = "serve_warm" if self.warm_start else "serve"
        with self._lock:
            weights_fp = self._weights_fp
        return {
            "format": _aotmod.AOT_FORMAT,
            "program": program,
            "weights": weights_fp,
            "geometry": [int(x) for x in shape],
            "wire": self.wire,
            "iters": int(self.iters),
            "config": self._config_fp,
            "donations": "none",
            "partition": self._partition_fp,
            **_aotmod.runtime_fields(self.device),
        }

    def _get_program(self, shape: Tuple[int, int, int],
                     kind: str = "plain") -> _Program:
        """The bucket's program, built on a miss outside the engine lock
        (the analog of the JAX engine's ``_get_executable``). With a
        store, a verified load comes first, outside every lock; a hit
        builds from the loaded program and traces nothing."""
        table = self._tables[kind]
        with self._lock:
            prog = table.get(shape)
        if prog is not None:
            return prog
        if self.partitioner is not None:
            self.partitioner.validate_extent(shape[1])
            self.partitioner.validate_bucket(shape)
        key = (self._aot_key(shape, kind) if self._aot is not None
               else None)
        loaded = None
        if key is not None:
            # load-not-trace: the store never raises and never returns a
            # wrong program; any mismatch or corruption falls through to
            # the trace below (the "aot.load" site drills it)
            t0 = time.perf_counter()
            program = self._aot.load(key)
            with self._lock:
                if program is None:
                    self.aot_misses += 1
                else:
                    self.aot_hits += 1
                    self.aot_seconds[(kind, shape)] = {
                        "load": time.perf_counter() - t0}
            if program is not None:
                loaded = bind_program(program, self.model)
        if loaded is None:
            # chaos site (builds that trace the live module): "raise"
            # models an uncapturable shape, "hang" a capture that never
            # returns. It fires outside every lock, as the JAX engine's
            # compile does: a thread the scheduler's watchdog quarantined
            # here holds nothing, so other shapes' captures and the
            # half-open probe's recapture go on
            fault_point("engine.compile")
        with self._capture_lock:
            with self._lock:
                prog = table.get(shape)
            if prog is not None:
                return prog
            with self._lock:
                if self._ranks is None:     # a sharded program is eager
                    self.capture_count += 1
                if loaded is None:
                    self.compiles += 1
            inputs = self._static_inputs(shape, kind)
            fn = self._forward(kind)
            if loaded is not None:
                fn = loaded
            elif key is not None:
                fn = self._export_and_store(shape, kind, key, inputs, fn)
            prog = self._build(shape, kind, inputs, fn)
            with self._lock:
                # a precompile=False placeholder (None) is filled
                cur = table.get(shape)
                if cur is None:
                    self._announce(_follow.ENSURE, _KINDS.index(kind),
                                   *shape, 1)
                    table[shape] = cur = prog
        return cur

    def _export_and_store(self, shape, kind: str, key: Dict, inputs,
                          fn) -> Callable:
        """A store miss: export the live forward at the bucket's shapes,
        store the program and return it bound to the live weights (the
        program a later hit would load). A program that will not export
        stores nothing, and the live forward is returned."""
        t0 = time.perf_counter()
        try:
            program = export_bucket(self.model, fn, inputs)
        except Exception:  # noqa: BLE001 — the store never gates a build
            return fn
        t1 = time.perf_counter()
        self._aot.store(key, program)
        with self._lock:
            self.aot_seconds[(kind, shape)] = {
                "export": t1 - t0, "store": time.perf_counter() - t1}
        return bind_program(program, self.model)

    def _dispatch(self, prog: _Program, host: Dict[str, np.ndarray],
                  keep: Callable[[tuple], tuple],
                  on_device: Optional[Callable[[Dict], None]] = None,
                  expect_version: Optional[int] = None,
                  op: Tuple[int, ...] = ()):
        """One dispatch atom under the lock: the host arrays into the
        program's static inputs (through pinned buffers on the card),
        ``on_device`` for device-resident inputs, the run, and ``keep``'s
        clones of the outputs; returns them and the event after them.
        A leading engine announces the dispatch first (``op``: the
        bucket and the request's crop), with each follower's block."""
        cuda = self.device.type == "cuda"
        blocks = None
        if self._ranks is not None:     # this rank's block of each input
            if self._channel is not None:
                blocks = self._rank_blocks(host)
            host = {k: self.partitioner.block(_INPUT_KINDS[k], a)
                    for k, a in host.items()}
        staged = {k: torch.from_numpy(np.ascontiguousarray(a))
                  for k, a in host.items()}
        if cuda:
            staged = {k: t.pin_memory() for k, t in staged.items()}
        with self._lock:
            if (expect_version is not None
                    and self.weights_version != expect_version):
                raise StaleFeatureError(
                    f"cache rows stamped weights_version="
                    f"{expect_version} but the engine is at "
                    f"{self.weights_version} — a weight swap raced "
                    "this dispatch; streams re-prime")
            if blocks is not None:
                self._announce(_follow.INFER, *op, blocks[0].numel(),
                               scatter=blocks)
            try:
                with self._on_stream(), torch.no_grad():
                    for k, t in staged.items():
                        prog.inputs[k].copy_(t, non_blocking=cuda)
                    if on_device is not None:
                        on_device(prog.inputs)
                    kept = keep(prog.run())
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(self._stream)
            except Exception as exc:
                if blocks is not None:
                    # a sharded program failed part way: the ranks are
                    # out of step for good
                    self._channel.fail(exc)
                raise
            for k, n in prog.launches.items():
                self._replayed[k] = self._replayed.get(k, 0) + n
        return kept, event

    def _rank_blocks(self, host: Dict[str, np.ndarray]) -> List[torch.Tensor]:
        """Each rank's block of the filled bucket's inputs, in rank order,
        packed as one uint8 tensor a rank (frames in the wire dtype, then
        ``flow_init``): a dispatch's payload on the follower channel."""
        from raft_tpu_torch.parallel.mesh import block

        mesh = self._ranks
        out = []
        for r in range(mesh.size):
            coords = divmod(r, mesh.shape["spatial"])
            out.append(torch.from_numpy(np.concatenate([
                np.ascontiguousarray(block(k, host[k], mesh, coords))
                .reshape(-1).view(np.uint8)
                for k in ("image1", "image2", "flow_init") if k in host])))
        return out

    def _device_tensor(self, t) -> torch.Tensor:
        """A caller's device-resident input on the engine's device, kept
        alive for the engine's stream."""
        t = torch.as_tensor(t).to(self.device, torch.float32)
        if t.is_cuda:
            t.record_stream(self._stream)
        return t

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches the engine's dispatches ran: per program, the
        launches its capture recorded, times its runs. (Replays do not
        move ``kernels.launch_counts``, which count Python calls of the
        wrappers: each capture adds its graph's launches once, and on the
        CPU, where the programs run eagerly, the plain versions count
        none.)"""
        with self._lock:
            return dict(self._replayed)

    def aot_stats(self) -> Dict[str, int]:
        """The program store's counters (the JAX engine's keys, and
        ``captures``): loads that verified (``aot_hits``, also
        ``compiles_avoided``), loads that missed, programs built by
        tracing the live module (``compiles``: every build without a
        store; a replica's builds count) and programs built in all."""
        with self._lock:
            return {"enabled": int(self._aot is not None),
                    "aot_hits": self.aot_hits,
                    "aot_misses": self.aot_misses,
                    "compiles": self.compiles,
                    "compiles_avoided": self.aot_hits,
                    "captures": self.capture_count}

    # -- replica fleet (parallel/placement.py) --------------------------------

    def spawn_replica(self) -> "RAFTEngine":
        """A sibling for the scheduler's replica fleet: the same config,
        iters, wire and mode flags, a copy of this engine's weights on
        the same device, this engine's program store, and its own capture
        of each program this engine has built (:meth:`adopt_executables`:
        with a store, each loaded from it, so the sibling traces nothing);
        placeholders are mirrored as placeholders. The sibling's tables are its own, so a wedge
        verdict's ``drop_bucket`` on one replica never touches
        another's graph, and its stream, pool and weight storage are its
        own, so its replays and swaps run beside this engine's.

        On a mesh of more than one rank the sibling runs on a sibling
        mesh (``Mesh.sibling``: the same layout over process groups of
        its own), made on every rank: each rank spawns in the ``torchrun``
        idiom, or a leading engine announces the spawn and its followers
        spawn their own (the new engine leads them too)."""
        eid = None
        try:
            with self._lock:
                if self._channel is not None:
                    new = self._channel.new_id()
                    self._announce(_follow.SPAWN, new)
                    eid = new
                weights = self.weights_copy()
            mesh = self._ranks.sibling() if self._ranks is not None else None
        except Exception as exc:
            if eid is not None:     # the followers wait in the new groups
                self._channel.fail(exc)
            raise
        rep = self._sibling(weights, mesh)
        if eid is not None:
            rep._lead(self._channel, eid)
        rep.adopt_executables(self)
        return rep

    def _sibling(self, weights, mesh) -> "RAFTEngine":
        """An empty engine like this one over ``weights`` (and ``mesh``,
        None: this engine's device alone)."""
        return RAFTEngine(
            weights, self.config, iters=self.iters,
            envelope=(), precompile=False, mesh=mesh,
            exact_shapes=self.exact_shapes, warm_start=self.warm_start,
            wire=self.wire, feature_cache=self.feature_cache,
            ragged=self.ragged, ragged_grain=self.ragged_grain,
            aot_cache=self._aot, device=str(self.device))

    def adopt_executables(self, source: "RAFTEngine") -> int:
        """Mirror ``source``'s table keys here and capture each program
        ``source`` has built on this engine (its own static buffers,
        pool and stream: a graph cannot be shared); ``source``'s
        placeholders stay placeholders. Returns how many programs were
        captured: one per built program of ``source`` this engine
        lacked, and no more. On a multi-rank mesh the programs are eager
        (nothing is captured): the same table of programs and
        placeholders, on every rank (a leading engine announces each
        entry)."""
        with source._lock:
            tables = {k: dict(t) for k, t in source._tables.items()}
        before = self.capture_count
        for kind in _KINDS:
            for shape, prog in sorted(tables[kind].items()):
                if prog is None:
                    with self._lock:
                        if shape not in self._tables[kind]:
                            self._announce(_follow.ENSURE,
                                           _KINDS.index(kind), *shape, 0)
                            self._tables[kind][shape] = None
                else:
                    self._get_program(shape, kind)
        return self.capture_count - before

    # -- follower ranks (parallel/follow.py) ---------------------------------

    @property
    def mesh(self):
        """The engine's ``parallel.mesh.Mesh`` (None without one)."""
        return None if self.partitioner is None else self.partitioner.mesh

    @property
    def channel(self) -> Optional["_follow.Channel"]:
        """The follower channel this engine leads (None: it leads none)."""
        return self._channel

    @property
    def leads(self) -> bool:
        """True when follower ranks repeat this engine's calls."""
        return self._channel is not None

    def _lead(self, channel: "_follow.Channel", eid: int) -> None:
        self._channel, self._eid = channel, eid

    def _alive(self) -> None:
        """Raise ``follow.ChannelDead`` on a leading engine whose channel
        failed or closed, or that was closed itself: without the lock."""
        if self._channel is None:
            return
        self._channel.alive()
        if self._closed:
            raise _follow.ChannelDead(f"engine {self._eid} was closed")

    def _announce(self, op: int, *args, scatter=None, payload=None) -> None:
        """On a leading engine, one op on the channel (the caller holds
        the lock); nothing otherwise."""
        if self._channel is None:
            return
        self._alive()
        self._channel.send(op, self._eid, args, scatter=scatter,
                           payload=payload)

    def _lock_leading(self) -> bool:
        """A leading engine's lock for a call the scheduler's dispatcher
        makes (a wedge verdict's drop, a lane's close): False at once
        when the channel is dead, and False after
        ``follow.LOCK_WAIT_S`` (failing the channel) when a lane holds
        the lock that long: it sits in a collective its peers left."""
        if self._channel.failed is not None or self._closed:
            return False
        if self._lock.acquire(timeout=_follow.LOCK_WAIT_S):
            return True
        self._channel.fail(TimeoutError(
            f"engine {self._eid}'s lock held past "
            f"{_follow.LOCK_WAIT_S} s: a collective whose peers left"))
        return False

    def close(self) -> None:
        """Retire a leading engine: its followers' copies end, and later
        calls on it raise ``follow.ChannelDead``. An engine that leads no
        followers is left as it is."""
        if self._channel is None or self._closed:
            return
        if self._lock_leading():
            try:
                self._announce(_follow.RETIRE)
            except _follow.ChannelDead:
                pass
            finally:
                self._lock.release()
        self._closed = True

    def tables(self) -> Dict[str, List[Tuple[Tuple[int, int, int], bool]]]:
        """Each table's buckets and whether each is built (False: a
        ``precompile=False`` placeholder)."""
        with self._lock:
            return {k: sorted((s, p is not None) for s, p in t.items())
                    for k, t in self._tables.items()}

    def follower_state(self) -> Dict:
        """What a follower reports of its copy of an engine at the end."""
        return {"tables": self.tables(),
                "weights_version": self.weights_version,
                "dispatches": self._followed}

    def _follow_infer(self, bucket, crop, packed: torch.Tensor) -> np.ndarray:
        """A follower's part of a dispatch: its block of the filled
        ``bucket`` (``packed``, as :meth:`_rank_blocks` cut it) through
        the program; returns the whole flow cropped as the primary
        crops it (``crop``: rows, height, width, top and left pad)."""
        prog = self._get_program(tuple(bucket))
        b, h, w, top, left = crop
        mesh = self._ranks
        bb = bucket[0] // mesh.shape["data"]
        bh = bucket[1] // mesh.shape["spatial"]
        bw = bucket[2]
        buf = packed.numpy()
        size = bb * bh * bw * 3 * np.dtype(self._wire_np).itemsize
        shapes = [("image1", self._wire_np, (bb, bh, bw, 3), size),
                  ("image2", self._wire_np, (bb, bh, bw, 3), size)]
        if self.warm_start:
            shapes.append(("flow_init", np.float32, (bb, bh // 8, bw // 8, 2),
                           bb * (bh // 8) * (bw // 8) * 2 * 4))
        host, off = {}, 0
        for name, dt, shape, n in shapes:
            host[name] = buf[off:off + n].copy().view(dt).reshape(shape)
            off += n
        with self._lock, self._on_stream(), torch.no_grad():
            for k, a in host.items():
                prog.inputs[k].copy_(torch.from_numpy(a))
            up = prog.run()[1]
            flow = up[:b, top:top + h, left:left + w].cpu().numpy()
            self._followed += 1
        return flow

    def _follow_ensure(self, kind: int, b: int, h: int, w: int,
                       built: int) -> None:
        shape, kind = (b, h, w), _KINDS[kind]
        if built:
            self._get_program(shape, kind)
        else:
            with self._lock:
                self._tables[kind].setdefault(shape, None)

    def _follow_drop(self, kind: int, b: int, h: int, w: int) -> None:
        self.drop_bucket((b, h, w), cached=kind == 1, ragged=kind == 2)

    def _follow_swap(self, payload: torch.Tensor) -> None:
        self.update_weights(_follow.unpack_state(payload,
                                                 self.model.state_dict()))

    # -- shape routing -------------------------------------------------------

    def bucket_shapes(self) -> List[Tuple[int, int, int]]:
        """Sorted bucket shapes this engine owns (built or
        ``precompile=False`` placeholders)."""
        with self._lock:
            return sorted(self._programs)

    def _select_bucket(self, b: int, h: int, w: int,
                       cached: bool = False
                       ) -> Optional[Tuple[int, int, int]]:
        table = self._programs_cached if cached else self._programs
        if self.exact_shapes:
            # exact spatially; batch fill is per-sample neutral
            fits = [s for s in table
                    if s[0] >= b and s[1] == h and s[2] == w]
            return min(fits, key=lambda s: s[0]) if fits else None
        fits = [s for s in table
                if s[0] >= b and s[1] >= h and s[2] >= w]
        if not fits:
            return None
        return min(fits, key=lambda s: s[0] * s[1] * s[2])

    def _route(self, b: int, hp: int, wp: int,
               cached: bool = False) -> Tuple[int, int, int]:
        """Bucket a ÷8-padded ``(b, hp, wp)`` request uses: the smallest
        fit, else the exact build-on-miss bucket."""
        with self._lock:
            bucket = self._select_bucket(b, hp, wp, cached=cached)
        if bucket is not None:
            return bucket
        if self.partitioner is not None:
            # whole examples and feature rows a shard: the zero fill and
            # the output crop absorb the rounding
            b, hp = self.partitioner.round_bucket(b, hp)
        return (b, hp, wp)

    def _padded(self, h: int, w: int) -> Tuple[int, int]:
        left, right, top, bottom = pad_amounts(h, w)
        return h + top + bottom, w + left + right

    def route_bucket(self, b: int, h: int, w: int,
                     cached: bool = False) -> Tuple[int, int, int]:
        """The bucket ``infer_batch`` would use for a raw ``(b, h, w)``
        request — builds nothing."""
        hp, wp = self._padded(h, w)
        return self._route(b, hp, wp, cached=cached)

    def bucket_capacity(self, h: int, w: int,
                        cached: bool = False) -> Optional[int]:
        """Largest batch a bucket can carry for an ``(h, w)`` request, or
        None when no bucket spatially fits."""
        hp, wp = self._padded(h, w)
        table = self._programs_cached if cached else self._programs
        with self._lock:
            if self.exact_shapes:
                fits = [s[0] for s in table if s[1] == hp and s[2] == wp]
            else:
                fits = [s[0] for s in table if s[1] >= hp and s[2] >= wp]
        return max(fits) if fits else None

    def drop_bucket(self, shape: Tuple[int, int, int],
                    cached: bool = False, ragged: bool = False) -> bool:
        """Forget one bucket's program (a wedge verdict indicts it); the
        next dispatch or ``ensure_bucket`` builds it again. True when it
        was present (placeholders count)."""
        kind = "ragged" if ragged else ("cached" if cached else "plain")
        missing = object()
        if self._channel is None:
            with self._lock:
                return self._tables[kind].pop(shape, missing) is not missing
        # a leading engine: announced, and never waiting on a lane that
        # sits in a collective (the caller is the scheduler's dispatcher)
        if not self._lock_leading():
            return False
        try:
            if shape not in self._tables[kind]:
                return False
            try:
                self._announce(_follow.DROP, _KINDS.index(kind), *shape)
            except _follow.ChannelDead:
                pass
            del self._tables[kind][shape]
            return True
        finally:
            self._lock.release()

    def ensure_bucket(self, batch: int, h: int, w: int,
                      cached: bool = False) -> Tuple[int, int, int]:
        """Build (if missing) and return the bucket that serves a
        ``(batch, h, w)`` request."""
        hp, wp = self._padded(h, w)
        bucket = self._route(batch, hp, wp, cached=cached)
        self._get_program(bucket, "cached" if cached else "plain")
        return bucket

    def executable_count(self) -> int:
        """Buckets across all three tables (built or ``precompile=False``
        placeholders), as the JAX engine counts them."""
        with self._lock:
            return sum(len(t) for t in self._tables.values())

    # -- ragged routing ------------------------------------------------------

    def ragged_classes(self) -> List[Tuple[int, int, int]]:
        """Sorted capacity classes this engine owns."""
        with self._lock:
            return sorted(self._programs_ragged)

    def _select_class(self, b: int, hp: int,
                      wp: int) -> Optional[Tuple[int, int, int]]:
        """Smallest capacity class fitting ``(b, hp, wp)`` (caller holds
        the lock)."""
        fits = [s for s in self._programs_ragged
                if s[0] >= b and s[1] >= hp and s[2] >= wp]
        if not fits:
            return None
        return min(fits, key=lambda s: s[0] * s[1] * s[2])

    def _route_ragged(self, b: int, hp: int,
                      wp: int) -> Tuple[int, int, int]:
        """Capacity class a ÷8-padded ``(b, hp, wp)`` dispatch uses: the
        smallest fitting class, else a declared class's box with a grown
        batch, else a ``ragged_grain``-rounded box."""
        with self._lock:
            cls = self._select_class(b, hp, wp)
            if cls is None:
                sp = [s for s in self._programs_ragged
                      if s[1] >= hp and s[2] >= wp]
                if sp:
                    s = min(sp, key=lambda s: s[1] * s[2])
                    cls = (b, s[1], s[2])
        if cls is None:
            g = self.ragged_grain
            cls = (b, -(-hp // g) * g, -(-wp // g) * g)
        return cls

    def ragged_class_for(self, h: int, w: int) -> Tuple[int, int]:
        """The ``(Hcap, Wcap)`` box a raw ``(h, w)`` request coalesces
        under. Builds nothing."""
        hp, wp = self._padded(h, w)
        with self._lock:
            sp = [s for s in self._programs_ragged
                  if s[1] >= hp and s[2] >= wp]
        if sp:
            s = min(sp, key=lambda s: (s[1] * s[2], s[0]))
            return s[1], s[2]
        g = self.ragged_grain
        return -(-hp // g) * g, -(-wp // g) * g

    def route_ragged(self, b: int, h: int, w: int) -> Tuple[int, int, int]:
        """The capacity class ``infer_ragged_async`` would use for ``b``
        rows whose padded extents fit ``(h, w)`` — builds nothing."""
        hp, wp = self._padded(h, w)
        return self._route_ragged(b, hp, wp)

    def ragged_capacity(self, h: int, w: int) -> Optional[int]:
        """Largest batch a class at the ``(h, w)`` request's box can
        carry, or None when no class spatially fits."""
        hp, wp = self._padded(h, w)
        with self._lock:
            fits = [s[0] for s in self._programs_ragged
                    if s[1] >= hp and s[2] >= wp]
        return max(fits) if fits else None

    def ensure_ragged(self, batch: int, h: int, w: int
                      ) -> Tuple[int, int, int]:
        """Build (if missing) and return the capacity class serving a
        ``(batch, h, w)`` box; no grain fallback."""
        hp, wp = self._padded(h, w)
        with self._lock:
            cls = self._select_class(batch, hp, wp)
        if cls is None:
            cls = (batch, hp, wp)
        self._get_program(cls, "ragged")
        return cls

    # -- inference -----------------------------------------------------------

    def _wire(self, a) -> np.ndarray:
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a if a.dtype == self._wire_np else a.astype(self._wire_np)

    def infer_batch_async(self, image1, image2, flow_init=None,
                          return_low: bool = False,
                          low_device: bool = False) -> PendingBatch:
        """Non-blocking dispatch: route, pad (in the wire dtype), ship and
        run the bucket's program; ``fetch()`` on the returned
        :class:`PendingBatch` waits for the result.

        ``flow_init`` (warm_start engines): a host array of shape ``(B,
        hp//8, wp//8, 2)``, embedded into the bucket on the host, or a
        tensor (that shape, or the full bucket's), embedded on the
        device. ``low_device=True`` leaves the returned ``flow_low`` on
        the device."""
        if (flow_init is not None or return_low) and not self.warm_start:
            raise ValueError(
                "flow_init/return_low need a warm_start=True engine — "
                "this engine compiled the single-output serving fn")
        self._alive()
        image1 = self._wire(image1)
        image2 = self._wire(image2)
        b, h, w, _ = image1.shape
        left, right, top, bottom = pad_amounts(h, w)
        hp, wp = h + top + bottom, w + left + right
        bucket = self._route(b, hp, wp)
        prog = self._get_program(bucket)
        bb, bh, bw = bucket
        # edge-pad to stride alignment (InputPadder), zero-fill the bucket
        align = ((0, 0), (top, bottom), (left, right), (0, 0))
        fill = ((0, bb - b), (0, bh - hp), (0, bw - wp), (0, 0))
        host = {"image1": np.pad(np.pad(image1, align, mode="edge"), fill),
                "image2": np.pad(np.pad(image2, align, mode="edge"), fill)}
        h2d = host["image1"].nbytes + host["image2"].nbytes
        on_device = None
        if self.warm_start:
            want = (b, hp // 8, wp // 8, 2)
            full = (bb, bh // 8, bw // 8, 2)
            if isinstance(flow_init, torch.Tensor) and self._ranks is not None:
                # the block is cut on the host: every rank holds the whole
                if tuple(flow_init.shape) == full:
                    flow_init = flow_init[:b, :hp // 8, :wp // 8]
                flow_init = flow_init.detach().cpu().numpy()
            if isinstance(flow_init, torch.Tensor):
                if tuple(flow_init.shape) not in (want, full):
                    raise ValueError(
                        f"flow_init shape {tuple(flow_init.shape)} != "
                        f"{want} (1/8 of the ÷8-padded request)")
                fi = flow_init

                def on_device(inputs):
                    t = self._device_tensor(fi)
                    if tuple(t.shape) == full:
                        inputs["flow_init"].copy_(t)
                    else:
                        inputs["flow_init"].zero_()
                        inputs["flow_init"][:b, :hp // 8, :wp // 8].copy_(t)
            else:
                finit = np.zeros(full, np.float32)
                if flow_init is not None:
                    fi = np.asarray(flow_init, np.float32)
                    if fi.shape != want:
                        raise ValueError(
                            f"flow_init shape {fi.shape} != {want} "
                            "(1/8 of the ÷8-padded request)")
                    finit[:b, :hp // 8, :wp // 8, :] = fi
                host["flow_init"] = finit
                h2d += finit.nbytes

        def keep(out):
            low, up = out
            return (up[:b, top:top + h, left:left + w].clone(),
                    low[:b, :hp // 8, :wp // 8].clone() if return_low
                    else None)

        (flow, low), event = self._dispatch(
            prog, host, keep, on_device,
            op=(*bucket, b, h, w, top, left))
        return PendingBatch(flow, low, bucket, h2d, return_low, low_device,
                            event)

    def infer_batch(self, image1, image2, flow_init=None,
                    return_low: bool = False):
        """(B,H,W,3) [0,255] -> (B,H,W,2) flow: ``infer_batch_async(...)
        .fetch()``. Routes to a bucket, padding up; builds an exact-shape
        program outside the envelope.

        Accuracy note: bucket fill beyond the ÷8 pad shifts the encoders'
        instance-norm statistics, which couple every output pixel to the
        fill; an envelope bucket per deployed shape (or ``exact_shapes``)
        avoids it."""
        return self.infer_batch_async(image1, image2, flow_init=flow_init,
                                      return_low=return_low).fetch()

    def infer_ragged_async(self, pairs, flow_inits=None,
                           return_low: bool = False,
                           low_device: bool = False,
                           box: Optional[Tuple[int, int]] = None
                           ) -> RaggedPendingBatch:
        """Non-blocking mixed-shape dispatch through one capacity class.

        ``pairs``: per-request ``(image1, image2)`` frames, each ``(h_i,
        w_i, 3)``. Each row is edge-padded to its own ÷8 alignment and
        zero-embedded in the class box; the per-row extents ride as static
        inputs of the class's program, so every mix replays one graph.
        ``flow_inits`` (warm_start): per-row ``(hp_i/8, wp_i/8, 2)`` (host
        array or tensor) or None. ``box``: the ``(Hcap, Wcap)`` the caller
        routed under. ``fetch()`` returns per-row flows cropped to each
        request."""
        if not self.ragged:
            raise ValueError("infer_ragged_async needs a ragged=True "
                             "engine")
        n = len(pairs)
        if n == 0:
            raise ValueError("empty ragged micro-batch")
        if (flow_inits is not None or return_low) and not self.warm_start:
            raise ValueError(
                "flow_inits/return_low need a warm_start=True engine")
        rows = []
        imgs = []
        for i1, i2 in pairs:
            i1 = self._wire(i1)
            i2 = self._wire(i2)
            if i1.ndim != 3 or i1.shape[-1] != 3:
                raise ValueError(f"ragged rows are (H, W, 3) frame "
                                 f"pairs, got {i1.shape}")
            if i1.shape != i2.shape:
                raise ValueError(f"frame shapes differ: {i1.shape} vs "
                                 f"{i2.shape}")
            h, w = i1.shape[:2]
            left, right, top, bottom = pad_amounts(h, w)
            rows.append((h, w, top, left, h + top + bottom,
                         w + left + right))
            imgs.append((i1, i2))
        hpmax = max(r[4] for r in rows)
        wpmax = max(r[5] for r in rows)
        if box is not None:
            if box[0] < hpmax or box[1] < wpmax:
                raise ValueError(
                    f"box {box} does not fit the batch's padded "
                    f"extents ({hpmax}, {wpmax})")
            bucket = self._route_ragged(n, box[0], box[1])
        else:
            bucket = self._route_ragged(n, hpmax, wpmax)
        bb, bh, bw = bucket
        prog = self._get_program(bucket, "ragged")
        i1b = np.zeros((bb, bh, bw, 3), self._wire_np)
        i2b = np.zeros_like(i1b)
        # 0 for batch-fill rows: the mask zeroes their features whole
        vh8 = np.zeros((bb,), np.int32)
        vw8 = np.zeros((bb,), np.int32)
        for i, ((h, w, top, left, hp, wp), (a, b2)) in enumerate(
                zip(rows, imgs)):
            align = ((top, hp - h - top), (left, wp - w - left), (0, 0))
            i1b[i, :hp, :wp] = np.pad(a, align, mode="edge")
            i2b[i, :hp, :wp] = np.pad(b2, align, mode="edge")
            vh8[i] = hp // 8
            vw8[i] = wp // 8
        host = {"image1": i1b, "image2": i2b, "valid_h8": vh8,
                "valid_w8": vw8}
        h2d = i1b.nbytes + i2b.nbytes + vh8.nbytes + vw8.nbytes
        on_device = None
        if self.warm_start:
            full = (bb, bh // 8, bw // 8, 2)
            finits = list(flow_inits) if flow_inits is not None else []
            if len(finits) > n:
                raise ValueError(f"{len(finits)} flow_inits for "
                                 f"{n} rows")
            for i, fi in enumerate(finits):
                if fi is None:
                    continue
                _, _, _, _, hp, wp = rows[i]
                want = (hp // 8, wp // 8, 2)
                if tuple(fi.shape) != want:
                    raise ValueError(
                        f"row {i} flow_init shape {tuple(fi.shape)} "
                        f"!= {want} (1/8 of the ÷8-padded request)")
            if any(isinstance(fi, torch.Tensor) for fi in finits):
                # embed on the device: device-resident rows never touch
                # the host; host rows mixed in still cross the wire
                h2d += sum(np.asarray(fi).nbytes for fi in finits
                           if fi is not None
                           and not isinstance(fi, torch.Tensor))

                def on_device(inputs):
                    inputs["flow_init"].zero_()
                    for i, fi in enumerate(finits):
                        if fi is not None:
                            _, _, _, _, hp, wp = rows[i]
                            inputs["flow_init"][i, :hp // 8, :wp // 8] \
                                .copy_(self._device_tensor(fi))
            else:
                finit = np.zeros(full, np.float32)
                for i, fi in enumerate(finits):
                    if fi is not None:
                        _, _, _, _, hp, wp = rows[i]
                        finit[i, :hp // 8, :wp // 8, :] = np.asarray(
                            fi, np.float32)
                host["flow_init"] = finit
                h2d += finit.nbytes

        def keep(out):
            low, up = out
            flows = [up[i, top:top + h, left:left + w].clone()
                     for i, (h, w, top, left, _, _) in enumerate(rows)]
            lows = ([low[i, :hp // 8, :wp // 8].clone()
                     for i, (_, _, _, _, hp, wp) in enumerate(rows)]
                    if return_low else None)
            return flows, lows

        (flows, lows), event = self._dispatch(prog, host, keep, on_device)
        return RaggedPendingBatch(
            flows, lows, bucket, h2d, return_low, low_device, event,
            real_px=sum(h * w for (h, w, _, _, _, _) in rows),
            padded_px=bb * bh * bw)

    def infer_ragged(self, pairs, flow_inits=None,
                     return_low: bool = False):
        """Synchronous form: ``infer_ragged_async(...).fetch()``."""
        return self.infer_ragged_async(
            pairs, flow_inits=flow_inits, return_low=return_low).fetch()

    def infer_cached_async(self, image2, slots,
                           expect_version: Optional[int] = None
                           ) -> PendingBatch:
        """Cross-frame cached dispatch: one encoder pass (the new frames)
        and the recurrence; each pair's first-frame features arrive as
        device-resident cache rows instead of pixels.

        ``image2``: (B, h, w, 3), each stream's new frame (the only frame
        that ships). ``slots``: length-B list; entry i is None for a
        cold/prime row (zeroed cache inputs: its flow is meaningless, its
        cache outputs prime the stream) or a ``(fmap1, cnet1, flow_init)``
        triple of tensors at the request's 1/8 ÷8-padded geometry
        (``flow_init`` may be None: warm features, cold recurrence).

        ``expect_version``: the ``weights_version`` the rows were stamped
        with; if the engine moved past it, :class:`StaleFeatureError`
        before the program runs (the check and the run are one atom).

        ``fetch()`` returns ``(flow, flow_low_full, fmap2, cnet2)``; the
        last three are full-bucket device tensors."""
        if not self.feature_cache:
            raise ValueError("infer_cached_async needs a "
                             "feature_cache=True engine")
        image2 = self._wire(image2)
        b, h, w, _ = image2.shape
        if len(slots) != b:
            raise ValueError(f"{len(slots)} cache slots for batch {b}")
        left, right, top, bottom = pad_amounts(h, w)
        hp, wp = h + top + bottom, w + left + right
        lh, lw = hp // 8, wp // 8
        dims = (self.config.fnet_dim, self.config.cnet_dim, 2)
        for i, s in enumerate(slots):
            if s is None:
                continue
            for t, c in zip(s, dims):
                if t is not None and tuple(t.shape) != (lh, lw, c):
                    raise ValueError(
                        f"slot {i}: cache row shape {tuple(t.shape)} != "
                        f"{(lh, lw, c)} (1/8 of the ÷8-padded request)")
        bucket = self._route(b, hp, wp, cached=True)
        prog = self._get_program(bucket, "cached")
        bb, bh, bw = bucket
        align = ((0, 0), (top, bottom), (left, right), (0, 0))
        fill = ((0, bb - b), (0, bh - hp), (0, bw - wp), (0, 0))
        host = {"image2": np.pad(np.pad(image2, align, mode="edge"), fill)}
        h2d = host["image2"].nbytes

        def on_device(inputs):
            # zero rows are the prime/cold form, so one assembly serves
            # every warmth mix
            names = ("fmap1", "cnet1", "flow_init")
            for name in names:
                inputs[name].zero_()
            for i, s in enumerate(slots):
                if s is None:
                    continue
                for name, t in zip(names, s):
                    if t is not None:
                        inputs[name][i, :lh, :lw].copy_(
                            self._device_tensor(t))

        def keep(out):
            low, up, fmap2, cnet2 = out
            return (up[:b, top:top + h, left:left + w].clone(), low.clone(),
                    fmap2.clone(), cnet2.clone())

        (flow, low, fmap2, cnet2), event = self._dispatch(
            prog, host, keep, on_device, expect_version=expect_version)
        return PendingBatch(flow, low, bucket, h2d, False, True, event,
                            cache=(fmap2, cnet2))

    def infer_cached(self, image2, slots,
                     expect_version: Optional[int] = None):
        """Synchronous form: ``infer_cached_async(...).fetch()``."""
        return self.infer_cached_async(
            image2, slots, expect_version=expect_version).fetch()

    def infer(self, images: Sequence[np.ndarray], batch_size: int = 4,
              time_it: bool = False) -> List[np.ndarray]:
        """Sliding-window flow over a frame sequence (raft_trt.py:41-67):
        consecutive pairs, chunked into batches. The last chunk batch-fills
        into the bucket the full chunks use, so one program serves the
        whole sequence."""
        flows: List[np.ndarray] = []
        n = len(images) - 1
        t0 = time.perf_counter()
        for i in range(0, n, batch_size):
            i1 = np.stack(images[i:min(i + batch_size, n)])
            i2 = np.stack(images[i + 1:min(i + batch_size, n) + 1])
            flows.extend(self.infer_batch(i1, i2))
        if time_it:
            dt = time.perf_counter() - t0
            print(f"{n} pairs in {dt:.3f}s ({n / max(dt, 1e-9):.2f} pairs/s)")
        return flows
