"""Multi-model serving registry: versioned engines, canary rollout; port
of ``raft_tpu/serving/registry.py``.

The serving stack below this module is single-model: one ``RAFTEngine``
(one arch, one set of weights), one ``MicroBatchScheduler`` (one queue,
one breaker board, one metrics block). The paper family itself ships two
architectures (RAFT basic + RAFT small — "Rethinking RAFT" makes the
case for serving a cheap variant as a fast tier next to the accurate
one), and a front end for multi-tenant traffic must route, roll out, and
roll back *models* — without a restart and without one model's failure
touching another's traffic.

:class:`ModelRegistry` is that layer. Each named model family owns
**variants** — an arch config + weight version backed by its OWN
``RAFTEngine`` (its own bucket graphs) and its OWN
``MicroBatchScheduler`` (its own queue, breakers keyed ``model/HxW``,
metrics namespaced by model into one shared metrics.jsonl). Variant
lifecycle::

    loading -> canary -> live -> draining -> retired

- ``add_model(name, weights, config)`` builds and goes straight live.
- ``deploy(name, weights, canary_fraction=f)`` builds a canary variant
  next to the live one; a **deterministic request-hash fraction** of
  that model's traffic (sha256 of the route token — stable across
  processes and replicas, no RNG) serves from the canary while the
  rest stays on the untouched live engine. A deploy that fails to
  build (bad weights, an uncapturable arch, the ``registry.load`` fault
  site) auto-rolls-back: the partial variant is discarded, live
  traffic never saw it, and the error surfaces as
  :class:`DeployError`.
- ``promote(name)`` makes the canary the live version atomically:
  same-arch canaries land as a ``RAFTEngine.update_weights`` swap into
  the live engine (copied into the storage every captured graph reads:
  nothing is captured again); a new arch swaps the whole variant
  (engine + scheduler) under the registry lock, then drains the old
  one. Either way the drained scheduler settles every accepted future —
  zero stranded.
- ``rollback(name)`` stops canary routing first, then drains the
  canary with the same zero-stranded guarantee.

``submit(..., model=..., priority=...)`` routes one request: pick the
model family, hash the route token against the canary fraction, and
hand the frame pair to that variant's scheduler — where the priority
classes (``interactive`` / ``batch``: shed-batch-first backpressure,
weighted dequeue) apply per model. A request racing a rollback/promote
into a just-drained canary scheduler re-routes to live instead of
failing — the rollout machinery is invisible to callers.

Engine-direct and single-scheduler deployments never pay for any of
this: the registry is a composition layer — with no registry
constructed, no code path below changes.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional

from raft_tpu_torch.config import ITERS_EXPORT, RAFTConfig
from raft_tpu_torch.serving.engine import RAFTEngine
from raft_tpu_torch.serving.guardian import AdmissionBudget
from raft_tpu_torch.serving.metrics import ServingMetrics
from raft_tpu_torch.serving.scheduler import (BackpressureError,
                                              MicroBatchScheduler,
                                              SchedulerClosed)
from raft_tpu_torch.serving.trace import TraceLedger
from raft_tpu_torch.testing.faults import fault_point

#: lock order: the registry lock is the OUTERMOST serving lock — where it
#: is held into a variant's scheduler at all, the direction is registry ->
#: scheduler, never the reverse (drains, closes and health walks all
#: release the registry lock first; a scheduler thread never calls back
#: into a locked registry).
LOCK_ORDER = (
    ("registry.ModelRegistry._lock",
     "scheduler.MicroBatchScheduler._cv"),
)

#: variant lifecycle states (strings on purpose: they go straight into
#: health() JSON and metrics.jsonl events)
MODEL_LOADING = "loading"
MODEL_CANARY = "canary"
MODEL_LIVE = "live"
MODEL_DRAINING = "draining"
MODEL_RETIRED = "retired"


class UnknownModel(KeyError):
    """``submit``/``deploy``/... named a model the registry doesn't
    hold (or omitted ``model=`` with more than one registered)."""


class DeployError(RuntimeError):
    """A canary deploy failed to build (bad weights, an uncapturable
    arch, an injected ``registry.load`` fault). The partial variant was
    discarded — live traffic never routed to it — and no canary is left
    behind; fix the artifact and deploy again."""


class RolloutInProgress(RuntimeError):
    """``deploy`` while the model already has a canary: one rollout at
    a time per model — promote or roll back the current one first."""


def _executables(engine) -> int:
    """An engine's programs (every table; a duck-typed engine's
    ``_compiled``)."""
    count = getattr(engine, "executable_count", None)
    return count() if count is not None else len(engine._compiled)


def canary_hash_fraction(model: str, token) -> float:
    """Deterministic routing hash in [0, 1): a request routes to the
    model's canary iff this is < the deploy's ``canary_fraction``.
    sha256 over ``model:token`` — stable across processes, replicas,
    restarts and both packages (no RNG, no state), so the SAME request
    key always lands on the same side of the split and a sticky token
    (a session id) pins a whole stream to one variant."""
    digest = hashlib.sha256(f"{model}:{token}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2.0 ** 64


class _Variant:
    """One deployed weight version: engine + scheduler + lifecycle."""

    __slots__ = ("engine", "scheduler", "version", "state", "config",
                 "same_arch", "final_snapshot")

    def __init__(self, engine, scheduler: MicroBatchScheduler,
                 version: str, config: RAFTConfig, state: str,
                 same_arch: bool = False):
        self.engine = engine
        self.scheduler = scheduler
        self.version = version
        self.config = config
        self.state = state
        #: canary only: True when the live engine can absorb these
        #: weights via update_weights (promote reuses its graphs)
        self.same_arch = same_arch
        #: metrics snapshot frozen at retire time, so per-model
        #: accounting stays auditable after the scheduler is gone
        self.final_snapshot: Optional[Dict] = None


class _Model:
    """One named model family: the live variant, at most one canary,
    and the retired history."""

    __slots__ = ("name", "live", "canary", "canary_fraction", "counter",
                 "deploys", "retired")

    def __init__(self, name: str, live: _Variant):
        self.name = name
        self.live = live
        self.canary: Optional[_Variant] = None
        self.canary_fraction = 0.0
        self.counter = 0      # default route-token source
        self.deploys = 1      # version auto-numbering
        self.retired: List[_Variant] = []


class ModelRegistry:
    """Named model variants over the scheduler/engine stack.

    ``metrics_path``: one shared metrics.jsonl — every variant's
    snapshots and events land there stamped with its model namespace,
    plus the registry's own rollout events (``model_deploy`` /
    ``model_promote`` / ``model_rollback`` / ``model_state``).

    ``scheduler_defaults``: kwargs applied to every variant's
    ``MicroBatchScheduler`` (per-model overrides via ``add_model``).

    ``admission_budget``: registry-wide overload control — a shared
    :class:`~raft_tpu_torch.serving.guardian.AdmissionBudget` of this
    many tokens gates ``submit()`` across ALL models before the
    per-variant queues (one token per admitted request, released when
    its future settles). Exhaustion fails fast with
    ``BackpressureError``, counted per model as ``admission_rejected``;
    the last ``admission_interactive_reserve`` tokens (default
    capacity/4) are interactive-only, so one model's batch flood cannot
    monopolize the aggregate queue capacity another model's interactive
    traffic needs. None (default) = no gate.

    ``device``: where the engines the registry builds run — the card
    unless ``"cpu"`` is asked for (a prebuilt ``engine=`` keeps its
    own).
    """

    #: duck-type marker (VideoSession and other layers route on it
    #: without importing this module)
    is_registry = True

    def __init__(self, *, metrics_path: Optional[str] = None,
                 admission_budget: Optional[int] = None,
                 admission_interactive_reserve: Optional[int] = None,
                 trace_path: Optional[str] = None,
                 trace_sample: float = 1.0,
                 device: str = "cuda",
                 **scheduler_defaults):
        """``trace_path`` arms request-scoped tracing registry-wide:
        ONE shared :class:`~raft_tpu_torch.serving.trace.TraceLedger`
        writes every variant's spans to one ``spans.jsonl`` (ids unique
        across models), every variant scheduler gets it as its
        ``tracer``, and ``submit``/``submit_cached`` stamp each span
        with the routing decision (model, variant version, canary
        assignment) the scheduler below can't see. ``trace_sample``
        is the ledger's keep fraction (tail exemplars and failures
        are always kept). Default None: no ledger."""
        self._lock = threading.RLock()
        self._models: Dict[str, _Model] = {}
        self._metrics_path = metrics_path
        self._sched_defaults = scheduler_defaults
        self.device = device
        self._events = ServingMetrics(metrics_path, namespace="registry")
        self._budget = (AdmissionBudget(admission_budget,
                                        admission_interactive_reserve)
                        if admission_budget else None)
        #: shared request-tracing ledger (None = tracing off); public
        #: so sessions chain parents through the registry duck-typed,
        #: like they do off a plain scheduler
        self.tracer = (TraceLedger(trace_path,
                                   sample_rate=trace_sample)
                       if trace_path is not None else None)
        self._closed = False

    @property
    def metrics_path(self) -> Optional[str]:
        """The shared metrics.jsonl destination (None = not writing) —
        the surface attendant layers (the SLO guardian) append their
        own events to."""
        return self._metrics_path

    def admission_snapshot(self) -> Optional[Dict]:
        """The shared admission budget's state (None when no budget is
        configured): capacity, reserve, in-use tokens, per-class
        admitted/rejected counts."""
        return (self._budget.snapshot() if self._budget is not None
                else None)

    # -- internals ---------------------------------------------------------

    def _model(self, name: Optional[str]) -> _Model:
        with self._lock:
            if name is None:
                if len(self._models) != 1:
                    raise UnknownModel(
                        "model= is required with "
                        f"{len(self._models)} models registered")
                return next(iter(self._models.values()))
            m = self._models.get(name)
            if m is None:
                raise UnknownModel(
                    f"unknown model {name!r} (registered: "
                    f"{sorted(self._models)})")
            return m

    def _set_state(self, name: str, variant: _Variant, new: str) -> None:
        old, variant.state = variant.state, new
        self._events.record_event("model_state", model=name,
                                  version=variant.version,
                                  state=new, previous=old)

    def _build_variant(self, name: str, variables, config: RAFTConfig,
                       version: str, *, iters: int, envelope,
                       engine_kw: Dict, sched_kw: Dict,
                       engine: Optional[RAFTEngine],
                       same_arch: bool = False) -> _Variant:
        """Build one variant's engine + scheduler (state ``loading``).
        The ``registry.load`` fault site fires before the build — the
        chaos harness's stand-in for a bad checkpoint read, an
        uncapturable arch, an out-of-memory weight upload."""
        fault_point("registry.load")
        if engine is None:
            engine = RAFTEngine(variables, config, iters=iters,
                                envelope=envelope, precompile=True,
                                device=self.device, **engine_kw)
        ns = f"{name}@{version}"
        metrics = ServingMetrics(self._metrics_path, namespace=ns)
        merged = {**self._sched_defaults, **sched_kw}
        if self.tracer is not None:
            # every variant shares the registry's ledger: one
            # spans.jsonl, registry-unique trace ids, rollout-proof
            # session chains
            merged.setdefault("tracer", self.tracer)
        if getattr(engine, "feature_cache", False):
            # a feature-cache engine gets a feature-cache scheduler:
            # the per-variant pool is what the rollout brooms flush
            merged.setdefault("feature_cache", True)
        sched = MicroBatchScheduler(
            engine, metrics=metrics, namespace=ns, **merged)
        return _Variant(engine, sched, version, config, MODEL_LOADING,
                        same_arch=same_arch)

    def _drain(self, name: str, variant: _Variant) -> None:
        """draining -> retired: settle every accepted future (zero
        stranded — ``close(drain=True)`` is the guarantee), freeze the
        final metrics snapshot for the per-model accounting audit."""
        self._set_state(name, variant, MODEL_DRAINING)
        variant.scheduler.close(drain=True)
        variant.final_snapshot = variant.scheduler.metrics.snapshot(
            executables=_executables(variant.engine))
        self._set_state(name, variant, MODEL_RETIRED)
        self._retire_artifacts(name, variant)

    def _retire_artifacts(self, name: str, variant: _Variant) -> None:
        """Program-store hygiene for a retired variant: evict its
        programs from the store UNLESS a surviving variant (any model's
        live or canary) still serves the same weights fingerprint — a
        rolled-back canary's programs go, the live engine's stay, and a
        re-deploy of shared weights keeps its warm path. Best-effort: a
        failed eviction never fails the rollout that triggered it."""
        aot = getattr(variant.engine, "_aot", None)
        fp = getattr(variant.engine, "_weights_fp", None)
        if aot is None or fp is None or not hasattr(aot, "evict"):
            return
        with self._lock:
            survivors = {
                getattr(v.engine, "_weights_fp", None)
                for m in self._models.values()
                for v in (m.live, m.canary) if v is not None
                and v is not variant}
        if fp in survivors:
            return
        try:
            gone = aot.evict(weights=fp)
        except Exception:  # noqa: BLE001 — GC must not fail a rollout
            return
        if gone.get("removed"):
            self._events.record_event(
                "aot_evicted", model=name, version=variant.version,
                removed=gone["removed"],
                removed_bytes=gone["removed_bytes"])

    # -- lifecycle ---------------------------------------------------------

    def add_model(self, name: str, variables,
                  config: Optional[RAFTConfig] = None, *,
                  iters: int = ITERS_EXPORT, envelope=(),
                  version: str = "v1",
                  engine: Optional[RAFTEngine] = None,
                  warm_start: bool = False, wire: str = "f32",
                  exact_shapes: bool = False,
                  feature_cache: bool = False,
                  artifact_dir: Optional[str] = None,
                  **sched_kw) -> None:
        """Register a model family; the first version goes straight
        live (``loading -> live``). ``engine=`` injects a prebuilt
        engine (drills share captures across rounds); otherwise one is
        built from ``variables`` (a ``RAFT`` module or its state dict)
        and ``config``, its buckets captured over ``envelope``.
        ``artifact_dir=`` points the engine at a program store
        (serving/aot.py): an engine started against a warm store loads
        its envelope's programs instead of tracing them, and a retired
        variant's programs are evicted from it. Extra kwargs reach the
        variant's scheduler."""
        with self._lock:
            if self._closed:
                raise SchedulerClosed("registry is closed")
            if name in self._models:
                raise ValueError(
                    f"model {name!r} already registered — new weights "
                    "roll out via deploy(), not a second add_model()")
        variant = self._build_variant(
            name, variables, config or RAFTConfig(), version,
            iters=iters, envelope=envelope,
            engine_kw=dict(warm_start=warm_start, wire=wire,
                           exact_shapes=exact_shapes,
                           feature_cache=feature_cache,
                           aot_cache=artifact_dir),
            sched_kw=sched_kw, engine=engine)
        with self._lock:
            # re-checked at publish: the build ran outside the lock
            # (captures take seconds), and a racing duplicate
            # add_model or close() must not orphan a running
            # scheduler or overwrite a published variant
            conflict = ("registry is closed" if self._closed
                        else f"model {name!r} already registered"
                        if name in self._models else None)
            if conflict is None:
                self._models[name] = _Model(name, variant)
        if conflict is not None:
            variant.scheduler.close(drain=False)
            if self._closed:
                raise SchedulerClosed(conflict)
            raise ValueError(conflict + " — new weights roll out via "
                                        "deploy(), not a second "
                                        "add_model()")
        self._set_state(name, variant, MODEL_LIVE)

    def deploy(self, name: str, variables,
               config: Optional[RAFTConfig] = None, *,
               canary_fraction: float = 0.25,
               version: Optional[str] = None,
               iters: Optional[int] = None, envelope=None,
               engine: Optional[RAFTEngine] = None,
               artifact_dir: Optional[str] = None,
               **sched_kw) -> str:
        """Roll out new weights (same arch) or a new arch for
        ``name`` as a canary serving ``canary_fraction`` of the
        model's traffic. Returns the canary's version string.

        The canary gets its OWN engine (even same-arch: its buckets
        are captured at deploy time, so a broken artifact fails HERE —
        with auto-rollback — never under live traffic) defaulting to
        the live engine's bucket envelope and wire/warm-start recipe.
        ``promote()`` then reuses the live graphs for a same-arch
        canary via ``update_weights``. ``artifact_dir=`` threads a
        program store (serving/aot.py) into the canary engine: a
        restarting supervisor re-deploying known weights loads the
        canary envelope instead of tracing it (keys are content
        addressed, so genuinely NEW weights still trace, and store their
        programs for the replicas that follow)."""
        if not 0.0 < canary_fraction <= 1.0:
            raise ValueError(
                f"canary_fraction={canary_fraction}: must be in (0, 1]")
        m = self._model(name)
        with self._lock:
            if self._closed:
                raise SchedulerClosed("registry is closed")
            if m.canary is not None:
                raise RolloutInProgress(
                    f"model {name!r} already has canary "
                    f"{m.canary.version!r} at "
                    f"{m.canary_fraction:.0%} — promote() or "
                    "rollback() first")
            live = m.live
            m.deploys += 1
            version = version or f"v{m.deploys}"
        cfg = config if config is not None else live.config
        # same-arch probe (getattr: drills run duck-typed engines that
        # can't judge weights — those promote as engine swaps)
        compat = getattr(live.engine, "compatible_weights", None)
        same_arch = (cfg == live.config and compat is not None
                     and compat(variables))
        shapes = getattr(live.engine, "bucket_shapes",
                         lambda: sorted(live.engine._compiled))
        # fleet-proportional canary: when the live variant runs N
        # replica lanes, the canary defaults to its traffic share of
        # the fleet (fraction * N, floor 1) — a 25% canary over a
        # 4-lane live gets 1 lane, not 4 idle engines' worth of
        # captures. Explicit replicas= in sched_kw wins.
        live_fleet = len(getattr(live.scheduler, "_lanes", ()) or ())
        if live_fleet > 1:
            sched_kw.setdefault(
                "replicas",
                max(1, round(canary_fraction * live_fleet)))
        try:
            variant = self._build_variant(
                name, variables, cfg, version,
                iters=(iters if iters is not None
                       else getattr(live.engine, "iters", ITERS_EXPORT)),
                envelope=(envelope if envelope is not None else shapes()),
                engine_kw=dict(
                    warm_start=getattr(live.engine, "warm_start", False),
                    wire=getattr(live.engine, "wire", "f32"),
                    exact_shapes=getattr(live.engine, "exact_shapes",
                                         False),
                    feature_cache=getattr(live.engine, "feature_cache",
                                          False),
                    aot_cache=artifact_dir),
                sched_kw=sched_kw, engine=engine, same_arch=same_arch)
        except Exception as exc:
            # auto-rollback: nothing was routed, nothing is left. The
            # failed build never touched the live variant — its
            # engine, scheduler and traffic are exactly as before.
            self._events.record_event(
                "model_deploy_failed", model=name, version=version,
                error=f"{type(exc).__name__}: {exc}")
            raise DeployError(
                f"canary deploy {name!r} {version!r} failed to build "
                "(auto-rolled-back; live traffic untouched): "
                f"{exc}") from exc
        with self._lock:
            # publish atomically (fraction + variant appear together),
            # re-checking the one-rollout/open invariants: the build
            # ran outside the lock, and a racing deploy or close()
            # must not let this variant overwrite a published canary
            # (orphaning its dispatcher thread) or land after drain
            conflict = ("registry is closed" if self._closed
                        else f"model {name!r} already has canary "
                             f"{m.canary.version!r}"
                        if m.canary is not None else None)
            if conflict is None:
                m.canary = variant
                m.canary_fraction = float(canary_fraction)
        if conflict is not None:
            variant.scheduler.close(drain=False)
            if self._closed:
                raise SchedulerClosed(conflict)
            raise RolloutInProgress(
                conflict + " — promote() or rollback() first")
        self._set_state(name, variant, MODEL_CANARY)
        self._events.record_event(
            "model_deploy", model=name, version=version,
            canary_fraction=float(canary_fraction),
            same_arch=same_arch)
        return version

    def promote(self, name: Optional[str] = None) -> Dict:
        """Make the canary the live version. Same-arch: the live
        engine absorbs the canary's weights via ``update_weights`` —
        every captured graph is reused (nothing is captured) and the
        canary's duplicate engine retires. New arch: the canary
        variant (engine + scheduler) BECOMES live under the registry
        lock and the old live drains. Both paths stop canary routing
        before any drain, so zero futures strand and no request ever
        routes into a closing scheduler (a racer that does is
        re-routed to live by ``submit``)."""
        m = self._model(name)
        with self._lock:
            canary = m.canary
            if canary is None:
                raise RolloutInProgress(
                    f"model {m.name!r} has no canary to promote")
            # routing off FIRST: from here every submit sees live only
            m.canary = None
            m.canary_fraction = 0.0
            live = m.live
        if canary.same_arch:
            # weight swap through the live SCHEDULER: stream-ordered
            # after in-flight dispatches, graphs reused — and when the
            # live variant runs a replica fleet, swap_weights applies
            # the new weights to every lane under one quiesced epoch
            # (all-or-nothing: a lane that fails mid-swap rolls the
            # already-swapped lanes back, so the fleet is never
            # half-rolled)
            swap = getattr(live.scheduler, "swap_weights", None)
            if swap is not None:
                swap(canary.engine.variables)
            else:
                live.engine.update_weights(canary.engine.variables)
            # feature-cache broom: every slot in the live pool was
            # computed by the OLD weights — stale canary-era features
            # must never feed the promoted model (streams re-prime;
            # the engine's weights-version stamp backstops the racing
            # in-flight window)
            flush = getattr(live.scheduler, "flush_feature_cache", None)
            if flush is not None:
                flush("promote", model=m.name, version=canary.version)
            live.version = canary.version
            self._drain(m.name, canary)
            m.retired.append(canary)
            mode = "weights_swap"
        else:
            with self._lock:
                m.live = canary
            self._set_state(m.name, canary, MODEL_LIVE)
            self._drain(m.name, live)
            m.retired.append(live)
            mode = "engine_swap"
        self._events.record_event("model_promote", model=m.name,
                                  version=canary.version, mode=mode)
        return {"model": m.name, "version": canary.version, "mode": mode}

    def rollback(self, name: Optional[str] = None) -> Dict:
        """Abort the rollout: stop canary routing (live takes 100%
        again), then drain the canary — every future it accepted
        settles (zero stranded), racing submits re-route to live."""
        m = self._model(name)
        with self._lock:
            canary = m.canary
            if canary is None:
                raise RolloutInProgress(
                    f"model {m.name!r} has no canary to roll back")
            m.canary = None
            m.canary_fraction = 0.0
        # the canary's pool dies with it, but flush explicitly (and
        # stamped) BEFORE the drain: its slots hold canary-weight
        # features no surviving variant may ever correlate against,
        # and the cache_flush event is the rollback drill's evidence
        flush = getattr(canary.scheduler, "flush_feature_cache", None)
        if flush is not None:
            flush("rollback", model=m.name, version=canary.version)
        self._drain(m.name, canary)
        m.retired.append(canary)
        self._events.record_event("model_rollback", model=m.name,
                                  version=canary.version)
        return {"model": m.name, "version": canary.version}

    # -- traffic -----------------------------------------------------------

    def routes_to_canary(self, name: str, token) -> bool:
        """Would a request carrying ``token`` serve from ``name``'s
        canary right now? (The test/ops predicate for the
        deterministic split — pure function of token + fraction.)"""
        m = self._model(name)
        with self._lock:
            if m.canary is None:
                return False
            frac = m.canary_fraction
        return canary_hash_fraction(m.name, token) < frac

    def _routed_variant(self, m: _Model, route_key) -> _Variant:
        """The variant a ``route_key`` request routes to right now —
        the single read-only form of the canary-hash decision
        (``variant_version`` and ``invalidate_stream`` share it; the
        submit path's ``_route_and_admit`` fuses the same expression
        with its counter-bump atom)."""
        with self._lock:
            canary = m.canary
            if (canary is not None and route_key is not None
                    and canary_hash_fraction(m.name, route_key)
                    < m.canary_fraction):
                return canary
            return m.live

    def variant_version(self, name: Optional[str] = None,
                        route_key=None) -> str:
        """Version string of the variant a ``route_key`` request would
        serve from right now. Recurrence holders (``VideoSession``)
        poll this before each warm submit and cold-restart when it
        changes: a rollout event (deploy/promote/rollback) must never
        let warm-start state produced by one variant feed another
        model's refinement."""
        return self._routed_variant(self._model(name),
                                    route_key).version

    def submit(self, image1, image2, *, model: Optional[str] = None,
               priority: Optional[str] = None, route_key=None, **kw):
        """Route one frame pair to ``model``'s live or canary variant
        and enqueue it there; returns the scheduler Future.

        ``route_key`` is the canary-routing token — pass a session or
        user id for sticky assignment (one stream, one variant);
        default is a per-model submit counter (each request hashes
        independently, converging on the deploy's fraction).
        ``priority`` is the scheduler's class knob, applied per model.
        Remaining kwargs are the scheduler's (deadline_s, flow_init,
        want_low, low_device)."""
        return self._route_and_admit(
            model, priority, route_key,
            lambda sched: sched.submit(image1, image2,
                                       priority=priority, **kw))

    def submit_cached(self, frame, *, model: Optional[str] = None,
                      priority: Optional[str] = None, route_key=None,
                      **kw):
        """Feature-cache form of :meth:`submit`: route ONE frame of a
        video stream to ``model``'s live or canary variant and enqueue
        it on that variant's ``MicroBatchScheduler.submit_cached``
        (``stream``/``seq``/``prime`` ride in ``kw``). Same
        deterministic canary hash, same admission budget, same
        re-route-on-drain contract — a re-routed stream's next pair
        misses on the new variant's pool and cleanly re-primes (the
        session's cold-restart path)."""
        return self._route_and_admit(
            model, priority, route_key,
            lambda sched: sched.submit_cached(frame,
                                              priority=priority,
                                              **kw))

    def invalidate_stream(self, stream, *, model: Optional[str] = None,
                          route_key=None) -> bool:
        """End-of-stream hygiene for feature-cache sessions: drop the
        stream's slot from the variant its ``route_key`` currently
        routes to (if a rollout moved the stream since it last served,
        the old variant's pool was flushed or retired with it)."""
        target = self._routed_variant(self._model(model), route_key)
        inv = getattr(target.scheduler, "invalidate_stream", None)
        return inv(stream) if inv is not None else False

    def _route_and_admit(self, model: Optional[str],
                         priority: Optional[str], route_key, call):
        """The shared intake skeleton behind ``submit`` and
        ``submit_cached``: pick the variant (deterministic canary
        hash over the route token), pass the registry-wide admission
        gate, run ``call`` against the chosen scheduler with the
        re-route-on-drain guard, and tie the admission token to the
        future's settlement."""
        m = self._model(model)
        with self._lock:
            if self._closed:
                raise SchedulerClosed("registry is closed")
            canary = m.canary
            if route_key is None:
                route_key = m.counter
                m.counter += 1
            to_canary = (canary is not None
                         and canary_hash_fraction(m.name, route_key)
                         < m.canary_fraction)
            target = canary if to_canary else m.live
        if self._budget is not None \
                and not self._budget.try_acquire(priority):
            # registry-wide admission gate, BEFORE the per-variant
            # queue: the whole registry is over budget — shed here so
            # one model's flood can't convert another model's queue
            # headroom into its own backlog
            target.scheduler.metrics.record_admission_rejected(priority)
            raise BackpressureError(
                f"registry admission budget exhausted "
                f"({self._budget.capacity} requests in flight across "
                "models) — shedding new work; retry with backoff")
        try:
            fut = self._submit_variant(m, target, call)
        except BaseException:
            if self._budget is not None:
                self._budget.release()   # nothing was admitted
            raise
        if self._budget is not None:
            fut.add_done_callback(lambda _f: self._budget.release())
        return fut

    def _trace_stamp(self, m: _Model, target: _Variant) -> None:
        """Stamp the routing decision onto the span the next submit on
        THIS thread mints (trace.py's thread-local intake context) —
        the model/variant/canary assignment only the registry knows."""
        if self.tracer is not None:
            self.tracer.stamp_intake(
                model=m.name, variant=target.version,
                canary=target.state == MODEL_CANARY)

    def _submit_variant(self, m: _Model, target: _Variant, call):
        try:
            self._trace_stamp(m, target)
            try:
                return call(target.scheduler)
            except SchedulerClosed:
                # raced a promote/rollback into a draining variant (the
                # canary, or the old live of a new-arch promote): the
                # rollout machinery must be invisible — re-route to the
                # CURRENT live. If the registry itself is closing, the
                # live scheduler is closed too and the error propagates.
                with self._lock:
                    live = m.live
                if live is target:
                    raise
                self._trace_stamp(m, live)
                return call(live.scheduler)
        finally:
            if self.tracer is not None:
                # a rejected submit must not leak its stamp into an
                # unrelated later span on this thread
                self.tracer.clear_intake()

    def update_weights(self, variables, model: Optional[str] = None
                       ) -> None:
        """Direct live weight swap (the single-model API, per model) —
        for rollouts WITH a bake period use deploy()/promote(). Routed
        through the variant's scheduler so an armed feature cache
        flushes with the swap."""
        m = self._model(model)
        live = m.live
        live.scheduler.update_weights(variables)

    # -- observability -----------------------------------------------------

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def health(self) -> Dict:
        """Per-model operator surface: live + canary variant health
        (each is the scheduler's full health block), rollout state."""
        with self._lock:
            items = [(m.name, m.live, m.canary, m.canary_fraction)
                     for m in self._models.values()]
        out = {}
        for name, live, canary, frac in sorted(items,
                                               key=lambda i: i[0]):
            out[name] = {
                "live": {"version": live.version, "state": live.state,
                         "health": live.scheduler.health()},
                "canary": None if canary is None else {
                    "version": canary.version, "state": canary.state,
                    "fraction": frac,
                    "health": canary.scheduler.health()},
            }
        return out

    def snapshot(self) -> Dict:
        """Per-model metrics: every variant's full serving snapshot
        (live + canary + retired finals) plus the per-model accounting
        identity ``submitted == completed + failed + deadline_missed +
        cancelled`` summed across the model's variants — one rollout
        must never lose a request."""
        with self._lock:
            items = [(m.name, m.live, m.canary, list(m.retired))
                     for m in self._models.values()]
        out = {}
        for name, live, canary, retired in sorted(items,
                                                  key=lambda i: i[0]):
            snaps = [live.scheduler.metrics.snapshot(
                executables=_executables(live.engine))]
            if canary is not None:
                snaps.append(canary.scheduler.metrics.snapshot(
                    executables=_executables(canary.engine)))
            snaps += [v.final_snapshot for v in retired
                      if v.final_snapshot is not None]
            totals = {k: sum(s.get(k, 0) for s in snaps)
                      for k in ("submitted", "completed", "failed",
                                "shed", "evicted", "admission_rejected",
                                "deadline_missed", "cancelled")}
            out[name] = {
                "live": snaps[0],
                "canary": (snaps[1] if canary is not None else None),
                "retired": [v.final_snapshot for v in retired
                            if v.final_snapshot is not None],
                "totals": totals,
                "accounting_ok": totals["submitted"] == (
                    totals["completed"] + totals["failed"]
                    + totals["deadline_missed"] + totals["cancelled"]),
            }
        return out

    def write_metrics(self) -> Dict:
        """Append every active variant's snapshot line to the shared
        metrics.jsonl (model-stamped); returns the registry snapshot."""
        with self._lock:
            variants = [v for m in self._models.values()
                        for v in (m.live, m.canary) if v is not None]
        if self._metrics_path:
            for v in variants:
                v.scheduler.write_metrics()
        return self.snapshot()

    # -- shutdown ----------------------------------------------------------

    def close(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Close every variant's scheduler (canaries first — their
        racers re-route to a live scheduler that is still open).
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            models = list(self._models.values())
        for m in models:
            with self._lock:
                canary, m.canary = m.canary, None
                m.canary_fraction = 0.0
            if canary is not None:
                canary.scheduler.close(drain=drain, timeout=timeout)
                canary.final_snapshot = canary.scheduler.metrics.snapshot(
                    executables=_executables(canary.engine))
                self._set_state(m.name, canary, MODEL_RETIRED)
                m.retired.append(canary)
        for m in models:
            m.live.scheduler.close(drain=drain, timeout=timeout)
        self._events.record_event("registry_closed",
                                  models=[m.name for m in models])

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)
