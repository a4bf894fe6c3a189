"""The metrics.jsonl / spans.jsonl record schemas, in ONE place; port
of ``raft_tpu/serving/schema.py`` (the wire-protocol table of the
multi-host transport waits for it, ROADMAP M11c).

Every serving layer appends to the same observability files — metrics
snapshots (``kind: "serving"``), supervisor-style events
(``kind: "serving_event"``: breaker transitions, wedge verdicts,
rollout moves, guardian decisions, cache flushes) and, with tracing
armed, span records (``kind: "span"``). Before this module each test
re-declared its slice of the schema inline (the breaker-event keys in
test_scheduler, the rollout events in test_registry, the guardian
evidence in test_guardian, ...) — a field rename could pass every
local test and still break the dashboards tailing the file. This
registry is the single source of truth the schema tests check every
emitted record against, and the reference a dashboard author reads.

Import-cheap (the CLI readers use it too). The contract is
**additive**: a field may be added to a record (new keys are never a
validation error), but the required fields here may only grow.
"""

from __future__ import annotations

from typing import Dict, List

#: accounting classes a request span may close under — trace.py owns
#: the tuple (import-cheap); re-exported so schema
#: consumers need only this module and the two can never drift
from raft_tpu_torch.serving.trace import SPAN_CLASSES  # noqa: F401

#: every jsonl record carries its kind (snapshots use the trainer
#: Logger contract: a "step" key; events/spans a "time" stamp)
RECORD_KINDS = ("serving", "serving_event", "span")

#: required top-level keys of a metrics SNAPSHOT record
#: (ServingMetrics.snapshot) — "model" and the tracing/feature-cache
#: blocks are conditional (namespace set / pool armed / tracing armed)
SNAPSHOT_KEYS = frozenset({
    "step", "kind", "submitted", "completed", "failed", "shed",
    "evicted", "admission_rejected", "deadline_missed", "cancelled",
    "abandoned_inflight", "dispatches", "executables", "resilience",
    "queue_depth", "occupancy", "padding_waste", "ragged", "hot_path",
    "latency", "priority", "hist_bounds_ms", "buckets",
})

#: serving_event kinds → REQUIRED extra fields (beyond the base
#: {"event", "time", "kind"}; "model" is stamped whenever the emitting
#: metrics block carries a namespace). One entry per record_event call
#: site in the serving stack — a new event kind lands HERE first.
EVENT_FIELDS: Dict[str, frozenset] = {
    # scheduler / resilience (serving/metrics.py emitters)
    "serving_state": frozenset({"state", "previous", "reason"}),
    "dispatch_wedged": frozenset({"bucket", "failed", "timeout_s"}),
    "thread_quarantined": frozenset({"bucket", "alive"}),
    "breaker_open": frozenset({"bucket", "previous"}),
    "breaker_half_open": frozenset({"bucket", "previous"}),
    "breaker_closed": frozenset({"bucket", "previous"}),
    # feature cache (scheduler.flush_feature_cache; the registry's
    # rollout brooms stamp model/version on top)
    "cache_flush": frozenset({"reason", "slots"}),
    # registry rollout lifecycle (serving/registry.py)
    "model_state": frozenset({"model", "version", "state", "previous"}),
    "model_deploy": frozenset({"model", "version", "canary_fraction",
                               "same_arch"}),
    "model_deploy_failed": frozenset({"model", "version", "error"}),
    "model_promote": frozenset({"model", "version", "mode"}),
    "model_rollback": frozenset({"model", "version"}),
    "registry_closed": frozenset({"models"}),
    # AOT-store GC on variant retirement (registry._retire_artifacts)
    "aot_evicted": frozenset({"model", "version", "removed",
                              "removed_bytes"}),
    # replica fleet (scheduler fleet mode — replicas>1 or host lanes)
    "replica_quarantined": frozenset({"replica", "bucket"}),
    "replica_activated": frozenset({"replica", "queue_depth"}),
    "replica_retired": frozenset({"replica", "idle_s"}),
    "replica_grow_failed": frozenset({"error"}),
    "fleet_weights_swap": frozenset({"replicas"}),
    # multi-host fleet (serving/hosts.py + scheduler._wedge_host)
    "host_suspect": frozenset({"host", "missed"}),
    "host_dead": frozenset({"host", "missed"}),
    "host_rejoined": frozenset({"host", "push_entries", "push_bytes",
                                "push_retries", "compiles"}),
    "failover": frozenset({"host", "replica", "requeued"}),
    # SLO guardian (serving/guardian.py)
    "guardian_bake_start": frozenset({"model", "version",
                                      "bake_window_s"}),
    "guardian_promote": frozenset({"model", "version", "reason",
                                   "evidence"}),
    "guardian_rollback": frozenset({"model", "version", "reason",
                                    "evidence"}),
    "guardian_decision_failed": frozenset({"model", "version",
                                           "intended", "error"}),
    "guardian_error": frozenset({"error"}),
}

#: span record types (serving/trace.py) → required fields. Request
#: spans additionally carry "class" (the accounting-identity class
#: they reconcile against) and "phases"; dispatch spans the fan-in
#: link surface.
SPAN_KINDS = ("request", "dispatch")
SPAN_FIELDS: Dict[str, frozenset] = {
    "request": frozenset({"trace_id", "time", "outcome", "class",
                          "total_ms", "tail", "bucket", "phases"}),
    "dispatch": frozenset({"trace_id", "time", "outcome", "total_ms",
                           "bucket", "fan_in", "capacity",
                           "padding_waste", "requests"}),
}

def validate_record(rec: Dict) -> List[str]:
    """Validate ONE parsed jsonl record against the registry; returns
    the list of problems (empty = conforming). Unknown kinds and
    unknown event names are errors — every emitter must be declared;
    extra fields are not (the additive contract)."""
    problems: List[str] = []
    kind = rec.get("kind")
    if kind == "serving":
        missing = SNAPSHOT_KEYS - rec.keys()
        if missing:
            problems.append(f"snapshot missing {sorted(missing)}")
        if not isinstance(rec.get("step"), int):
            problems.append("snapshot step must be an int")
    elif kind == "serving_event":
        event = rec.get("event")
        if "time" not in rec:
            problems.append("event missing time")
        required = EVENT_FIELDS.get(event)
        if required is None:
            problems.append(f"undeclared event kind {event!r} — add "
                            "it to serving/schema.py EVENT_FIELDS")
        else:
            missing = required - rec.keys()
            if missing:
                problems.append(
                    f"event {event!r} missing {sorted(missing)}")
    elif kind == "span":
        span = rec.get("span")
        required = SPAN_FIELDS.get(span)
        if required is None:
            problems.append(f"unknown span type {span!r}")
        else:
            missing = required - rec.keys()
            if missing:
                problems.append(
                    f"span {span!r} missing {sorted(missing)}")
            if span == "request" \
                    and rec.get("class") not in SPAN_CLASSES:
                problems.append(
                    f"span class {rec.get('class')!r} not in "
                    f"{SPAN_CLASSES}")
    else:
        problems.append(f"unknown record kind {kind!r}")
    return problems


def validate_lines(lines) -> List[str]:
    """Validate an iterable of parsed records; problems are prefixed
    with their line index."""
    problems = []
    for i, rec in enumerate(lines):
        problems += [f"line {i}: {p}" for p in validate_record(rec)]
    return problems
