"""The layer spans of ``raft_tpu_torch.serving.trace`` on the CPU.

Unarmed (no ``torch.profiler`` session), a train step and a scheduler run
over a CPU engine record nothing. Armed by a CPU profiler session, the
train step records ``train.step`` and its five phases, nested on one
thread, and computes bitwise what the unarmed step computes; the scheduler
at ``pipeline_depth=2`` records one ship, fetch wait, D2H copy and settle
per dispatch, the dispatcher's spans and the completion stage's on
threads of their own, and one ``sched.request`` per completed request. No
marker kernel is launched for a CPU device, and a second profiler session
starts a cleared record. The dispatch gap counts from the previous
outputs' completion on the device (``t_synced``), before their copies.
"""

from __future__ import annotations

import copy
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.serving import trace
from raft_tpu_torch.serving.engine import PendingBatch, RAFTEngine
from raft_tpu_torch.serving.scheduler import MicroBatchScheduler
from raft_tpu_torch.training.train_step import (create_train_state,
                                                make_train_step)

SMALL = RAFTConfig(small=True)
TRAIN = TrainConfig(stage="chairs", batch_size=1, image_size=(32, 48),
                    iters=1, num_steps=10, lr=1e-4)
PHASES = ("train.inputs", "train.forward", "train.loss", "train.backward",
          "train.optimizer")
REQUESTS = 6
WAIT = 120.0


def armed():
    return profile(activities=[ProfilerActivity.CPU])


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    h, w = TRAIN.image_size
    return {"image1": rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32),
            "flow": rng.uniform(-2, 2, (1, h, w, 2)).astype(np.float32),
            "valid": np.ones((1, h, w), np.float32)}


def _state():
    model = RAFT(SMALL, torch.Generator().manual_seed(0))
    return create_train_state(model, TRAIN)


def _frames(k):
    rng = np.random.RandomState(k)
    return (rng.uniform(0, 255, (32, 32, 3)).astype(np.float32),
            rng.uniform(0, 255, (32, 32, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def engine():
    weights = RAFT(SMALL, torch.Generator().manual_seed(0)).state_dict()
    return RAFTEngine(weights, SMALL, iters=1,
                      envelope=[(1, 32, 32), (2, 32, 32)], device="cpu")


def _serve(engine):
    """Six requests through a depth-2 scheduler; its metrics snapshot."""
    sched = MicroBatchScheduler(engine, max_batch=2, gather_window_s=0.0,
                                pipeline_depth=2)
    futs = [sched.submit(*_frames(k)) for k in range(REQUESTS)]
    for f in futs:
        assert f.result(timeout=WAIT).flow.shape == (32, 32, 2)
    sched.close(drain=True)
    return sched.metrics.snapshot()


def _names(recs):
    return [r.name for r in recs]


def test_unarmed_records_nothing(engine):
    before = trace.records()
    step = make_train_step(SMALL, TRAIN)
    step(_state(), _batch())
    snap = _serve(engine)
    assert snap["completed"] == REQUESTS
    assert trace.records() == before


def test_train_step_spans_nest_and_leave_outputs_bitwise():
    plain, traced = _state(), _state()
    traced.model.load_state_dict(copy.deepcopy(plain.model.state_dict()))
    step = make_train_step(SMALL, TRAIN)
    batch = _batch()
    want = step(plain, batch)
    with armed():
        got = step(traced, batch)
    recs = trace.records()
    assert _names(recs).count("train.step") == 1
    (outer,) = [r for r in recs if r.name == "train.step"]
    kids = [r for r in recs if r.parent == "train.step"]
    assert [r.name for r in sorted(kids, key=lambda r: r.start_ns)] == list(
        PHASES)
    for r in kids:
        assert r.thread == outer.thread
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    for a, b in zip(sorted(kids, key=lambda r: r.start_ns), sorted(
            kids, key=lambda r: r.start_ns)[1:]):
        assert a.end_ns <= b.start_ns
    assert outer.parent is None
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for (name, p), q in zip(plain.model.named_parameters(),
                            traced.model.parameters()):
        assert torch.equal(p, q), name
    assert trace.markers() == []          # a CPU device gets no marker


def test_scheduler_spans_per_dispatch_and_request(engine):
    with armed():
        snap = _serve(engine)
    recs = trace.records()
    dispatches = snap["dispatches"]
    assert dispatches >= REQUESTS // 2
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    for name in ("sched.ship", "engine.fetch_wait", "engine.d2h",
                 "sched.settle", "sched.assemble", "sched.gather"):
        assert len(by[name]) == dispatches, name
    assert len(by["sched.request"]) == snap["completed"] == REQUESTS
    dispatcher = {r.thread for n in ("sched.gather", "sched.assemble",
                                     "sched.ship") for r in by[n]}
    completion = {r.thread for n in ("engine.fetch_wait", "engine.d2h",
                                     "sched.settle") for r in by[n]}
    assert len(dispatcher) == 1 and len(completion) == 1
    assert dispatcher != completion
    for r in by["sched.request"]:
        taken = r.marks["taken"]
        assert r.start_ns <= taken <= r.end_ns
        assert r.parent == "sched.settle"
    assert trace.markers() == []


def test_second_session_starts_cleared():
    with armed():
        with trace.span("first"):
            pass
    assert _names(trace.records()) == ["first"]
    with armed():
        with trace.span("second"):
            pass
    assert _names(trace.records()) == ["second"]
    with armed():
        with trace.span("third"):
            pass
    with trace.span("unarmed"):        # ends the stretch as a read does
        pass
    with armed():
        with trace.span("fourth"):
            pass
    assert _names(trace.records()) == ["fourth"]


def test_records_are_bounded_and_count_what_they_drop():
    rec = trace.SpanRecorder(limit=3)
    with armed():
        for _ in range(5):
            with rec.span("s"):
                pass
    assert len(rec.records()) == 3 and rec.dropped == 2


def test_fetch_stamps_synced_before_ready():
    out = torch.zeros(1, 8, 8, 2)
    pending = PendingBatch(out, None, (1, 8, 8), 0, False, False, None)
    assert pending.t_synced is None and pending.t_ready is None
    pending.fetch()
    assert pending.t_synced is not None
    assert pending.t_synced <= pending.t_ready


def test_dispatch_gap_counts_from_the_device_sync(engine):
    sched = MicroBatchScheduler(engine, max_batch=2, gather_window_s=0.0,
                                pipeline_depth=2)
    try:
        seen = {}
        sched.metrics.record_hot_path = lambda **kw: seen.update(kw)
        now = time.monotonic()
        prev = types.SimpleNamespace(t_synced=now - 2.0, t_ready=now - 1.0)
        pending = types.SimpleNamespace(h2d_bytes=0)
        sched._hot_path(prev, False, now, pending, [])
        assert seen["gap_ms"] >= 2000.0
        # a pending without the device stamp keeps its hand-over time
        old = types.SimpleNamespace(t_ready=now - 1.0)
        sched._hot_path(old, False, now, pending, [])
        assert 1000.0 <= seen["gap_ms"] < 2000.0
    finally:
        sched.close()
