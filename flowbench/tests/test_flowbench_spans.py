"""``flowbench/spans.py``'s arithmetic on crafted device events, markers
and spans: it recovers a planted clock offset to the microsecond, its idle
attributions with the unattributed gaps and the slice's edges sum to
``trace.idle``, it reads ``None`` when a marker is missing from the trace,
and the tail split takes the requests at or above the 95th percentile. On
the card (``python -m pytest flowbench/tests -m gpu``): a span around a
sleep kernel, put on the trace's clock by its markers, holds the kernel's
device interval and, over twenty such spans, starts a median of under
50 µs after it."""

from __future__ import annotations

import importlib.util
import os
import statistics

import pytest

from flowbench import spans, trace
from flowbench.spec import ROOT
from raft_tpu_torch.serving import trace as program_trace
from raft_tpu_torch.serving.trace import SpanRecord

#: the planted offset: device seconds = host ns * 1e-9 + OFFSET
OFFSET = -9.987654321
#: the launch latency of the fastest marker, in seconds
LATENCY = 5e-7
MS = 1_000_000
#: the slice, in seconds
WINDOW = 0.25


def dev(t_ns: int) -> float:
    """Host ``t_ns`` on the device trace's clock."""
    return t_ns * 1e-9 + OFFSET


def crafted():
    """Two train steps of spans (ns on the host clock, 10 s in), their
    markers, and device events with idle gaps inside and outside them."""
    recs, stamps, events = [], [], []
    for k in range(2):
        s = 10_000 * MS + 100 * MS * k
        recs.append(SpanRecord("train.step", 1, s, s + 95 * MS, None))
        stamps.append(s + 500)
        for name, a, b in (("train.inputs", 0, 5), ("train.forward", 5, 50),
                           ("train.loss", 50, 55),
                           ("train.backward", 55, 85),
                           ("train.optimizer", 85, 95)):
            recs.append(SpanRecord(name, 1, s + a * MS, s + b * MS,
                                   "train.step"))
            stamps.append(s + a * MS + 1000)
        # busy 1-20, 22-48, 60-80 and 90-99 ms of each step: gaps of 2 ms
        # in the forward, 12 ms from the forward's end through the loss
        # into the backward, 10 ms across the backward and the optimizer,
        # and 2 ms into the next step, half of it outside every span
        for a, b in ((1, 20), (22, 48), (60, 80), (90, 99)):
            events.append(("kernel", dev(s + a * MS), dev(s + b * MS)))
    # every marker starts a launch's latency after its stamp, or later
    for i, h in enumerate(stamps):
        d = dev(h) + LATENCY * (1 + i % 3)
        events.append(("at::cuda::(anonymous namespace)::spin_kernel(long)",
                       d, d + 1e-6))
    return recs, stamps, {"events": events, "window_s": WINDOW,
                          "busy_s": trace.union_s(events)}


@pytest.fixture
def planted(monkeypatch):
    recs, stamps, ctx = crafted()
    monkeypatch.setattr(program_trace, "records", lambda: list(recs))
    monkeypatch.setattr(program_trace, "markers", lambda: list(stamps))
    return recs, stamps, ctx


def test_offset_is_recovered_to_the_microsecond(planted):
    _, stamps, ctx = planted
    assert 0 < min(a for _, a, _ in ctx["events"]) < WINDOW
    assert abs(spans.offset_s(ctx["events"], stamps) - OFFSET) < 1e-6


def test_parts_sum_to_the_idle_share(planted):
    _, _, ctx = planted
    groups = {"forward": ("train.inputs", "train.forward", "train.loss"),
              "backward": ("train.backward",),
              "optimizer": ("train.optimizer",)}
    parts = spans.idle_parts(ctx, groups)
    assert sum(parts.values()) == pytest.approx(trace.idle(ctx), abs=1e-9)
    # per step the forward group holds 1 + 2 + 2 + 5 ms of idle (the
    # inputs' first ms, after the step's first marker), the backward 5 + 5,
    # the optimizer 5; the ms after the first step's end is in none (the
    # markers that land in gaps take a microsecond each)
    for label, ms in (("forward", 10), ("backward", 10), ("optimizer", 5),
                      ("unattributed", 0.5)):
        assert parts[label] == pytest.approx(100 * 2 * ms * 1e-3 / WINDOW,
                                             abs=5e-3), label
    assert spans.idle_in(ctx, groups["backward"]) == parts["backward"]


def test_a_missing_marker_reads_none(planted, monkeypatch):
    _, stamps, ctx = planted
    events = list(ctx["events"])
    lost = next(i for i, e in enumerate(events) if "spin_kernel" in e[0])
    del events[lost]
    ctx = dict(ctx, events=events, busy_s=trace.union_s(events))
    assert spans.idle_in(ctx, ("train.forward",)) is None
    assert spans.offset_s(events, stamps) is None


def test_no_trace_or_no_recorder_reads_none(planted, monkeypatch):
    _, _, ctx = planted
    assert spans.mean_ms(dict(ctx, events=[]), "train.step") is None
    monkeypatch.delattr(program_trace, "records")
    assert spans.mean_ms(ctx, "train.step") is None
    assert spans.idle_in(ctx, ("train.forward",)) is None


def test_mean_span(planted):
    _, _, ctx = planted
    assert spans.mean_ms(ctx, "train.step") == pytest.approx(95.0)
    assert spans.mean_ms(ctx, "nothing") is None


def test_tail_split_takes_the_requests_at_or_above_p95(monkeypatch):
    recs = []
    for i in range(100):
        # queue i ms, flight 10 ms: totals 10 .. 109 ms
        s = i * 200 * MS
        recs.append(SpanRecord("sched.request", 1, s, s + (i + 10) * MS,
                               "sched.settle", {"taken": s + i * MS}))
    monkeypatch.setattr(program_trace, "records", lambda: recs)
    monkeypatch.setattr(program_trace, "markers", lambda: [])
    ctx = {"events": [("kernel", 0.0, 1.0)], "window_s": 2.0}
    queue, flight = spans.tail_split(ctx)
    # the 95th percentile of 10..109 is 104.05: totals 105..109 are in
    assert queue == pytest.approx((95 + 96 + 97 + 98 + 99) / 5)
    assert flight == pytest.approx(10.0)


@pytest.mark.parametrize("name", [
    "step.host_ms.train", "step.idle_forward.train",
    "step.idle_backward.train", "step.idle_optimizer.train",
    "sched.idle_slot_wait.serve", "sched.idle_host.serve",
    "engine.d2h_ms.serve", "sched.tail_queue_ms.open",
    "engine.tail_flight_ms.open"])
def test_reader_reads_nothing_without_a_trace(name):
    path = os.path.join(ROOT, "flowbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("m", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.read({"events": [], "window_s": 1.0}) is None


@pytest.mark.gpu
def test_sleep_kernel_lies_inside_its_span_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda", 0)
    cycles = 1_000_000
    with program_trace.span("warm", marker=device):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize(device)
    with trace.Slice(device, True) as sl:
        # the first launches under a new profiler session are slow: warm
        # them inside it too
        for name in ["warm"] * 3 + ["probe"] * 20:
            with program_trace.span(name, marker=device):
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize(device)
    recs = sorted((r for r in program_trace.records() if r.name == "probe"),
                  key=lambda r: r.start_ns)
    sleeps = sorted((a, b) for n, a, b in sl.events
                    if spans.MARKER.search(n))
    # the probes spin a million cycles, the markers one
    long = [s for s in sleeps if s[1] - s[0] > 1e-4][3:]
    short = [("spin_kernel", a, b) for a, b in sleeps if b - a <= 1e-4]
    assert len(recs) == len(long) == 20
    offset = spans.offset_s(short, program_trace.markers())
    assert offset is not None
    lags = []
    for r, (a, b) in zip(recs, long):
        start = r.start_ns * 1e-9 + offset
        end = r.end_ns * 1e-9 + offset
        assert start <= a and b <= end, (start, a, b, end)
        lags.append(a - start)
    # the span starts at its marker's stamp; the sleep's launch follows
    # the marker's, so a host that stalls between the two delays one
    # probe's kernel (59 µs once), not the clock
    assert statistics.median(lags) < 50e-6, lags
