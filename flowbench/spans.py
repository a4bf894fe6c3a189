"""The program's layer spans read against the device trace of a traced run.

While a profiler session runs, ``raft_tpu_torch.serving.trace`` records
spans at the program's layer boundaries (``records()``) on the host's
``time.perf_counter_ns()`` clock, and each span of a thread that issues
device work launches a one-thread marker kernel on a stream of its own
(``markers()``: the host stamp taken just before each launch). The
device trace gives each marker's start on the profiler's clock, so the
least of (device start − host stamp) over the markers is the offset that
puts every span on that clock: a marker that lands on an idle SM starts
a launch's latency after its stamp, and never sooner. A marker lost from
the trace (the counts differ) leaves the offset unknown: the attributions
then read ``None``, never 0.

From that, three kinds of number:

- :func:`idle_in`: the percent of the slice (``ctx["window_s"]``) in which
  no device event ran while the program was inside the named spans, over
  the gaps between merged device intervals as ``trace.gaps`` forms them;
- :func:`mean_ms`: the mean duration of a span;
- :func:`tail_split`: the queueing and flight of the slice's tail
  requests (``sched.request`` records at or above their 95th percentile).

A program without the recorder (an older commit) gives no records, and
every number reads ``None``; so does a run with no device trace.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from flowbench import trace

#: the marker kernel's name in the device trace (``torch.cuda._sleep``)
MARKER = re.compile(r"\bspin_kernel\b")

Interval = Tuple[float, float]


def program_records(ctx: Dict) -> Optional[Tuple[list, List[int]]]:
    """The program's span records and marker stamps for a traced run with
    device events, or None."""
    if not ctx.get("events"):
        return None
    try:
        from raft_tpu_torch.serving import trace as program_trace
    except ImportError:
        return None
    records = getattr(program_trace, "records", None)
    markers = getattr(program_trace, "markers", None)
    if records is None or markers is None:
        return None
    return records(), markers()


def offset_s(events: Iterable[trace.Event], stamps_ns: Sequence[int]
             ) -> Optional[float]:
    """Seconds to add to a host stamp to put it on the device trace's
    clock: the least (device start − host stamp) over the markers, paired
    in order. None without markers or if their counts differ."""
    device = sorted(a for name, a, _ in events if MARKER.search(name))
    if not stamps_ns or len(device) != len(stamps_ns):
        return None
    return min(d - h * 1e-9 for d, h in zip(device, sorted(stamps_ns)))


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(events: Iterable[trace.Event]) -> List[Interval]:
    """The gaps between the merged intervals of the device events."""
    busy = merged((a, b) for _, a, b in events)
    return [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]


def overlap_s(xs: List[Interval], ys: List[Interval]) -> float:
    """Seconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_intervals(records, names: Sequence[str], offset: float
                   ) -> List[Interval]:
    """The union of the named spans on the device trace's clock."""
    return merged((r.start_ns * 1e-9 + offset, r.end_ns * 1e-9 + offset)
                  for r in records if r.name in names)


def idle_parts(ctx: Dict, groups: Dict[str, Sequence[str]]
               ) -> Optional[Dict[str, float]]:
    """Percent of the slice idle inside each group of spans, the rest of
    the gaps between device events (``unattributed``), and the slice
    before the first and after the last event (``edges``). With groups
    that share no instant they sum to ``trace.idle``."""
    got = program_records(ctx)
    if got is None:
        return None
    records, stamps = got
    offset = offset_s(ctx["events"], stamps)
    if offset is None:
        return None
    gaps = idle_gaps(ctx["events"])
    window = ctx["window_s"]
    out = {}
    for label, names in groups.items():
        out[label] = 100.0 * overlap_s(
            gaps, span_intervals(records, names, offset)) / window
    every = [n for names in groups.values() for n in names]
    inside = overlap_s(gaps, span_intervals(records, every, offset))
    out["unattributed"] = 100.0 * (sum(b - a for a, b in gaps)
                                   - inside) / window
    first = min(a for _, a, _ in ctx["events"])
    last = max(b for _, _, b in ctx["events"])
    out["edges"] = 100.0 * (window - (last - first)) / window
    return out


def idle_in(ctx: Dict, names: Sequence[str]) -> Optional[float]:
    """Percent of the slice in which no device event ran while the program
    was inside any of the spans ``names``."""
    parts = idle_parts(ctx, {"in": names})
    return None if parts is None else parts["in"]


def mean_ms(ctx: Dict, name: str) -> Optional[float]:
    """The mean duration of the spans ``name``, in ms."""
    got = program_records(ctx)
    if got is None:
        return None
    spans = [r.end_ns - r.start_ns for r in got[0] if r.name == name]
    return 1e-6 * float(np.mean(spans)) if spans else None


def tail_split(ctx: Dict, q: float = 95.0
               ) -> Optional[Tuple[float, float]]:
    """The mean ms from submit to being taken into a batch, and from being
    taken to settling, over the ``sched.request`` records whose total is at
    or above the ``q``-th percentile of all of theirs."""
    got = program_records(ctx)
    if got is None:
        return None
    reqs = [r for r in got[0] if r.name == "sched.request"]
    if not reqs:
        return None
    totals = np.array([r.end_ns - r.start_ns for r in reqs], np.float64)
    cut = np.percentile(totals, q)
    tail = [r for r, t in zip(reqs, totals) if t >= cut]
    queue = np.mean([r.marks["taken"] - r.start_ns for r in tail])
    flight = np.mean([r.end_ns - r.marks["taken"] for r in tail])
    return 1e-6 * float(queue), 1e-6 * float(flight)
