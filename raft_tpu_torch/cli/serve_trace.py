"""Read back spans.jsonl: trace timelines + where-did-the-p99-go; port
of ``raft_tpu/cli/serve_trace.py``. The record schema is the JAX
package's, so it reads either package's spans files.

The serving stack's request tracing (serving/trace.py) writes one
span record per accepted request (plus fan-in dispatch spans) — this
tool is the read side:

- the default report answers the operator question "where did the p99
  go": outcome-class counts, the latency histogram's top-bucket
  membership among retained spans, and a **phase-attribution table
  over the tail exemplars** (queue vs assembly vs device vs fetch —
  which stage of the pipeline actually ate the slow requests' time),
  with each exemplar's dominant phase and annotations (coalesce
  fan-in, cache hit/miss, breaker state at admit, canary assignment);
- ``--trace ID`` reconstructs one trace's timeline: the span's phase
  marks, its linked dispatch span (the micro-batch it rode, who else
  rode it, the padding share), and the session chain walked through
  ``parent`` links back to the stream's first frame.

Usage::

    python -m raft_tpu_torch.cli.serve_trace runs/serve/spans.jsonl
    python -m raft_tpu_torch.cli.serve_trace spans.jsonl --trace r-17
    python -m raft_tpu_torch.cli.serve_trace spans.jsonl --all --top 10

Nothing on this path touches a device — the only package import is the
metrics module's histogram ladder, so the tool runs wherever the jsonl
files land.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

#: attribution columns, in pipeline order (serving/trace._phases)
PHASES = ("queue_ms", "assembly_ms", "device_ms", "fetch_ms")

_LADDER = None


def _hist_idx(span: Dict) -> int:
    """The latency-histogram bucket this span's completion was binned
    into: ``observed_ms`` is the exact value ServingMetrics observed
    (the span's own close clock runs ms later), binned by the
    histogram's own ``bucket_idx`` — one definition, no drift."""
    global _LADDER
    if _LADDER is None:
        from raft_tpu_torch.serving.metrics import LatencyHistogram
        _LADDER = LatencyHistogram()
    return _LADDER.bucket_idx(span.get("observed_ms",
                                       span.get("total_ms", 0.0)))


def load_spans(path: str) -> List[Dict]:
    """Parse spans.jsonl; skips non-span lines (a shared file is
    tolerated) and unparseable lines (a torn tail write must not kill
    the report)."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "span":
                out.append(rec)
    return out


def request_spans(spans: List[Dict]) -> List[Dict]:
    return [s for s in spans if s.get("span") == "request"]


def tail_spans(spans: List[Dict]) -> List[Dict]:
    """The retained tail exemplars in the histogram's FINAL top
    occupied bucket. The ``tail`` flag ratchets at write time (an
    early fast completion is trivially "top so far" and stays
    retained), so membership re-derives here: among tail-flagged
    request spans, keep those binned into the max occupied bucket —
    the same filter the metrics snapshot's ``tail_exemplars`` refs
    apply."""
    tails = [s for s in request_spans(spans) if s.get("tail")]
    if not tails:
        return tails
    top = max(_hist_idx(s) for s in tails)
    return [s for s in tails if _hist_idx(s) == top]


def phase_attribution(spans: List[Dict],
                      tail_only: bool = True) -> Dict:
    """The p99-attribution table: per phase, total/mean ms and the
    share of the selected spans' wall time. ``tail_only`` selects the
    tail exemplars (falling back to every completed request span when
    none are flagged — e.g. a drill too uniform to have a tail)."""
    sel = tail_spans(spans) if tail_only else []
    if not sel:
        sel = [s for s in request_spans(spans)
               if s.get("class") == "completed"]
    if not sel:
        return {"spans": 0, "total_ms": 0.0, "phases": {}}
    totals = {p: 0.0 for p in PHASES}
    wall = 0.0
    for s in sel:
        wall += s.get("total_ms", 0.0)
        for p, v in (s.get("phases") or {}).items():
            if p in totals:
                totals[p] += v
    n = len(sel)
    return {
        "spans": n,
        "total_ms": round(wall, 3),
        "mean_ms": round(wall / n, 3),
        "phases": {
            p: {"total_ms": round(t, 3),
                "mean_ms": round(t / n, 3),
                "share": round(t / wall, 4) if wall else 0.0}
            for p, t in totals.items()},
    }


def dominant_phase(span: Dict) -> Optional[str]:
    ph = span.get("phases") or {}
    known = {p: v for p, v in ph.items() if p in PHASES}
    if not known:
        return None
    return max(known, key=known.get)


def top_bucket_membership(spans: List[Dict]) -> Dict:
    """Which retained request spans sit in the latency histogram's top
    occupied region: the tail-flagged spans, their max total_ms, and
    their trace ids — the membership the metrics snapshot's
    ``tail_exemplars`` refs must resolve against."""
    tails = tail_spans(spans)
    return {
        "count": len(tails),
        "trace_ids": [s["trace_id"] for s in tails],
        "max_ms": max((s.get("total_ms", 0.0) for s in tails),
                      default=0.0),
    }


def find(spans: List[Dict], trace_id: str) -> Optional[Dict]:
    for s in spans:
        if s.get("trace_id") == trace_id:
            return s
    return None


def timeline(spans: List[Dict], trace_id: str,
             max_chain: int = 64) -> Dict:
    """One trace reconstructed: the span, its dispatch span (the
    micro-batch fan-in it rode), and the session chain walked back
    through ``parent`` links (bounded; a cycle or a pruned parent
    terminates the walk cleanly — a sampled-out ancestor is reported
    as such, not an error)."""
    span = find(spans, trace_id)
    if span is None:
        return {"trace_id": trace_id, "found": False}
    dispatch = (find(spans, span["dispatch"])
                if span.get("dispatch") else None)
    chain: List[Dict] = []
    seen = {trace_id}
    cur = span
    truncated = False
    while cur is not None and cur.get("parent"):
        if len(chain) >= max_chain:
            truncated = True      # cap hit: the stream goes on back
            break
        pid = cur["parent"]
        if pid in seen:
            truncated = True      # defensive: a cycle ends the walk
            break
        seen.add(pid)
        parent = find(spans, pid)
        if parent is None:
            chain.append({"trace_id": pid, "retained": False})
            break                 # sampled out / rotated away
        chain.append(parent)
        cur = parent
    return {"trace_id": trace_id, "found": True, "span": span,
            "dispatch": dispatch, "chain": chain,
            "chain_truncated": truncated}


def _fmt_ms(v) -> str:
    return f"{v:9.3f}" if isinstance(v, (int, float)) else f"{'-':>9}"


def print_timeline(tl: Dict) -> None:
    if not tl.get("found"):
        print(f"trace {tl['trace_id']}: not found (sampled out, or "
              "wrong file?)")
        return
    s = tl["span"]
    print(f"trace {s['trace_id']}  [{s.get('class', '?')}] "
          f"outcome={s.get('outcome')} bucket={s.get('bucket')} "
          f"total={s.get('total_ms')}ms tail={s.get('tail')}")
    meta = {k: s[k] for k in ("model", "variant", "canary", "priority",
                              "stream", "seq", "prime", "cache",
                              "warm", "breaker_at_admit", "reason",
                              "deadline_s") if k in s}
    if meta:
        print(f"  {json.dumps(meta)}")
    ph = s.get("phases") or {}
    if ph:
        print("  phase        ms")
        for p in PHASES:
            if p in ph:
                print(f"  {p:<12}{_fmt_ms(ph[p])}")
    d = tl.get("dispatch")
    if d is not None:
        print(f"  dispatch {d['trace_id']}: fan_in={d.get('fan_in')} "
              f"capacity={d.get('capacity')} "
              f"padding_waste={d.get('padding_waste')} "
              f"bucket={d.get('bucket')}")
        others = [r for r in d.get("requests", [])
                  if r != s["trace_id"]]
        if others:
            print(f"    coalesced with: {', '.join(others)}")
    if tl["chain"]:
        print("  session chain (newest -> oldest):")
        for p in tl["chain"]:
            if not p.get("retained", True):
                print(f"    {p['trace_id']}  (not retained — sampled "
                      "out)")
                continue
            print(f"    {p['trace_id']}  [{p.get('class', '?')}] "
                  f"{p.get('total_ms')}ms seq={p.get('seq', '-')} "
                  f"prime={p.get('prime', False)} "
                  f"cache={p.get('cache', '-')}")


def print_report(spans: List[Dict], top: int,
                 tail_only: bool = True) -> None:
    reqs = request_spans(spans)
    by_class: Dict[str, int] = {}
    for s in reqs:
        by_class[s.get("class", "?")] = \
            by_class.get(s.get("class", "?"), 0) + 1
    n_disp = sum(1 for s in spans if s.get("span") == "dispatch")
    print(f"{len(reqs)} request spans ({n_disp} dispatch spans) "
          f"by class: {json.dumps(by_class, sort_keys=True)}")
    membership = top_bucket_membership(spans)
    print(f"top-bucket membership: {membership['count']} tail "
          f"exemplars, max {membership['max_ms']}ms")

    attr = phase_attribution(spans, tail_only=tail_only)
    scope = ("tail exemplars" if tail_only and tail_spans(spans)
             else "all completed spans")
    print(f"\n== where did the p99 go: phase attribution over "
          f"{attr['spans']} {scope} ==")
    for p in PHASES:
        blk = attr["phases"].get(p)
        if blk is None:
            continue
        print(f"{blk['share'] * 100:6.1f}%  mean {_fmt_ms(blk['mean_ms'])} ms  {p}")

    sel = tail_spans(spans) or reqs
    sel = sorted(sel, key=lambda s: -s.get("total_ms", 0.0))[:top]
    if sel:
        print(f"\n== top {len(sel)} slowest retained spans ==")
        for s in sel:
            notes = []
            dom = dominant_phase(s)
            if dom:
                notes.append(f"dominant={dom}")
            for k in ("cache", "breaker_at_admit", "canary", "fan_in",
                      "reason"):
                if k in s and s[k] not in (None, False, "closed"):
                    notes.append(f"{k}={s[k]}")
            print(f"{_fmt_ms(s.get('total_ms'))} ms  {s['trace_id']:<8} "
                  f"[{s.get('class', '?')}] {s.get('bucket', '?'):<16} "
                  f"{' '.join(notes)}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="reconstruct request traces / attribute tail "
                    "latency from spans.jsonl")
    p.add_argument("spans", help="spans.jsonl written by a traced "
                                 "scheduler/registry")
    p.add_argument("--trace", default=None, metavar="ID",
                   help="reconstruct one trace's timeline (span + "
                        "dispatch fan-in + session chain)")
    p.add_argument("--top", type=int, default=15,
                   help="slowest-span table size")
    p.add_argument("--all", action="store_true",
                   help="attribute over every completed span, not "
                        "just the tail exemplars")
    args = p.parse_args(argv)

    if not os.path.exists(args.spans):
        raise SystemExit(f"no such spans file: {args.spans}")
    spans = load_spans(args.spans)
    if not spans:
        raise SystemExit(f"{args.spans}: no span records — was "
                         "tracing armed (--trace-path / trace_path=)?")
    if args.trace:
        print_timeline(timeline(spans, args.trace))
        return
    print_report(spans, args.top, tail_only=not args.all)


if __name__ == "__main__":
    main()
