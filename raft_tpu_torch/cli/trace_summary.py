"""Top device ops and a rollup by category of a ``torch.profiler`` trace,
port of ``raft_tpu/cli/trace_summary.py`` (which reads XPlane traces).

Reads the chrome traces (``*.pt.trace.json``) that the trainer's
``profile_steps`` and ``cli/profile_step --trace-dir`` write, and sums the
device events (kernels, copies, memsets) by name and by category:

- the port's own kernels by name: K1 ``corr_lookup``, K3
  ``corr_scatter``, K2 ``gru_gates``/``gru_blend``, K4 their backward, K5
  ``corr_alt``;
- convolutions (cuDNN's implicit GEMMs, its FFT kernels and their complex
  GEMMs; its layout transposes are copies, below);
- GEMMs (cuBLAS, CUTLASS);
- elementwise and reductions (PyTorch's own kernels);
- copies and casts (memcpy, memset, layout transposes, dtype casts);
- everything else.

    python -m raft_tpu_torch.cli.trace_summary runs/profile [--top 20]

A trace with no device events (one taken on the CPU) reports empty, as the
JAX package's ``report`` does. Prints the tables and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from collections import defaultdict

#: the port's kernels by their CUDA function names (csrc/*.cu)
PORT_KERNELS = (
    ("corr_lookup_kernel", "K1 corr_lookup"),
    ("corr_scatter_kernel", "K3 corr_scatter"),
    ("gru_gates_kernel", "K2 gru_gates"),
    ("gru_blend_kernel", "K2 gru_blend"),
    ("gru_gates_bwd_kernel", "K4 gru_gates_bwd"),
    ("gru_blend_bwd_kernel", "K4 gru_blend_bwd"),
    ("corr_alt_kernel", "K5 corr_alt"),
)
_PORT = [(re.compile(rf"\b{fn}\b"), cat) for fn, cat in PORT_KERNELS]
#: (category, name fragments), tried in order after the port's kernels.
#: Fragments are specific: PyTorch's generic elementwise kernels carry
#: "nocast" in their template names, and cuDNN's batch norm "cudnn".
_RULES = (
    ("copies and casts", ("memcpy", "memset", "nchwtonhwc", "nhwctonchw",
                          "copy_kernel", "transpose")),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "fft", "cf32",
                      "implicit_gemm", "flip_filter")),
    ("gemms", ("gemm", "cutlass", "cublas", "xmma")),
    ("elementwise and reductions", ("elementwise", "reduce", "softmax",
                                    "norm", "bn_", "index", "scatter",
                                    "gather", "cat_", "pool", "upsample",
                                    "grid_sampler", "where", "fill")),
)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str, cat: str = "kernel") -> str:
    """The rollup category of a device event."""
    for pat, label in _PORT:
        if pat.search(name):
            return label
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copies and casts"
    low = name.lower()
    for label, frags in _RULES:
        if any(f in low for f in frags):
            return label
    return "other"


def trace_files(path: str) -> list:
    """``path`` itself, or every ``*.pt.trace.json`` under it."""
    if os.path.isfile(path):
        return [path]
    files = sorted(glob.glob(os.path.join(path, "**", "*.pt.trace.json"),
                             recursive=True))
    if not files:
        raise SystemExit(f"no *.pt.trace.json under {path}")
    return files


def device_events(files) -> list:
    """(name, trace category, µs) of every complete device event."""
    out = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            data = json.load(fh)
        events = data["traceEvents"] if isinstance(data, dict) else data
        for e in events:
            cat = str(e.get("cat", "")).lower()
            if e.get("ph") == "X" and cat in _DEVICE_CATS:
                out.append((str(e.get("name", "?")), cat,
                            float(e.get("dur", 0.0))))
    return out


def summarize(events, top: int = 20) -> dict:
    """Totals by category and the ``top`` ops by device time."""
    by_cat = defaultdict(lambda: [0.0, 0])
    by_op = defaultdict(lambda: [0.0, 0, ""])
    total = 0.0
    for name, cat, us in events:
        c = category(name, cat)
        by_cat[c][0] += us
        by_cat[c][1] += 1
        by_op[name][0] += us
        by_op[name][1] += 1
        by_op[name][2] = c
        total += us
    cats = {c: {"us": t, "count": n, "share": t / total if total else 0.0}
            for c, (t, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0])}
    ops = [{"name": k, "us": t, "count": n, "category": c}
           for k, (t, n, c) in sorted(by_op.items(),
                                      key=lambda kv: -kv[1][0])[:top]]
    return {"device_us": total, "events": len(events), "categories": cats,
            "top": ops}


def report(summary: dict) -> None:
    if not summary["events"]:
        print("no device events: the trace was taken without the card "
              "(a CPU run)", flush=True)
        return
    total = summary["device_us"]
    print(f"\n== device time by category (total {total:,.0f} us, "
          f"{summary['events']} events) ==")
    for c, v in summary["categories"].items():
        print(f"{v['share'] * 100:6.1f}%  {v['us']:12,.0f} us  "
              f"x{v['count']:<7d} {c}")
    print(f"\n== top {len(summary['top'])} ops by device time ==")
    for op in summary["top"]:
        print(f"{op['us'] / total * 100:6.2f}%  {op['us']:10,.0f} us  "
              f"x{op['count']:<6d} {op['category'][:26]:26s} "
              f"{op['name'][:80]}", flush=True)


def main(argv=None) -> dict:
    """Summarize; returns the JSON line's numbers."""
    p = argparse.ArgumentParser(
        description="summarize torch.profiler chrome traces")
    p.add_argument("trace", help="a *.pt.trace.json or a directory of them")
    p.add_argument("--top", type=int, default=20)
    args = p.parse_args(argv)
    files = trace_files(args.trace)
    summary = summarize(device_events(files), args.top)
    print(f"trace: {len(files)} file(s), {summary['events']} device events")
    report(summary)
    out = {"metric": "trace_summary", "files": files, **summary}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
