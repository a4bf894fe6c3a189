"""The traced run's reduction: device events from ``torch.profiler``, the
device's busy time, shares by kind of kernel, and a kernel's share of its
roofline.

A traced run profiles one slice of load with CUDA activity only, kept in
memory (no chrome trace is written). The profiler is stopped only once the
load has stopped, every request or step has finished and the device has
synchronised, so no thread is inside a graph replay when it stops.

The busy time is the union of the device events' intervals (kernels,
copies, memsets), so kernels that overlap on other streams count once, as
``raft_tpu_torch/cli/profile_step.busy_ms`` computes it. The kernel
classes are a frozen copy of ``raft_tpu_torch/cli/trace_summary``'s rules,
with its copies split in two: ``copy`` holds the memcpy and memset
operations alone (the engine's frames in, clones and flows out), and
``layout`` the kernels that only move a tensor's elements in memory
(cuDNN's NCHW/NHWC conversions around its convolutions, transposes,
``.contiguous()`` and dtype copies), which the model's layers cause.
"""

from __future__ import annotations

import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

from flowbench import counts

#: the port's kernels by their CUDA function names (csrc/*.cu)
PORT_KERNELS = {
    "k1": ("corr_lookup_kernel",),
    "k2": ("gru_gates_kernel", "gru_blend_kernel"),
    "k3": ("corr_scatter_kernel",),
    "k4": ("gru_gates_bwd_kernel", "gru_blend_bwd_kernel"),
    "k5": ("corr_alt_kernel",),
}
_PORT = [(re.compile(rf"\b{fn}\b"), k) for k, fns in PORT_KERNELS.items()
         for fn in fns]
_RULES = (
    ("copy", ("memcpy", "memset")),
    ("layout", ("nchwtonhwc", "nhwctonchw", "copy_kernel", "transpose")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "fft", "cf32",
              "implicit_gemm", "flip_filter")),
    ("gemm", ("gemm", "cutlass", "cublas", "xmma")),
    ("elementwise", ("elementwise", "reduce", "softmax", "norm", "bn_",
                     "index", "scatter", "gather", "cat_", "pool",
                     "upsample", "grid_sampler", "where", "fill")),
)

Event = Tuple[str, float, float]          # name, start s, end s


def kind(name: str) -> str:
    """``k1`` .. ``k5`` for the port's kernels, else the class of a
    library or PyTorch kernel: copy, layout, conv, gemm, elementwise,
    other."""
    for pat, k in _PORT:
        if pat.search(name):
            return k
    low = name.lower()
    for label, frags in _RULES:
        if any(f in low for f in frags):
            return label
    return "other"


def union_s(events: Iterable[Event]) -> float:
    """Seconds in which at least one of ``events`` ran."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


class Slice:
    """``with Slice(device, traced) as s:`` times its body and, when
    ``traced``, profiles it; afterwards ``s.events`` holds the device
    events and ``s.window_s`` the slice's length by the host clock. The
    body must end with the device synchronised. An untraced run, and any
    run on a CPU device, profiles nothing and leaves ``events`` empty."""

    def __init__(self, device, traced: bool):
        self.device = device
        self.traced = traced
        self.events: List[Event] = []
        self.window_s = 0.0
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.traced and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self._t0
        if self._prof is None:
            return False
        import torch

        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        self.events = [(e.name, e.time_range.start / 1e6,
                        e.time_range.end / 1e6)
                       for e in self._prof.events()
                       if e.device_type == cuda]
        self._prof = None
        return False


def by_kind(events: List[Event]) -> Dict[str, List[Event]]:
    out: Dict[str, List[Event]] = {}
    for e in events:
        out.setdefault(kind(e[0]), []).append(e)
    return out


def share(ctx: Dict, kinds: Tuple[str, ...]) -> Optional[float]:
    """Percent of the device's busy time spent in kernels of ``kinds``."""
    if not ctx["events"]:
        return None
    groups = by_kind(ctx["events"])
    sel = [e for k in kinds for e in groups.get(k, [])]
    return 100.0 * union_s(sel) / ctx["busy_s"]


def idle(ctx: Dict) -> Optional[float]:
    """Percent of the slice in which no device event ran."""
    if not ctx["events"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def roofline(ctx: Dict, kernel: str) -> Optional[float]:
    """Percent of its roofline a port kernel reaches: its launches' least
    times (``ctx["launch_bounds"][kernel]``: (launches, least seconds of
    one) for each shape the slice ran) over their device time. The mean
    least time a launch is weighted by the launches the program made; the
    mean device time is over the launches the profiler recorded, so a
    lost event changes neither."""
    bounds = ctx.get("launch_bounds", {}).get(kernel)
    events = by_kind(ctx["events"]).get(kernel, [])
    if not bounds or not events:
        return None
    launches = sum(n for n, _ in bounds)
    least = sum(n * b for n, b in bounds) / launches
    spent = sum(b - a for _, a, b in events) / len(events)
    return 100.0 * least / spent


def mfu(ctx: Dict) -> Optional[float]:
    """Percent of the stated precision's peak that the algorithm's
    operations for the pairs finished in the slice reach over it."""
    if not ctx["events"] or not ctx.get("pairs"):
        return None
    return 100.0 * ctx["pairs"] * ctx["flops_per_pair"] / (
        ctx["window_s"] * ctx["peak_flops"])


def top(events: List[Event], n: int = 10) -> List[List]:
    """The ``n`` device operations that took the most time, by name."""
    tot: Dict[str, float] = {}
    for name, a, b in events:
        tot[name] = tot.get(name, 0.0) + (b - a)
    return [[k[:120], v] for k, v in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:n]]


def gaps(events: List[Event], n: int = 10) -> List[List]:
    """The ``n`` longest idle gaps between device events, each named by
    the kinds of the events on either side of it."""
    out, prev = [], None
    for e in sorted(events, key=lambda e: e[1]):
        if prev is not None and e[1] > prev[2]:
            out.append([f"{kind(prev[0])} -> {kind(e[0])}", e[1] - prev[2]])
        if prev is None or e[2] > prev[2]:
            prev = e
    return sorted(out, key=lambda g: -g[1])[:n]


def kernel_bound(cost: Tuple[float, float]) -> float:
    """The least time of one launch moving ``cost`` (bytes, operations);
    the port's kernels compute on the CUDA cores in float32."""
    return counts.bound_s(cost, counts.PEAKS["fp32_flops"])
