"""The benchmark of ``raft_tpu_torch`` on one NVIDIA H100: one run of one
cell in one process.

    python3 -m flowbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It reads the cell from ``BENCHMARK.json`` (``flowbench.spec``), sets the
configuration's precision, makes the weights and inputs from the seed on
the card, builds and warms the system under test, measures for
``--seconds`` seconds (``--trace 1``: profiles a fixed slice instead),
then frees the program and holds what the timed path produced against the
plain reference (``flowbench.check``). It prints each number compared
beside its limit as its last lines on standard error, and as the last line
of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``.

It exits non-zero, printing no result, without a CUDA card (or fewer than
the cell asks for), and if ``jax``, ``jaxlib``, ``flax`` or ``raft_tpu``
(the JAX package, which the benchmark never measures) is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: top-level module names the run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> None:
    print(f"flowbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def measure(cell, seed: int, seconds: int, traced: bool, device,
            stages=None) -> dict:
    """One run of ``cell`` on ``device`` by its kind's module
    (:mod:`flowbench.kinds`): the result line's fields, and the compared
    numbers under ``checks``. ``stages`` gathers the seconds from the
    process's start to the end of each stage of set-up."""
    stages = {} if stages is None else stages
    out = cell.kind.run(cell, seed, seconds, traced, device, T_PROCESS,
                        stages)
    out["stages"] = stages
    metrics = {}
    if traced:
        ctx = out["ctx"]
        for m in cell.metrics(trace=True):
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(out.get("e2e", {}), setup_s=out["setup_s"])
        for m in cell.metrics(trace=False):
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    out["metrics"] = metrics
    out["correct"] = bool(out["checks"]) and all(
        math.isfinite(v) and v <= lim for _, v, lim in out["checks"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from flowbench.spec import Cell

    try:
        cell = Cell(args.workload)
    except (OSError, KeyError, ValueError) as exc:
        fail(str(exc))
    import torch

    stages = {"import_torch": time.perf_counter() - T_PROCESS}
    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the card and never "
             "runs on the CPU")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell asks for {cell.chips} cards, "
             f"{torch.cuda.device_count()} are present")
    try:
        import raft_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the system under test is missing: {exc}")
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    stages["cuda_init"] = time.perf_counter() - T_PROCESS
    out = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                  stages)

    found = forbidden_modules()
    if found:
        fail(f"loaded {', '.join(found)}: the run may load neither JAX nor "
             "the JAX package", 3)
    props = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": cell.chips, "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": props}
    if args.trace:
        from flowbench import trace

        ctx = out["ctx"]
        props["busy_s"] = ctx["busy_s"]
        props["window_s"] = ctx["window_s"]
        result["breakdown"] = {"device_ops": trace.top(ctx["events"]),
                               "idle_gaps": trace.gaps(ctx["events"])}
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in out["checks"]}
    print(json.dumps({"card": card(), "stages_s": out["stages"],
                      "notes": out["notes"]}), file=sys.stderr)
    for name, v, lim in out["checks"]:
        print(f"compared {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
