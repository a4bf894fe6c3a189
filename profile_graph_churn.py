#!/usr/bin/env python3
"""Serving graphs freed while another engine replays, on one CUDA card.

    python3 profile_graph_churn.py              # every cell, a process each
    python3 profile_graph_churn.py --cell live_profiled --rounds 50

Two serving engines share a process (the small model at random seeded
weights, one bucket (2, 96, 128), iters 2, uint8 wire). Engine A replays
its bucket graph in a loop on a thread of its own; each flow it returns must
be bitwise the first. At the same time the main thread, ``--rounds`` times:
dispatches on engine B without waiting, drops B's bucket with
``drop_bucket`` while that replay may still run, rebuilds the bucket by a
dispatch, then waits for the first; dispatches again without waiting,
drops engine B whole, collects garbage, builds B again, then waits. Every
flow B returns must be within 1e-5 px of A's first flow (the same weights
and inputs): memory the dropped program or engine held, reused by the
rebuild while the replay still read it, would show there.

The cells (``CELLS``) vary three things:

- ``profiled``: ``torch.profiler`` (CUDA activity) traces each round;
- ``store``: B's program is loaded from the program store
  (``serving/aot.py``; the first build exports and stores it) instead of
  captured from the live module;
- ``cached``: the store's loads come from an in-process cache of
  deserialized programs, one ``ExportedProgram`` shared by every B.

Each cell runs in a process of its own with ``faulthandler`` on, so a
segmentation fault prints every thread's stack and ends only that cell,
and so does a round that takes over ``ROUND_TIMEOUT_S`` (a hang).
The parent prints one line per cell (its exit code, seconds, rounds, A's
replays and the last lines of its errors) and one JSON object last. It
exits 0 whatever the cells did: the card test
``tests/test_torch_kernels_gpu.py::test_graph_churn_cell`` holds each cell.
``--device cpu`` rehearses the control flow (the programs run eagerly).
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

CELLS = ("live", "store", "live_profiled", "store_profiled",
         "store_cached", "store_cached_profiled")
BUCKET = (2, 96, 128)
ITERS = 2
TOL = 1e-5          # px, a loaded program's replay against the live one
CELL_TIMEOUT_S = 900
ROUND_TIMEOUT_S = 120   # a round over this is a hang: every stack, exit 1


class _MemoStore:
    """The program store with an in-process cache of deserialized
    programs in front of its loads: every engine gets one shared
    ``ExportedProgram`` for a key."""

    def __init__(self, store):
        self._store = store
        self._memo = {}

    def load(self, key):
        from raft_tpu_torch.serving.aot import key_digest

        d = key_digest(key)
        if self._memo.get(d) is None:
            self._memo[d] = self._store.load(key)
        return self._memo[d]

    def __getattr__(self, name):
        return getattr(self._store, name)


def _frames():
    rng = np.random.RandomState(0)
    b, h, w = BUCKET
    i1 = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    return i1, np.roll(i1, (2, 3), axis=(1, 2))


def run_cell(cell: str, rounds: int, device: str) -> dict:
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import RAFTEngine
    from raft_tpu_torch.serving.aot import AOTCache

    faulthandler.enable(all_threads=True)
    cfg = RAFTConfig(small=True, corr_impl="pallas")
    weights = RAFT(cfg, torch.Generator().manual_seed(0)).state_dict()
    kw = dict(iters=ITERS, envelope=[BUCKET], wire="u8", device=device)
    i1, i2 = _frames()
    tmp = tempfile.mkdtemp(prefix="graph_churn_")
    store = None
    if "store" in cell:
        store = AOTCache(os.path.join(tmp, "store"))
        if "cached" in cell:
            store = _MemoStore(store)

    def engine_b():
        return RAFTEngine(weights, cfg, aot_cache=store, **kw)

    a = RAFTEngine(weights, cfg, **kw)
    want = a.infer_batch(i1, i2)
    stop = threading.Event()
    errors, replays = [], [0]

    def lane():
        try:
            while not stop.is_set():
                got = a.infer_batch(i1, i2)
                if not np.array_equal(got, want):
                    raise AssertionError(
                        "engine A's replay moved by "
                        f"{float(np.abs(got - want).max())} px")
                replays[0] += 1
        except BaseException as e:  # noqa: BLE001 — reported by the cell
            errors.append(repr(e))

    def hold(flow, what):
        gap = float(np.abs(flow - want).max())
        if gap > TOL:
            errors.append(f"round {r}: {what} {gap} px from A's")

    prof_ctx = None
    if "profiled" in cell:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA if device != "cpu"
                else ProfilerActivity.CPU]
        prof_ctx = lambda: profile(activities=acts)  # noqa: E731
    b = engine_b()
    thread = threading.Thread(target=lane, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    r = -1
    for r in range(rounds):
        if errors:
            break
        faulthandler.dump_traceback_later(ROUND_TIMEOUT_S, exit=True)
        ctx = prof_ctx() if prof_ctx else None
        if ctx is not None:
            ctx.__enter__()
        # each drop comes while B's replay may still run, and the rebuild
        # allocates on this thread's stream before that replay is waited for
        pend = b.infer_batch_async(i1, i2)
        b.drop_bucket(BUCKET)
        hold(b.infer_batch(i1, i2), "the rebuilt bucket")
        hold(pend.fetch(), "a replay its bucket's drop raced")
        pend = b.infer_batch_async(i1, i2)
        del b
        gc.collect()
        b = engine_b()
        hold(pend.fetch(), "a replay its engine's drop raced")
        if ctx is not None:
            ctx.__exit__(None, None, None)
    faulthandler.cancel_dump_traceback_later()
    stop.set()
    thread.join(60)
    if thread.is_alive():
        errors.append("engine A's lane did not stop")
    stats = b.aot_stats()
    return {"cell": cell, "ok": not errors, "errors": errors[:5],
            "rounds": r + 1, "a_replays": replays[0],
            "seconds": time.perf_counter() - t0,
            "b_aot_hits": stats["aot_hits"], "b_captures": stats["captures"]}


def run_all(rounds: int, device: str, cells=CELLS) -> list:
    """Each cell in a process of its own: its exit code, seconds, its
    result line and the last lines of its errors (a fault's stacks)."""
    out = []
    for cell in cells:
        t0 = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--cell", cell,
                 "--rounds", str(rounds), "--device", device],
                capture_output=True, text=True, timeout=CELL_TIMEOUT_S)
            rc, so, se = r.returncode, r.stdout, r.stderr
        except subprocess.TimeoutExpired as e:
            rc, so, se = "timeout", e.stdout or "", e.stderr or ""
            so = so.decode() if isinstance(so, bytes) else so
            se = se.decode() if isinstance(se, bytes) else se
        lines = [ln for ln in so.splitlines() if ln.startswith("{")]
        res = json.loads(lines[-1]) if lines else {"cell": cell, "ok": False}
        res.update(rc=rc, wall_s=time.perf_counter() - t0,
                   stderr_tail=se.splitlines()[-40:] if rc != 0 else [])
        print(f"[churn] {cell}: rc {rc}, ok {res['ok']}, "
              f"{res.get('rounds')} rounds, A replayed "
              f"{res.get('a_replays')} times, {res['wall_s']:.1f} s",
              flush=True)
        if rc != 0:
            print("\n".join(res["stderr_tail"]), flush=True)
        out.append(res)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cell", choices=CELLS)
    p.add_argument("--cells", nargs="+", choices=CELLS, default=CELLS,
                   help="the cells of a run of all")
    p.add_argument("--rounds", type=int, default=50)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.cell:
        res = run_cell(args.cell, args.rounds, args.device)
        print(json.dumps(res), flush=True)
        return 0 if res["ok"] else 1
    res = run_all(args.rounds, args.device, args.cells)
    print(json.dumps({"graph_churn": res, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
