"""The readings a GMA cell's limit is set from, on the card, for many seeds
in one process (the benchmark's own runs never run this); the GMA
counterpart of ``flowbench.calibrate``, whose control knows the ``serve``
and ``train`` kinds alone.

- ``program``: the cell's own run (a short window at its own load), each
  compared number as the run prints it;
- ``control``: the same run through the program's bfloat16 path
  (``mixed_precision``, which the configuration's ``serve`` block sets
  false), through the same engine and scheduler;
- ``reference_bf16``: the reference with every convolution's, the
  correlation's and the attention's operands rounded to bfloat16, against
  the float32 reference, on the first :data:`REFERENCE_PAIRS` pairs the
  run's requests draw (the next precision below the configuration's,
  computed by the reference itself);
- the faults of ``flowbench.faults_gma``, planted in the program.

    python3 -m flowbench.calibrate_gma --workload gma-1080p-serve-c8 \\
        --seconds 3 --seeds 11 12 13 ... --sides program

Prints one JSON line a seed and side, and a last line with the largest
program reading and each other side's smallest reading of each number.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np
import torch

from flowbench import check, faults_gma, frames, run
from flowbench.kinds import serve, serve_gma
from flowbench.spec import Cell
from flowbench.weights import derive_seed
from flowbench.weights_gma import make_weights

SIDES = ("program", "control", "reference_bf16") + faults_gma.KINDS
#: the pairs the reference's own control compares
REFERENCE_PAIRS = 4


def numbers(out: dict) -> dict:
    """A run's compared numbers, its worst pair's distance and that pair's
    ratio to the witness."""
    found = {name: v for name, v, _ in out["checks"]}
    for name in ("worst_pair_epe_px", "worst_pair_over_witness"):
        found[name] = out["notes"][name]
    return found


def control(cell, seed: int, seconds: int, device) -> dict:
    """The program's bfloat16 path: the cell's run with the configuration's
    ``mixed_precision`` on."""
    low = copy.copy(cell)
    low.config = copy.deepcopy(cell.config)
    low.config["serve"]["mixed_precision"] = True
    return numbers(run.measure(low, seed, seconds, False, device))


def reference_bf16(cell, seed: int, device) -> dict:
    """The reference in bfloat16 against the reference in float32, on the
    pairs a run with ``seed`` sends first, and over the witness (the
    reference with TF32 convolutions) on the same pairs."""
    weights = make_weights(cell.config["architecture"], seed, device)
    pool = frames.serve_pool(frames.sintel_frames(),
                             tuple(cell.traffic["frames"]), serve.POOL,
                             seed, device)
    order = np.random.default_rng(derive_seed(seed, 3)).integers(
        0, len(pool), size=REFERENCE_PAIRS)
    pairs = [pool[i] for i in order]
    want = serve_gma.reference_flows(cell, weights, pairs, device)
    low = serve_gma.reference_flows(cell, weights, pairs, device,
                                    check.rounding("bfloat16"))
    witness = serve_gma.reference_flows(cell, weights, pairs, device,
                                        conv_quantize=serve_gma.tf32)
    return {"worst_pair_epe_px": max(check.epe(a, b)
                                     for a, b in zip(low, want)),
            "epe_over_witness": serve_gma.witness_ratio(low, want, witness),
            "worst_pair_over_witness": serve_gma.worst_pair_ratio(
                low, want, witness)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=int, default=3)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sides", nargs="+", default=["program", "control"],
                   choices=SIDES)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        run.fail("no CUDA device")
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    most, least = {}, {}
    for seed in args.seeds:
        for side in args.sides:
            extra = {}
            if side == "program":
                out = run.measure(cell, seed, args.seconds, False, device)
                found = numbers(out)
                extra = {"metrics": out["metrics"], "notes": out["notes"],
                         "peak_bytes": out["peak_bytes"]}
            elif side in faults_gma.KINDS:
                with faults_gma.planted(side):
                    out = run.measure(cell, seed, args.seconds, False, device)
                found = numbers(out)
            elif side == "control":
                found = control(cell, seed, args.seconds, device)
            else:
                found = reference_bf16(cell, seed, device)
            for n, v in found.items():
                if side == "program":
                    most[n] = max(most.get(n, 0.0), v)
                else:
                    least.setdefault(side, {})
                    least[side][n] = min(least[side].get(n, float("inf")), v)
            print(json.dumps({"seed": seed, "side": side,
                              "numbers": found, **extra}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "program_most": most,
                      "least": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
