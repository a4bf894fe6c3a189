"""The two readings each of a cell's limits is set from, on the card, for
many seeds in one process (the benchmark's own runs never run this):

- the program's: the cell's own run (a short window at its own load),
  each compared number as the run prints it;
- the control's: the same comparison with the next precision below the
  configuration's in the program's place. Serving states float32 with
  TF32 convolutions, and the program has a bfloat16 path of its own
  (``mixed_precision``, which the configuration's ``serve`` block sets
  false): the control is that path, through the same engine and
  scheduler. Training states bfloat16, and the program has no
  lower path: the control is the reference with every convolution's and
  the correlation's operands rounded to the ``train`` block's ``control``
  (float8 e4m3, scaled per tensor), against the float32 reference.

    python3 -m flowbench.calibrate --workload <cell> --seconds 3 \\
        --seeds 11 12 13 ...

``--sides`` may add faults of ``flowbench.faults``, planted in the
program: a training cell's number is also held against each fault that
reads ten times its program reading or more. Prints one JSON line a seed
and side, and a last line with the largest program reading and each other
side's smallest reading of each number.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import torch

from flowbench import check, faults, frames, run
from flowbench.kinds import train
from flowbench.spec import Cell
from flowbench.weights import make_weights


def control(cell, seed: int, seconds: int, device) -> dict:
    """The control's numbers for one seed."""
    if cell.traffic["kind"] == "serve":
        low = copy.copy(cell)
        low.config = copy.deepcopy(cell.config)
        low.config["serve"]["mixed_precision"] = True
        out = run.measure(low, seed, seconds, False, device)
        return {name: v for name, v, _ in out["checks"]}
    tr = cell.traffic
    weights = make_weights(cell.config["architecture"], seed, device)
    batches = frames.train_batches(tr["batches"], tr["batch"],
                                   tuple(tr["image_size"]), tr["max_flow"],
                                   seed, device)
    ref = train.reference_first(cell, weights, batches, device)
    low = train.reference_first(cell, weights, batches, device,
                                check.rounding(cell.config["train"]
                                               ["control"]))
    return check.train_numbers(low, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=int, default=3)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sides", nargs="+", default=["program", "control"],
                   choices=["program", "control"] + list(faults.KINDS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        run.fail("no CUDA device")
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    most, least = {}, {}
    for seed in args.seeds:
        for side in args.sides:
            if side == "program":
                out = run.measure(cell, seed, args.seconds, False, device)
                numbers = {n: v for n, v, _ in out["checks"]}
                extra = {"metrics": out["metrics"], "notes": out["notes"]}
            elif side in faults.KINDS:
                with faults.planted(side):
                    out = run.measure(cell, seed, args.seconds, False, device)
                numbers = {n: v for n, v, _ in out["checks"]}
                extra = {}
            else:
                numbers, extra = control(cell, seed, args.seconds,
                                         device), {}
            for n, v in numbers.items():
                if side == "program":
                    most[n] = max(most.get(n, 0.0), v)
                else:
                    least.setdefault(side, {})
                    least[side][n] = min(least[side].get(n, float("inf")), v)
            print(json.dumps({"seed": seed, "side": side,
                              "numbers": numbers, **extra}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "program_most": most,
                      "least": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
