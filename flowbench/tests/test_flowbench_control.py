"""On the card: each cell's control, the next precision below the one its
configuration states, comes out not correct at the cell's own size on
three seeds (``flowbench.calibrate``'s control reading against the cell's
limits). Run on the card with ``python -m pytest flowbench/tests -m
gpu``."""

from __future__ import annotations

import json
import os

import pytest

from flowbench.spec import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from flowbench import calibrate, check
    from flowbench.spec import Cell

    cell = Cell(name)
    limit = check.limits(name)
    for seed in (101, 2 ** 32 + 7, 3 * 10 ** 9 + 1):
        numbers = calibrate.control(cell, seed, 3, torch.device("cuda", 0))
        assert any(numbers[k] > limit[k] for k in limit), (seed, numbers)
