"""Fixtures of the benchmark's CPU tests: a checkout-shaped directory whose
``BENCHMARK.json``, configurations, traffic mixes, metrics and limits are
the benchmark's own, with each cell cut to a size a CPU test can run."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from flowbench.spec import ROOT, find

#: the mixes at a CPU test's size: frames and clients, the training batch
#: and shape, and the recurrence's iterations
TINY = {
    "serve": {"frames": [128, 256], "clients": 4},
    "train": {"batch": 2, "image_size": [128, 160], "iters": 2},
}
#: the kinds' constants at a CPU test's size: the pool and the sample of
#: serving, and the traced slices
TINY_CONSTANTS = {
    "serve": {"POOL": 8, "SAMPLE": 4, "TRACE_SECONDS": 1},
    "train": {"TRACE_STEPS": 2},
}


def copy_root(dst: str, iters: int = 2, mixed_precision: bool = False) -> str:
    """The benchmark's data files under ``dst``, cut to :data:`TINY`.
    Training runs in float32 here (``mixed_precision``) unless asked: the
    CPU's bfloat16 convolutions are not the card's."""
    os.makedirs(os.path.join(dst, "flowbench"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for d in ("configs", "metrics", "limits", "traffic"):
        shutil.copytree(os.path.join(ROOT, "flowbench", d),
                        os.path.join(dst, "flowbench", d))
    for name in os.listdir(os.path.join(dst, "flowbench", "configs")):
        path = os.path.join(dst, "flowbench", "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["serve"]["iters"] = iters
        if "train" in cfg:
            cfg["train"]["mixed_precision"] = mixed_precision
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(dst, "flowbench", "traffic")):
        path = os.path.join(dst, "flowbench", "traffic", name)
        with open(path) as f:
            tr = json.load(f)
        tr.update(TINY[tr["kind"]])
        if tr["kind"] == "serve" and tr["loop"] == "poisson":
            tr["rate"] = 4.0
        with open(path, "w") as f:
            json.dump(tr, f)
    return dst


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    torch.manual_seed(0)
    for kind, constants in TINY_CONSTANTS.items():
        module = find("kinds", kind)
        for name, value in constants.items():
            monkeypatch.setattr(module, name, value)
    return copy_root(str(tmp_path / "checkout"))


@pytest.fixture
def cpu():
    return torch.device("cpu")
