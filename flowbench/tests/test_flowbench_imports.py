"""What the benchmark loads, and that it never runs without a card.

Top-level module names are compared whole: ``raft_tpu_torch`` (the system
under test) is not ``raft_tpu`` (the JAX package, which the benchmark
never loads)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from flowbench.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "raft_tpu"}

_LOAD_ALL = r"""
import glob, json, os, sys
import flowbench.run, flowbench.calibrate, flowbench.sweep
import raft_tpu_torch.serving.engine, raft_tpu_torch.serving.scheduler
import raft_tpu_torch.training.train_step
from flowbench.spec import Cell, find, names
for package in ("kinds", "loops"):
    for name in names(package):
        find(package, name)
bench = json.load(open("BENCHMARK.json"))
for w in bench["workloads"]:
    cell = Cell(w["name"])
    cell.kind
    for m in cell.metrics(True):
        cell.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_LOAD_REFERENCE = r"""
import json, sys
import flowbench.reference.raft, flowbench.reference.train
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    return env


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _modules(_LOAD_ALL)
    assert "raft_tpu_torch" in mods and "flowbench" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _modules(_LOAD_REFERENCE)
    assert not mods & (FORBIDDEN | {"raft_tpu_torch"})


def test_run_without_a_card_fails_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "flowbench.run", "--workload",
         "basic-sintel-serve-c16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's paths
    exits non-zero and prints no result."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in bench["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(_env(), PYTHONPATH=str(tmp_path))
    out = subprocess.run(bench["command"] + [
        "--workload", bench["workloads"][0]["name"], "--seed", "3",
        "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.gpu
def test_run_on_the_card_prints_a_result():
    """On the card: one short run of the first cell prints its result line
    with no forbidden module loaded (run on the card with ``-m gpu``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "flowbench.run", "--workload",
         "basic-sintel-serve-c16", "--seed", "5", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
