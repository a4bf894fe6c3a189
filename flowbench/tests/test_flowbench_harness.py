"""The harness on the CPU at a test's size: each cell runs and comes out
correct; a traffic mix, a metric, a kind and a loop added as new files are
found by name, and a name with no file raises; and a run whose timed path
is broken underneath comes out not correct, once for each fault its cell
can have."""

from __future__ import annotations

import hashlib
import json
import os

import pytest

import flowbench.kinds
import flowbench.loops
from flowbench import faults, run
from flowbench.spec import ROOT, Cell

SERVE = ("basic-sintel-serve-c16", "small-kitti-serve-c16")
TRAIN = "basic-chairs-train-b8"
SEED = 2 ** 33 + 12345          # wider than 32 bits, as the driver's are


def measure(root, name, cpu, traced=False, seconds=3):
    return run.measure(Cell(name, root), SEED, seconds, traced, cpu)


@pytest.mark.parametrize("name", SERVE)
def test_serving_cell_is_correct(tiny_root, cpu, name):
    out = measure(tiny_root, name, cpu)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    assert out["metrics"]["pairs_per_s"]["value"] > 0


def test_serving_traced_run_reads_counters(tiny_root, cpu):
    out = measure(tiny_root, SERVE[0], cpu, traced=True)
    assert out["correct"]
    # the CPU has no device trace: only the program's counters read
    assert set(out["metrics"]) == {"sched.occupancy.serve"}
    assert 0 < out["metrics"]["sched.occupancy.serve"]["value"] <= 100


def test_training_cell_is_correct(tiny_root, cpu):
    out = measure(tiny_root, TRAIN, cpu)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert {c[0] for c in out["checks"]} == {"loss_rel", "grad_leaf_rel",
                                             "change_leaf_rel"}


def _tree_digest(path):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        if "__pycache__" in d:
            continue
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_new_mix_and_metric_are_found_by_name(tiny_root, cpu):
    """A cell, its mix, its limits and a per-layer metric added as new
    files and entries: the harness runs the mix and reads the metric, and
    no file of the benchmark changes."""
    before = _tree_digest(os.path.join(ROOT, "flowbench"))
    fb = os.path.join(tiny_root, "flowbench")
    with open(os.path.join(fb, "traffic", "sintel-serve-c16.json")) as f:
        mix = json.load(f)
    mix.update(clients=2, frames=[128, 192])
    with open(os.path.join(fb, "traffic", "dummy-serve-c2.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(fb, "metrics", "dummy.pairs.serve.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['pairs'])\n")
    with open(os.path.join(fb, "limits", "basic-dummy-c2.json"), "w") as f:
        with open(os.path.join(fb, "limits", f"{SERVE[0]}.json")) as g:
            f.write(g.read())
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "basic-dummy-c2",
                               "config": "raft_basic",
                               "traffic": "dummy-serve-c2", "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "pairs_per_s":
            m["workloads"].append("basic-dummy-c2")
    bench["per_layer"].append({"name": "dummy.pairs.serve", "unit": "pairs",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "pairs_per_s",
                               "workloads": ["basic-dummy-c2"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    out = measure(tiny_root, "basic-dummy-c2", cpu, traced=True)
    assert out["correct"]
    assert out["metrics"]["dummy.pairs.serve"]["value"] == out["ctx"]["pairs"]
    assert "sched.occupancy.serve" not in out["metrics"]
    assert _tree_digest(os.path.join(ROOT, "flowbench")) == before


def _set_mix(root, name, **changes):
    path = os.path.join(root, "flowbench", "traffic", f"{name}.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(changes)
    with open(path, "w") as f:
        json.dump(mix, f)


_BURST = """
import time
from flowbench.loops import closed


def offer(load, traffic, seconds, seed):
    t0 = time.perf_counter()
    for _ in range(traffic["burst"]):
        load.send(t0)
    for _ in range(traffic["burst"]):
        load.events.get(timeout=120.0)
    _, _, notes = closed.offer(load, traffic, seconds, seed)
    return t0, time.perf_counter(), dict(notes, burst=traffic["burst"])
"""

_ECHO = """
from flowbench.kinds import serve


def run(cell, seed, seconds, traced, device, t_process, stages):
    out = serve.run(cell, seed, seconds, traced, device, t_process, stages)
    out["notes"]["kind"] = "echo"
    return out
"""


def test_new_kind_and_loop_are_found_by_name(tiny_root, cpu, tmp_path,
                                             monkeypatch):
    """A kind and a loop written as new modules (here in a directory added
    to each package's search path, as a new file of ``flowbench/kinds/``
    and ``flowbench/loops/`` would be) run a mix that names them, with no
    edit to a file of the benchmark."""
    before = _tree_digest(os.path.join(ROOT, "flowbench"))
    for package, name, code in ((flowbench.kinds, "echo", _ECHO),
                                (flowbench.loops, "burst", _BURST)):
        extra = tmp_path / package.__name__.split(".")[-1]
        extra.mkdir()
        (extra / f"{name}.py").write_text(code)
        monkeypatch.setattr(package, "__path__",
                            list(package.__path__) + [str(extra)])
    _set_mix(tiny_root, "sintel-serve-c16", kind="echo", loop="burst",
             burst=3)
    out = measure(tiny_root, SERVE[0], cpu)
    assert out["correct"], out["checks"]
    assert out["notes"]["kind"] == "echo" and out["notes"]["burst"] == 3
    assert out["attempted"] >= 3 + 4
    assert _tree_digest(os.path.join(ROOT, "flowbench")) == before


@pytest.mark.parametrize("key", ["kind", "loop"])
def test_a_name_with_no_module_raises(tiny_root, cpu, key):
    """A mistyped kind or loop is refused before set-up, not run as
    another."""
    _set_mix(tiny_root, "sintel-serve-c16", **{key: "closd"})
    with pytest.raises(ValueError, match="closd"):
        measure(tiny_root, SERVE[0], cpu)


# -- faults under the timed path ---------------------------------------------

@pytest.mark.parametrize("kind", [k for k in faults.KINDS
                                  if k.startswith("serve.")])
def test_serving_fault_is_not_correct(tiny_root, cpu, kind):
    with faults.planted(kind):
        out = measure(tiny_root, SERVE[0], cpu)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", [k for k in faults.KINDS
                                  if k.startswith("train.")])
def test_training_fault_is_not_correct(tiny_root, cpu, kind):
    with faults.planted(kind):
        out = measure(tiny_root, TRAIN, cpu)
    assert not out["correct"], out["checks"]


def test_faults_are_removed_after_the_block(tiny_root, cpu):
    with faults.planted("serve.altered"):
        pass
    assert measure(tiny_root, SERVE[0], cpu)["correct"]
