"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix, and each per-layer metric. Each lives in a
file of its own, which this module finds by that name alone:

- ``flowbench/configs/<config>.json``: the configuration (its ``file`` in
  ``BENCHMARK.json``);
- ``flowbench/traffic/<traffic>.json``: the traffic mix, parameters only;
  its ``kind`` names the module that runs it, ``flowbench/kinds/<kind>.py``
  (``serve``, ``train``), and a serving mix's ``loop`` the module that
  offers its requests, ``flowbench/loops/<loop>.py`` (``closed``,
  ``poisson``);
- ``flowbench/metrics/<metric>.py``: a per-layer metric's reader, a module
  with ``read(ctx) -> float | None``;
- ``flowbench/limits/<cell>.json``: the limits of the numbers that decide
  ``correct`` (:mod:`flowbench.check`).

A later change adds a cell, a mix, a kind, a loop or a metric as new files
and entries, and edits none of these. A name with no file raises.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import pkgutil
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def names(package: str) -> List[str]:
    """The modules of ``flowbench.<package>`` (``kinds``, ``loops``)."""
    pkg = importlib.import_module(f"flowbench.{package}")
    return sorted(m.name for m in pkgutil.iter_modules(pkg.__path__))


def find(package: str, name: str):
    """The module ``flowbench.<package>.<name>``."""
    found = names(package)
    if name not in found:
        raise ValueError(f"no module {name!r} in flowbench/{package}/: "
                         f"there are {found}")
    return importlib.import_module(f"flowbench.{package}.{name}")


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    metrics, read from the checkout at ``root``."""

    def __init__(self, name: str, root: str = ROOT):
        path = os.path.join(root, "BENCHMARK.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: no BENCHMARK.json")
        with open(path, encoding="utf-8") as f:
            bench = json.load(f)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"workload {name!r} is not in {path}; "
                           f"cells: {sorted(cells)}")
        self.root = root
        self.bench = bench
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        cfg = configs[self.entry["config"]]
        with open(os.path.join(root, cfg["file"]), encoding="utf-8") as f:
            self.config = json.load(f)
        traffic = os.path.join(root, "flowbench", "traffic",
                               f"{self.entry['traffic']}.json")
        with open(traffic, encoding="utf-8") as f:
            self.traffic = json.load(f)
        if self.traffic["kind"] not in names("kinds"):
            raise ValueError(f"{traffic}: no kind {self.traffic['kind']!r} "
                             f"in flowbench/kinds/: there are "
                             f"{names('kinds')}")

    @property
    def kind(self):
        """The module that runs this cell (``flowbench/kinds/<kind>.py``)."""
        return find("kinds", self.traffic["kind"])

    def metrics(self, trace: bool) -> List[Dict]:
        """This cell's metrics of one kind: the end-to-end ones for an
        untraced run, the per-layer ones for a traced run. A metric with
        ``workloads`` belongs to the cells it lists; one without, to every
        cell that reports the end-to-end metric it moves."""
        e2e = [m for m in self.bench["end_to_end"] if self._mine(m)]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def _mine(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        """``flowbench/metrics/<metric>.py``'s ``read``."""
        path = os.path.join(self.root, "flowbench", "metrics",
                            f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"flowbench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
