"""Find a cell's configuration, traffic mix, per-layer readers and
roofline counts by the names ``BENCHMARK.json`` gives them.

Layout (every path relative to ``portbench/``):

* ``configs/<config>.json``   the configuration as it is run
* ``models/<config>.py``      builds the program and its plain reference
* ``traffic/<traffic>.json``  the mix's parameters, with ``"kind"``
* ``traffic/<kind>.py``       the one generator and driver of that kind
* ``cells/<workload>.json``   the cell's correctness limits and sample
* ``layer_metrics/<metric>.py``  a per-layer metric's reader; the metric's
  last dotted part names its group of cells and is not part of the file
  name (``mfu.train`` is read by ``layer_metrics/mfu.py``)
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]  # portbench/
REPO = ROOT.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by its file path (its names may hold
    dots and dashes, which ``import`` does not take)."""
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path.relative_to(REPO)}")
    name = "portbench_" + re.sub(r"\W", "_", str(path.relative_to(ROOT).with_suffix("")))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


class Cell:
    """One entry of ``workloads`` with everything the harness finds for it."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        w = cells[name]
        self.name, self.chips = name, int(w["chips"])
        self.config_name, self.traffic_name = w["config"], w["traffic"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(REPO / configs[self.config_name]["file"])
        self.mix = load_json(ROOT / "traffic" / f"{self.traffic_name}.json")
        self.params = load_json(ROOT / "cells" / f"{name}.json")
        listed = {w["name"] for w in bench["workloads"]}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", listed)]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", listed)]

    def model(self) -> ModuleType:
        return load_module(ROOT / "models" / f"{self.config_name}.py")

    def kind(self) -> ModuleType:
        return load_module(ROOT / "traffic" / f"{self.mix['kind']}.py")


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: its name without the group."""
    base = metric.rsplit(".", 1)[0] if "." in metric else metric
    return ROOT / "layer_metrics" / f"{base}.py"


def reader(metric: str) -> ModuleType:
    return load_module(reader_path(metric))
