"""Find a cell's files by name.

``BENCHMARK.json`` at the root names the cells, configurations, traffic
mixes and metrics.  Each sits in a file of its own under ``perfbench/``:

* ``workloads/<cell>.json``   the cell: its configuration, traffic mix,
  chips, why, and the comparison's limits;
* ``configs/<config>.json``   the configuration's published shapes;
* ``traffic/<mix>.json``      the traffic mix's parameters, which
  ``lib/traffic.py`` reads;
* ``programs/<config>.py``    how the port builds the system under test;
* ``reference/<config>.py``   the plain reference;
* ``metrics/<metric>.py``     the reader of one per-layer metric.

A later cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; no file here is edited for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys
from types import ModuleType
from typing import Dict, List

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class ManifestError(ValueError):
    """A name that ``BENCHMARK.json`` or a cell's file does not resolve."""


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path) -> ModuleType:
    """Import the file ``path`` as a module of the package of its folder
    (``perfbench.metrics``, ...), under its stem with every character that
    is not a letter, digit or ``_`` made ``_``: names may hold dots and
    dashes, which an import by name would misread."""
    if not path.is_file():
        raise ManifestError(f"no file {path}")
    name = (f"perfbench.{path.parent.name}."
            + re.sub(r"\W", "_", path.stem))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One cell with everything its name resolves to."""

    name: str
    entry: dict            # the cell's entry in BENCHMARK.json
    workload: dict         # workloads/<cell>.json
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<mix>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    root: pathlib.Path

    @property
    def perfbench(self) -> pathlib.Path:
        return self.root / "perfbench"

    def program(self) -> ModuleType:
        return load_module(self.perfbench / "programs"
                           / f"{self.entry['config']}.py")

    def reference(self) -> ModuleType:
        return load_module(self.perfbench / "reference"
                           / f"{self.entry['config']}.py")

    def metric_readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: load_module(self.perfbench / "metrics"
                                       / f"{m['name']}.py")
                for m in self.per_layer}


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise ManifestError(f"BENCHMARK.json has no cell {name!r}")
    entry = entries[0]
    for key in ("name", "config", "traffic"):
        if not NAME.match(entry[key]):
            raise ManifestError(f"{key} {entry[key]!r} is not a name")
    pb = root / "perfbench"
    workload = load_json(pb / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips", "why"):
        if workload.get(key) != entry[key]:
            raise ManifestError(
                f"workloads/{name}.json's {key} {workload.get(key)!r} is not "
                f"BENCHMARK.json's {entry[key]!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    if entry["config"] not in configs:
        raise ManifestError(f"cell {name!r} names no listed configuration "
                            f"{entry['config']!r}")
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(pb / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name=name, entry=entry, workload=workload, config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                root=root)
