"""The cell ``resnet8.server`` as a later PR would add it: its files are
under ``perfbench/`` already, its ``BENCHMARK.json`` entries in
``server_cell.json`` beside this file, and ``server_root`` is a copy of
the benchmark with those entries added (no file edited)."""

import json
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def add_server_cell(bench: dict) -> dict:
    """``bench`` with the entries of ``server_cell.json`` added."""
    entries = json.loads((pathlib.Path(__file__).parent
                          / "server_cell.json").read_text())
    for kind in ("workloads", "end_to_end", "per_layer"):
        bench[kind] = bench[kind] + entries[kind]
    for m in bench["per_layer"]:
        if m["name"] in entries["also_in"]:
            m["workloads"] = m["workloads"] + ["resnet8.server"]
    return bench


@pytest.fixture(scope="session")
def server_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("server_root")
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = add_server_cell(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
