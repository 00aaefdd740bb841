"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric found by name under perfbench/."""

import json
import pathlib
import re
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import manifest, traffic  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"images_per_s", "batch_latency_p95_ms", "setup_s"} <= e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert _line(m["layer"]) and set(m["workloads"]) <= set(CELLS)
        layers.add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert {m["name"] for m in BENCH["per_layer"]} == {
        "compile_s", "host_ms_per_call", "staging_device_ms_per_kimg",
        "vta_gemm_launches_per_call", "vta_gemm_roofline", "idle_share",
        "mfu"}


def test_configs_and_cells():
    assert {c["name"] for c in BENCH["configs"]} == {"resnet8", "lenet5"}
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/configs/")
        assert manifest.load_json(ROOT / c["file"])["name"] == c["name"]
        assert c["reduced"] == []
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert CELLS == ["resnet8.offline", "lenet5.offline"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = manifest.load_cell(name, ROOT)
    assert callable(cell.program().compile)
    ref = cell.reference()
    assert callable(ref.calibrate) and callable(ref.forward)
    readers = cell.metric_readers()
    assert set(readers) == {m["name"] for m in BENCH["per_layer"]}
    assert all(callable(r.read) for r in readers.values())
    assert cell.traffic["kind"] in traffic.KINDS
    for key in ("trace_calls", "reference_images_per_block", "limits"):
        assert key in cell.workload
    assert [m["name"] for m in cell.end_to_end] == [
        "images_per_s", "batch_latency_p95_ms", "setup_s"]


def test_every_file_under_perfbench_is_named_from_name_characters():
    for path in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
