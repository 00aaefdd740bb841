"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric found by name under perfbench/.

The checks hold every entry to the contract and the accepted entries to
staying there; none pins what else there may be, so a later configuration,
cell or metric joins with new files and entries alone.  Each check is a
function of a benchmark and the root it lies in, run here on the
repository's and, in the last tests, on a copy with entries added and on
copies broken one way each."""

import copy
import json
import pathlib
import re
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import manifest, traffic  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# a width may never be cut: a size, a key ending in _dim or _rank, a head
# size, an expansion factor, the experts a token takes; in a CNN's file a
# layer's channels (in, out), kernel, stride and resolution, and the input
WIDTH = re.compile(r"(_dim|_rank|_size)$|^d_|^(num_experts_per_tok|moe_topk|"
                   r"expand|expansion_factor|mlp_ratio|in|out|k|stride|hw|"
                   r"input|shape|channels|resolution)$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]

# what accepted PRs put in, which stays
CONFIGS = {"resnet8", "lenet5"}
OFFLINE = ["resnet8.offline", "lenet5.offline"]
OFFLINE_E2E = ["images_per_s", "batch_latency_p95_ms", "setup_s"]
PER_LAYER = {"compile_s", "host_ms_per_call", "staging_device_ms_per_kimg",
             "vta_gemm_launches_per_call", "vta_gemm_roofline", "idle_share",
             "mfu"}


def _widths(value) -> list:
    """The width keys anywhere inside a value of a configuration's file: a
    cut may not name a group that holds one (a CNN's ``layers`` or
    ``input``), since no source file here says what its widths were; a
    cut in depth names a key that holds none (a list of block counts)."""
    if isinstance(value, dict):
        return [k for k in value if WIDTH.search(k)] + [
            w for v in value.values() for w in _widths(v)]
    if isinstance(value, list):
        return [w for v in value for w in _widths(v)]
    return []


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _reported(bench: dict, cell: str) -> list:
    return [m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def check_top_level(bench: dict, root: pathlib.Path) -> None:
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert (root / bench["command"][1]).is_file()
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def check_run_seconds(bench: dict, root: pathlib.Path) -> None:
    s = bench["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def check_names(bench: dict, root: pathlib.Path, kind: str) -> None:
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def check_metric_entries(bench: dict, root: pathlib.Path) -> None:
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert set(OFFLINE_E2E) <= e2e and 1 <= len(e2e) <= 16
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    assert next(m for m in bench["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        listed = m.get("workloads", [])
        assert _line(m["layer"]) and set(listed) <= set(cells)
        # each listed cell reports the end-to-end metric this one moves
        assert all(m["moves"] in _reported(bench, c) for c in listed)
        assert (root / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert PER_LAYER <= {m["name"] for m in bench["per_layer"]}


def check_configs_and_cells(bench: dict, root: pathlib.Path) -> None:
    cells = [w["name"] for w in bench["workloads"]]
    assert CONFIGS <= {c["name"] for c in bench["configs"]}
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/configs/")
        config = manifest.load_json(root / c["file"])
        assert config["name"] == c["name"]
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert isinstance(key, str) and NAME.match(key) and key in config
            assert not WIDTH.search(key) and not _widths(config[key]), key
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    configs = {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(cells) <= 24 and cells[:len(OFFLINE)] == OFFLINE
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        e2e = _reported(bench, w["name"])
        assert {"setup_s", "images_per_s"} <= set(e2e)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
    for name in OFFLINE:
        assert _reported(bench, name) == OFFLINE_E2E


def check_cell(bench: dict, root: pathlib.Path, name: str) -> None:
    cell = manifest.load_cell(name, root)
    assert callable(cell.program().compile)
    ref = cell.reference()
    assert callable(ref.calibrate) and callable(ref.forward)
    readers = cell.metric_readers()
    assert set(readers) == {m["name"] for m in bench["per_layer"]
                            if manifest._applies(m, name, set(
                                _reported(bench, name)))}
    assert readers and all(callable(r.read) for r in readers.values())
    assert cell.traffic["kind"] in traffic.KINDS
    traced = "trace_s" if cell.traffic["kind"] == "server" else "trace_calls"
    for key in (traced, "reference_images_per_block", "limits"):
        assert key in cell.workload
    assert [m["name"] for m in cell.end_to_end] == _reported(bench, name)


def failures(bench: dict, root: pathlib.Path) -> list:
    """The names of the checks that ``bench`` (written at ``root``) fails."""
    checks = [("top_level", check_top_level, ()),
              ("run_seconds", check_run_seconds, ())]
    checks += [("names", check_names, (k,)) for k in
               ("configs", "workloads", "end_to_end", "per_layer")]
    checks += [("metric_entries", check_metric_entries, ()),
               ("configs_and_cells", check_configs_and_cells, ())]
    checks += [("cell", check_cell, (w["name"],))
               for w in bench["workloads"]]
    out = []
    for name, check, args in checks:
        try:
            check(bench, root, *args)
        except (AssertionError, KeyError, StopIteration,
                manifest.ManifestError, FileNotFoundError):
            out.append(name)
    return out


def test_top_level_keys_and_command():
    check_top_level(BENCH, ROOT)


def test_run_seconds_fits_the_check_with_24_cells():
    check_run_seconds(BENCH, ROOT)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    check_names(BENCH, ROOT, kind)


def test_metric_entries():
    check_metric_entries(BENCH, ROOT)


def test_configs_and_cells():
    check_configs_and_cells(BENCH, ROOT)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    check_cell(BENCH, ROOT, name)


def test_every_file_under_perfbench_is_named_from_name_characters():
    for path in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def _copy(tmp_path: pathlib.Path) -> dict:
    """BENCHMARK.json and perfbench/ copied to ``tmp_path``; the copy's
    files and their bytes."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}


def _write(root: pathlib.Path, rel: str, obj) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


def _grow(root: pathlib.Path, bench: dict) -> dict:
    """Add, as new files and entries, a configuration that cuts one key, a
    four-chip cell of it and a per-layer metric read in that cell."""
    config = json.loads((root / "perfbench/configs/resnet8.json").read_text())
    config["name"] = "resnet8_cal4"
    config["calibration"] = dict(config["calibration"], images=4)
    _write(root, "perfbench/configs/resnet8_cal4.json", config)
    for part in ("programs", "reference"):
        _write(root, f"perfbench/{part}/resnet8_cal4.py", (
            root / f"perfbench/{part}/resnet8.py").read_text())
    bench["configs"].append({
        "name": "resnet8_cal4", "source": bench["configs"][0]["source"],
        "file": "perfbench/configs/resnet8_cal4.json",
        "reduced": ["calibration"],
        "why": "resnet8 calibrated on 4 images, not 8"})
    entry = {"name": "resnet8_cal4.offline4", "config": "resnet8_cal4",
             "traffic": "offline_8192", "chips": 4,
             "why": "one offline stream a card, four cards"}
    work = json.loads(
        (root / "perfbench/workloads/resnet8.offline.json").read_text())
    work.update({k: v for k, v in entry.items() if k != "name"})
    _write(root, "perfbench/workloads/resnet8_cal4.offline4.json", work)
    bench["workloads"].append(entry)
    _write(root, "perfbench/metrics/calls_per_window.py",
           "def read(rec):\n    return rec['window']['calls']\n")
    bench["per_layer"].append({
        "name": "calls_per_window", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "entry point",
        "moves": "images_per_s", "workloads": ["resnet8_cal4.offline4"]})
    _write(root, "BENCHMARK.json", json.dumps(bench))
    return bench


def test_a_configuration_cell_and_metric_join_as_new_files(tmp_path):
    before = _copy(tmp_path)
    bench = _grow(tmp_path, copy.deepcopy(BENCH))
    assert failures(bench, tmp_path) == []
    cell = manifest.load_cell("resnet8_cal4.offline4", tmp_path)
    assert cell.config["calibration"]["images"] == 4
    assert "calls_per_window" in cell.metric_readers()
    # nothing that was there is edited, BENCHMARK.json aside
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data, path


def _drop_cell(bench, name):
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != name]


def _more_four_chip_cells(bench):
    """Five cells, two of them on four chips: one is the most allowed."""
    for w in list(bench["workloads"]):
        if len(bench["workloads"]) < 5:
            bench["workloads"].append(dict(
                w, name=w["name"] + "_b", traffic=w["traffic"] + "_b"))
    bench["workloads"][-1]["chips"] = 4


def _width_cut(bench, root):
    config = json.loads((root / "perfbench/configs/resnet8_cal4.json")
                        .read_text())
    config["hidden_size"] = 32
    _write(root, "perfbench/configs/resnet8_cal4.json", config)
    bench["configs"][-1]["reduced"].append("hidden_size")


def _cnn_cut(bench, root, key):
    """The grown configuration's last layer narrowed (``layers``) or its
    input made smaller (``input``), with ``key`` listed as cut."""
    config = json.loads((root / "perfbench/configs/resnet8_cal4.json")
                        .read_text())
    if key == "layers":
        config["layers"][-1]["out"] = 8
    else:
        config["input"]["shape"] = [3, 16, 16]
    _write(root, "perfbench/configs/resnet8_cal4.json", config)
    bench["configs"][-1]["reduced"].append(key)


BROKEN = {
    # case: (how the grown copy is broken, the check that refuses it)
    "cell_names_no_listed_configuration": (
        lambda b, r: b["workloads"][-1].update(config="resnet9"),
        "configs_and_cells"),
    "a_second_four_chip_cell_among_five": (
        lambda b, r: _more_four_chip_cells(b), "configs_and_cells"),
    "chips_neither_1_nor_4": (
        lambda b, r: b["workloads"][-1].update(chips=2), "configs_and_cells"),
    "reduced_names_no_key_of_the_file": (
        lambda b, r: b["configs"][-1]["reduced"].append("depth"),
        "configs_and_cells"),
    "reduced_names_a_width": (_width_cut, "configs_and_cells"),
    "reduced_names_the_layers_a_cnn_width_lives_in": (
        lambda b, r: _cnn_cut(b, r, "layers"), "configs_and_cells"),
    "reduced_names_the_input_shape": (
        lambda b, r: _cnn_cut(b, r, "input"), "configs_and_cells"),
    "reduced_key_on_two_lines": (
        lambda b, r: b["configs"][-1]["reduced"].append("cal\nibration"),
        "configs_and_cells"),
    "an_accepted_cell_removed": (
        lambda b, r: _drop_cell(b, "lenet5.offline"), "configs_and_cells"),
    "the_accepted_cells_reordered": (
        lambda b, r: b["workloads"].insert(0, b["workloads"].pop(1)),
        "configs_and_cells"),
    "an_accepted_configuration_removed": (
        lambda b, r: (b["configs"].pop(1), _drop_cell(b, "lenet5.offline")),
        "configs_and_cells"),
    "a_configuration_no_cell_uses": (
        lambda b, r: b["workloads"][-1].update(config="resnet8",
                                                traffic="offline_4096"),
        "configs_and_cells"),
    "config_file_of_another_name": (
        lambda b, r: b["configs"][-1].update(
            file="perfbench/configs/resnet8.json"), "configs_and_cells"),
    "an_offline_cell_reports_another_metric": (
        lambda b, r: b["end_to_end"].append(
            {"name": "extra_ms", "unit": "ms", "better": "lower",
             "bound": 0.05, "source": "host_clock"}),
        "configs_and_cells"),
    "an_accepted_per_layer_metric_removed": (
        lambda b, r: b["per_layer"].pop(0), "metric_entries"),
    "a_per_layer_metric_without_its_reader": (
        lambda b, r: b["per_layer"][-1].update(name="calls_a_window"),
        "metric_entries"),
    "a_per_layer_metric_in_a_cell_without_what_it_moves": (
        lambda b, r: b["per_layer"][-1].update(moves="latency_p95_ms"),
        "metric_entries"),
    "a_cell_without_images_per_s": (
        lambda b, r: next(m for m in b["end_to_end"]
                          if m["name"] == "images_per_s").update(
            workloads=["resnet8.offline", "lenet5.offline"]),
        "configs_and_cells"),
    "a_cell_with_no_workload_file": (
        lambda b, r: b["workloads"][-1].update(name="resnet8_cal4.other"),
        "cell"),
    "two_cells_of_one_name": (
        lambda b, r: b["workloads"].append(dict(b["workloads"][0])),
        "names"),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_the_contract_checks_refuse(case, tmp_path):
    _copy(tmp_path)
    bench = _grow(tmp_path, copy.deepcopy(BENCH))
    breaking, check = BROKEN[case]
    breaking(bench, tmp_path)
    _write(tmp_path, "BENCHMARK.json", json.dumps(bench))
    assert check in failures(bench, tmp_path)


def test_the_server_cell_joins_by_its_entries_alone(server_root):
    """``resnet8.server``'s files are in the repository already; its
    entries (``server_cell.json``) pass every check, no file added."""
    bench = json.loads((server_root / "BENCHMARK.json").read_text())
    assert "resnet8.server" in [w["name"] for w in bench["workloads"]]
    assert failures(bench, server_root) == []
    files = lambda root: {p.relative_to(root) for p in
                          (root / "perfbench").rglob("*") if p.is_file()
                          and "__pycache__" not in p.parts}
    assert files(server_root) == files(ROOT)
