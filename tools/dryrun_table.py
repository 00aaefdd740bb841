"""The dry run's per-cell JSONs (``python -m repro_torch.launch.dryrun
--all --both-meshes``) as one Markdown table: per device, FLOPs, bytes,
ring wire bytes (its inter-pod share on 2×16×16), argument bytes and the
trace's seconds, a row a (architecture, shape) with both meshes.

    PYTHONPATH=src python3 tools/dryrun_table.py experiments/dryrun_torch

Every cell of ``repro_torch.configs.cells()`` gets its row; a mesh whose
JSON is missing reads "not traced".
"""

import json
import pathlib
import sys


def _cells(out_dir: pathlib.Path) -> dict:
    cells = {}
    for path in sorted(out_dir.glob("*.json")):
        if path.name.endswith(".trace.json"):
            continue
        res = json.loads(path.read_text())
        cells[(res["arch"], res["shape"], res["mesh"])] = res
    return cells


def _entry(res) -> str:
    if res is None:
        return "not traced"
    c = res["cost"]
    inter = c["collective_wire_interpod"]
    wire = f"{c['collective_wire_per_device']:.3e}"
    if inter:
        wire += f" ({inter / c['collective_wire_per_device']:.2g} inter-pod)"
    return (f"{c['flops_per_device']:.3e} / {c['bytes_per_device']:.3e} / "
            f"{wire} / {res['arg_bytes_per_device']:.3e} / "
            f"{res['lower_s']} s")


def main(argv) -> int:
    from repro_torch.configs import cells as all_cells
    cells = _cells(pathlib.Path(argv[0]))
    rows = [(a, s) for a, s, _ in all_cells()]
    print("| arch | shape | 16×16: FLOPs / bytes / wire / args / trace | "
          "2×16×16: the same |")
    print("|---|---|---|---|")
    for arch, shape in rows:
        print(f"| {arch} | {shape} | "
              f"{_entry(cells.get((arch, shape, '16x16')))} | "
              f"{_entry(cells.get((arch, shape, '2x16x16')))} |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
