"""What a decode step's attention moves between ranks, per device, for
every decode cell of the dry run (``decode_32k`` and ``long_500k`` on
16×16 and 2×16×16), counted from the configurations with the dry run's
ring factors (``analysis.op_cost.wire_bytes``):

* ``gather``: the K and V cache brought to each rank's heads over the
  whole sequence, as the decode did before it followed the reference's
  partition — an all-gather over the sequence axes (an all-to-all where
  ``model`` splits the query and the KV heads), K and V, every dense
  layer; ``held``: one layer's gathered K and V, which a rank held at
  once;
* ``combine``: the split-KV decode's own collectives — q gathered over
  ``model`` and three all-reduces over the sequence axes a dense layer
  (the row max, the PV partial, the row sum; float32).

With ``--wire`` the per-device wire bytes of the dry run before the
change (``cell=bytes``, e.g. ``qwen2.5-3b/decode_32k/16x16=9.327e9``), it
prints the prediction ``wire - gather + combine`` beside them.  With
``--before`` and ``--after``, two directories of the dry run's JSONs
(``launch.dryrun --out``) before and after the change, it prints the
measured wire, FLOPs and storage peak (``memory.temp_bytes``) beside the
prediction instead.

    PYTHONPATH=src python3 tools/decode_gather_term.py [--wire ...]
    PYTHONPATH=src python3 tools/decode_gather_term.py --before DIR --after DIR
"""

import argparse
import json
import pathlib
import sys

from repro_torch.analysis.op_cost import wire_bytes
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.models.transformer import stack_layout
from repro_torch.serving.cache import layer_cache_kind

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ELT = 2                                 # the dry run's bf16 cache


def dense_layers(cfg) -> int:
    pattern, reps, tail = stack_layout(cfg)
    kinds = [k for k, _ in pattern] * reps + [k for k, _ in tail]
    return sum(k.startswith("attn") and layer_cache_kind(cfg, k) == "dense"
               for k in kinds)


def terms(arch: str, shape: str, mesh: dict) -> dict:
    cfg = get_config(arch)
    spec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq_len
    seq_all = b == 1
    batch_ranks = 1
    for axis in ("pod", "data"):
        if axis in mesh and b % (batch_ranks * mesh[axis]) == 0:
            batch_ranks *= mesh[axis]
    rows = b // batch_ranks
    tp = mesh["model"]
    seq_dims = [mesh["data"], tp] if seq_all else [tp]
    g = 1
    for n in seq_dims:
        g *= n
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layers = dense_layers(cfg)
    heads_split = h % tp == 0
    kv_split = heads_split and kv % tp == 0
    held = (rows * (kv // tp if kv_split else kv) * s * d * ELT * 2
            if layers else 0)
    kind = "all-to-all" if kv_split and not seq_all else "all-gather"
    gather = layers * wire_bytes(kind, held, g)
    q_gather = (wire_bytes("all-gather", rows * h * d * ELT, tp)
                if heads_split else 0.0)
    reduced = rows * h * (d + 2) * 4       # max, sum: one float a row
    combine = layers * (q_gather + sum(wire_bytes("all-reduce", reduced, n)
                                       for n in seq_dims))
    return {"dense_layers": layers, "rows": rows, "seq_ranks": g,
            "gather": gather, "held": held, "combine": combine}


def _cell_json(out_dir: str, arch: str, shape: str, mesh: str) -> dict:
    path = pathlib.Path(out_dir) / f"{arch}_{shape}_{mesh}.json"
    return json.loads(path.read_text())


def measured(before_dir: str, after_dir: str) -> None:
    """Predicted against measured, a row a cell, both meshes."""
    print("| arch | shape | 16×16: FLOPs; bytes; wire (predicted); storage "
          "peak — before → after | 2×16×16: the same |")
    print("|---|---|---|---|")
    for arch, shape, _ in cells():
        if SHAPES[shape].kind != "decode":
            continue
        row = [arch, shape]
        for name, mesh in MESHES.items():
            t = terms(arch, shape, mesh)
            was, now = (_cell_json(d, arch, shape, name)
                        for d in (before_dir, after_dir))
            c0, c1 = was["cost"], now["cost"]
            wire = c0["collective_wire_per_device"]
            row.append(
                f"{c0['flops_per_device']:.4e} → "
                f"{c1['flops_per_device']:.4e}; "
                f"{c0['bytes_per_device']:.3e} → "
                f"{c1['bytes_per_device']:.3e}; "
                f"{wire:.3e} → {c1['collective_wire_per_device']:.3e} "
                f"({wire - t['gather'] + t['combine']:.3e}); "
                f"{was['memory']['temp_bytes']:.3e} → "
                f"{now['memory']['temp_bytes']:.3e}")
        print("| " + " | ".join(row) + " |")


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wire", nargs="*", default=[],
                    help="arch/shape/mesh=bytes, the wire before the change")
    ap.add_argument("--before", help="the dry run's JSONs before the change")
    ap.add_argument("--after", help="the dry run's JSONs after the change")
    args = ap.parse_args(argv)
    if args.before and args.after:
        measured(args.before, args.after)
        return 0
    before = {}
    for item in args.wire:
        key, val = item.split("=")
        before[key] = float(val)
    print("| arch | shape | mesh | dense layers | rows | gather | held | "
          "combine | wire before | predicted |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for arch, shape, _ in cells():
        if SHAPES[shape].kind != "decode":
            continue
        for name, mesh in MESHES.items():
            t = terms(arch, shape, mesh)
            was = before.get(f"{arch}/{shape}/{name}")
            pred = (f"{was - t['gather'] + t['combine']:.3e}"
                    if was is not None else "")
            print(f"| {arch} | {shape} | {name} | {t['dense_layers']} | "
                  f"{t['rows']} | {t['gather']:.3e} | {t['held']:.3e} | "
                  f"{t['combine']:.3e} | "
                  f"{'' if was is None else f'{was:.3e}'} | {pred} |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
