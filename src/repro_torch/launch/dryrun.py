"""Multi-pod dry run: trace every (architecture × input shape) cell on the
production meshes and extract the roofline terms (port of the
reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell on 512 placeholder host
devices.  Here one process starts a ``fake`` process group of 256 or 512
ranks (``launch.mesh.init_fake``), builds the 16×16 or 2×16×16
``DeviceMesh`` over it, places the cell's parameters, moments, batch and
cache as DTensors whose local shards are empty ``meta`` tensors
(``launch.specs.build_cell``), and runs the sharded step once under
``analysis.op_cost.OpCounter``: rank 0's local ops, as the reference
reads device 0 of its post-SPMD module.  Nothing is allocated and
nothing is compiled.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --jobs 8

``--jobs N`` traces N cells at once, each in a fresh process.

Each cell writes one JSON with the reference's keys to ``--out``
(``experiments/dryrun_torch`` by default, apart from the reference's
``experiments/dryrun``): ``lower_s`` is the trace's time, ``compile_s``
is null (nothing compiles), and so are ``xla_flops_unscaled`` and
``xla_bytes_unscaled`` (there is no XLA cost analysis); ``cost`` holds
``analysis.op_cost.analyze_trace``'s numbers and ``memory`` the argument
bytes and the step's storage peak (an estimate).  ``--save-trace``
writes the counted op list beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config

WHY_NULL = ("the port traces the step op by op: nothing is compiled "
            "(compile_s) and there is no XLA cost analysis "
            "(xla_flops_unscaled, xla_bytes_unscaled); 'cost' holds the "
            "counted per-device numbers")


def apply_variant(arch: str, shape: str, variant: str):
    """§Perf hillclimb variants: config/train-config transforms applied on
    top of the current code.  Comma-separated combos compose."""
    from repro_torch.launch.specs import default_train_config
    cfg = get_config(arch)
    tcfg = default_train_config(arch, SHAPES[shape])
    for v in [v for v in variant.split(",") if v and v != "baseline"]:
        if v == "causal_skip":
            cfg = dataclasses.replace(cfg, causal_skip=True)
        elif v == "remat_dots":
            cfg = dataclasses.replace(cfg, remat="dots")
        elif v.startswith("micro"):
            tcfg = dataclasses.replace(tcfg, microbatches=int(v[5:]))
        elif v.startswith("qchunk"):
            n = int(v[6:])
            cfg = dataclasses.replace(cfg, q_chunk=n, kv_chunk=n)
        else:
            raise ValueError(f"unknown variant {v!r}")
    return cfg, tcfg


def _trace_json(tr) -> list:
    return [dataclasses.asdict(r) for r in tr.records]


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             cfg=None, train_cfg=None,
             save_trace: Optional[pathlib.Path] = None) -> Dict:
    from repro_torch.analysis.op_cost import analyze_trace
    from repro_torch.launch.mesh import init_fake, make_production_mesh
    from repro_torch.launch.specs import build_cell
    n_dev = 512 if multi_pod else 256
    init_fake(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod)
    kw = {"cfg": cfg}
    if train_cfg is not None and SHAPES[shape].kind == "train":
        kw["train_cfg"] = train_cfg
    lowerable = build_cell(arch, shape, mesh, **kw)
    arg_bytes = lowerable.arg_bytes_per_device
    local_args = lowerable.local_arg_bytes()
    tr = lowerable.lower()
    cost = analyze_trace(tr, n_dev)
    if save_trace is not None:
        save_trace.parent.mkdir(parents=True, exist_ok=True)
        save_trace.write_text(json.dumps(_trace_json(tr)))
    return {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n_dev,
        "lower_s": round(tr.seconds, 1), "compile_s": None,
        "xla_flops_unscaled": None, "xla_bytes_unscaled": None,
        "collectives_unscaled": dict(cost["collective_bytes"],
                                     count=cost["collective_count"]),
        "cost": cost,
        "arg_bytes_per_device": arg_bytes,
        "memory": {
            "argument_bytes": local_args,
            "output_bytes": None,
            "temp_bytes": cost["peak_temp_bytes_estimate"],
            "generated_code_bytes": None,
        },
        "null_fields": WHY_NULL,
    }


def _weight(arch: str, shape: str) -> float:
    """A rough cost of tracing a cell, to start the longest first."""
    per_layer = {"train": 2.0, "prefill": 3.0, "decode": 0.1}
    return get_config(arch).n_layers * per_layer[SHAPES[shape].kind]


def _job(arch: str, shape: str, mp: bool, variant: str, out_dir: str,
         save_trace: bool):
    """One cell in a worker process: (tag, result or None, error text)."""
    tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
    if variant != "baseline":
        tag += f"_{variant.replace(',', '+')}"
    try:
        t0 = time.time()
        vcfg, vtcfg = apply_variant(arch, shape, variant)
        res = run_cell(arch, shape, multi_pod=mp, cfg=vcfg, train_cfg=vtcfg,
                       save_trace=(pathlib.Path(out_dir) / f"{tag}.trace.json"
                                   if save_trace else None))
        res["variant"] = variant
        res["cell_s"] = round(time.time() - t0, 1)
        (pathlib.Path(out_dir) / f"{tag}.json").write_text(
            json.dumps(res, indent=1))
        return tag, res, None
    except Exception as e:                  # reported by the caller
        return tag, None, f"{e}\n{traceback.format_exc()}"


def _report(tag: str, res: Optional[Dict], err: Optional[str]) -> bool:
    if res is None:
        print(f"FAIL {tag}: {err}", flush=True)
        return False
    c = res["cost"]
    print(f"OK  {tag}: flops/dev={c['flops_per_device']:.3e} "
          f"bytes/dev={c['bytes_per_device']:.3e} "
          f"wire/dev={c['collective_wire_per_device']:.3e} "
          f"args/dev={res['arg_bytes_per_device']:.3e} "
          f"trace={res['lower_s']}s", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2×16×16 (512 ranks) instead of 16×16")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--save-trace", action="store_true",
                    help="write the counted op list of each cell")
    ap.add_argument("--variant", default="baseline",
                    help="comma-separated §Perf variants: causal_skip, "
                         "remat_dots, microN, qchunkN")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (the longest first)")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        todo = [(a, s) for a, s, skip in cells() if skip is None]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --all")
        todo = [(args.arch, args.shape)]

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    jobs = [(a, s, mp) for a, s in todo for mp in meshes]
    common = (args.variant, str(out_dir), args.save_trace)
    failures = 0
    if args.jobs <= 1:
        for a, s, mp in jobs:
            failures += not _report(*_job(a, s, mp, *common))
        return 1 if failures else 0
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed
    jobs.sort(key=lambda j: -_weight(j[0], j[1]))
    with ProcessPoolExecutor(
            max_workers=args.jobs, max_tasks_per_child=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_job, a, s, mp, *common) for a, s, mp in jobs]
        for fut in as_completed(futures):
            failures += not _report(*fut.result())
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
