"""The readings that the comparison's limits are set from, on the card.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--calls 4] [--out <file.jsonl>]

For each seed, in one process: the cell's set-up at its own size, then
``--calls`` ``serve`` calls over the pool (a short window at the cell's
load), each compared with the plain reference as a run compares them
(the lower reading).  For each control seed, the lower-precision control
(``bits=4``: the reference with every GEMM operand at 4 significant
bits, in the program's place) is compared with the reference on the same
pool (the upper reading).  One JSON line a seed; the benchmark's own runs
never run this.
"""

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench.lib import check, manifest, seeds, traffic

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    cell = manifest.load_cell(args.workload, ROOT)
    cfg, ref = cell.config, cell.reference()
    block = cell.workload["reference_images_per_block"]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        weights = seeds.weights(cfg, seed)
        calib = traffic.calibration_images(cfg, seed)
        program = cell.program().compile(cfg, weights, calib)
        pool = traffic.pool(cfg, cell.traffic, seed)
        outputs = []
        for i in range(args.calls):
            b = i % len(pool)
            logits, _ = program.serve(pool[b], device=dev)
            outputs.append((b, logits.reshape(len(pool[b]), -1)))
        del program
        gc.collect()
        torch.cuda.empty_cache()
        plan = ref.calibrate(cfg, weights, calib)
        refs = [ref.forward(cfg, weights, plan, p, dev, block=block)
                for p in pool]
        row = {"cell": cell.name, "seed": seed,
               "program": check.compare(outputs, refs)}
        if seed in controls:
            lows = [(b, ref.forward(cfg, weights, plan, p, dev, block=block,
                                    bits=4)) for b, p in enumerate(pool)]
            row["control"] = check.compare(lows, refs)
        row["seconds"] = time.perf_counter() - t0
        row["device"] = torch.cuda.get_device_name(dev)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
