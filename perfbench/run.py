"""Run one cell of the port's benchmark once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``;
its files are found by name (``lib/manifest.py``) and the run is
``lib/harness.py``'s.  The last line of standard output is the result, one
JSON object; the lines before it on standard error show each number the
comparison with the plain reference read, beside its limit.

Exits 3 without a result where no CUDA card is present or fewer than the
cell asks for, and 4 where, once the window has closed, the process holds
a module of the JAX package or of JAX itself (top-level names compared
whole: ``repro_torch`` is not ``repro``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list:
    """Top-level names of ``sys.modules`` that belong to JAX or the JAX
    package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every cache the run writes lies at a fixed path inside the checkout
    # (the port's kernels build into build/repro_torch/ by themselves)
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench.lib import harness, manifest

    cell = manifest.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{args.workload} needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    result, lines = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
        t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark drives the port "
              f"alone", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
