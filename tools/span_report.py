#!/usr/bin/env python3
"""Where a benchmark cell's ``serve`` call spends the card's time, by the
port's own spans.

    python3 tools/span_report.py --cell resnet8.offline [--src PATH]
        [--seed N] [--calls 6] [--label NAME] [--out FILE] [--chrome FILE]

Builds the cell's network, traffic and seeded weights as the benchmark
does (``perfbench/``), with the ``repro_torch`` package under ``--src``
(default: this checkout's ``src``), warms a call on each pool batch, times
``--calls`` untraced calls on the host clock (each ends in the logits'
synchronising copy), then serves ``--calls`` more under ``torch.profiler``
and prints:

* the device operations by name (the outermost host op that launched
  them and the kernel): their count over the traced calls and ms a call;
* ``host_ms_per_call`` and ``staging_device_ms_per_kimg`` as the
  benchmark reads them;
* the ten longest idle gaps, each named by the innermost
  ``repro_torch.`` span (where the port has them) and the innermost host
  operation open on the host at its middle;
* where the port has spans (``repro_torch.tracing``): device ms a call
  by layer and leaf span (CUDA events), the seven span metrics
  (``tools/span_metrics.py``), each leaf kind's device time summed from
  the operations it launched beside its event time, the device
  operations by name and launching span, and the operations launched in
  a ``serve`` call outside any leaf span.

Prints the card's name and power limit, and as its last line one JSON
object; ``--out`` appends that object to a file, and ``--chrome`` keeps
the profiler's Chrome trace (and the span log beside it, as
``FILE.spans.json``).  A tree without the spans
(an older checkout under ``--src``) gets the first three parts, so two
trees can be compared on one card, alternating:

    for t in A B B A; do python3 tools/span_report.py --cell C --src $t/src --label $t; done
"""

import argparse
import collections
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
LEAVES = ("repro_torch.serve.input", "repro_torch.serve.stack",
          "repro_torch.layer.stage", "repro_torch.layer.decode",
          "repro_torch.layer.gemm", "repro_torch.layer.epilogue",
          "repro_torch.layer.encode", "repro_torch.layer.unpack",
          "repro_torch.serve.output")


def card(torch) -> dict:
    info = {"name": torch.cuda.get_device_name(0), "torch": torch.__version__}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def idle_gaps(tr: dict, events: list, trace, top: int = 10) -> list:
    """The ``top`` longest stretches of the traced window with no device
    operation: ``[ms, innermost repro_torch span at the middle, innermost
    host op there]``."""
    lo, hi = trace.window(tr)
    busy = trace.union(trace.clip([d[1:3] for d in tr["device"]], lo, hi))
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    marks = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("repro_torch.")]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        inner = lambda xs: min((x for x in xs if x[-3] <= mid <= x[-2]),
                               key=lambda x: x[-2] - x[-3], default=None)
        span = inner(marks)
        host = inner([(h[1], h[2], h[0]) for h in tr["host"]])
        out.append([(b - a) / 1e3, span[2] if span else None,
                    host[2] if host else None])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=2_718_281_828)
    ap.add_argument("--calls", type=int, default=6)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default=None)
    ap.add_argument("--chrome", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(pathlib.Path(args.src).resolve()), str(ROOT),
                    str(ROOT / "tools")]
    import torch
    if not torch.cuda.is_available():
        print("span_report: no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, record_function
    from perfbench.lib import manifest, seeds, trace, traffic
    import span_metrics
    dev = torch.device("cuda:0")
    cell = manifest.load_cell(args.cell, ROOT)
    cfg = cell.config
    program = cell.program().compile(cfg, seeds.weights(cfg, args.seed),
                                     traffic.calibration_images(
                                         cfg, args.seed))
    pool = traffic.pool(cfg, cell.traffic, args.seed, None)
    batch = len(pool[0])
    serve = lambda i: program.serve(pool[i % len(pool)], device=dev)
    for i in range(len(pool)):
        serve(i)
    untraced = []
    for i in range(args.calls):
        t = time.perf_counter()
        serve(i)
        untraced.append((time.perf_counter() - t) * 1e3)

    try:
        from repro_torch import tracing
        tracing.clear()
    except ImportError:
        tracing = None
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for i in range(args.calls):
            with record_function(trace.SPAN):
                serve(i)
    with tempfile.TemporaryDirectory() as d:
        path = args.chrome or os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    if args.chrome and tracing is not None:
        with open(args.chrome + ".spans.json", "w") as f:
            json.dump(tracing.snapshot(), f)
    tr = trace.reduce(events)
    tr.update(calls=args.calls, images=args.calls * batch, launches=0)
    rec = {"config": cfg, "batch": batch, "trace": tr}
    metric = lambda m: manifest.load_module(
        ROOT / "perfbench" / "metrics" / f"{m}.py").read(rec)

    ops = collections.defaultdict(lambda: [0, 0.0])
    lo, hi = trace.window(tr)
    for _, s, e, label in tr["device"]:
        if lo <= s <= hi:
            ops[label][0] += 1
            ops[label][1] += (e - s) / 1e3
    result = {"label": args.label, "cell": args.cell, "card": card(torch),
              "batch": batch, "calls": args.calls,
              "untraced_ms_per_call": untraced,
              "host_ms_per_call": metric("host_ms_per_call"),
              "staging_device_ms_per_kimg":
                  metric("staging_device_ms_per_kimg"),
              "device_ops": sorted(
                  [[k, n, ms / args.calls]
                   for k, (n, ms) in ops.items()], key=lambda r: -r[2]),
              "idle_gaps": idle_gaps(tr, events, trace)}
    if tracing is not None:
        snap = tracing.snapshot()
        spans = {s["id"]: s for s in snap["spans"]}
        table = collections.defaultdict(float)
        events_ms = collections.defaultdict(float)
        for s in snap["spans"]:
            if s["name"] not in LEAVES:
                continue
            parent = spans.get(s["parent"])
            row = (f"{parent['attrs']['k']} {parent['attrs']['name']}"
                   if parent and parent["name"] == "repro_torch.layer"
                   else "serve")
            table[(row, s["name"])] += s["device_ms"] / args.calls
            events_ms[s["name"]] += s["device_ms"] / args.calls
        launched = collections.defaultdict(float)
        by_op = collections.defaultdict(float)
        labels = {d[1]: d[3] for d in tr["device"]}
        stray = []
        for o in tracing.attribute(events):
            if o["in_serve"]:
                ms = o["dur"] / 1e3 / args.calls
                launched[o["span"]] += ms
                by_op[(labels.get(o["ts"], o["name"]), o["span"])] += ms
                if o["span"] not in LEAVES:
                    stray.append([o["name"], o["span"]])
        result.update(
            spans=len(snap["spans"]), dropped=snap["dropped"],
            span_metrics={m: read(rec)
                          for m, read in span_metrics.READERS.items()},
            by_layer=[[r, k, ms] for (r, k), ms in table.items()],
            leaf_kinds={k: [launched.get(k, 0.0), ms]
                        for k, ms in events_ms.items()},
            ops_by_span=sorted([[op, k, ms] for (op, k), ms in by_op.items()],
                               key=lambda r: -r[2]),
            outside_leaves=stray)
    print(f"{args.label} {args.cell} on {result['card']}")
    for key, value in result.items():
        if key not in ("label", "cell", "card"):
            print(f"{key}: {value}")
    print(json.dumps(result))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
