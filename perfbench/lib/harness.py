"""One run of one cell: set-up, the measured window, the traced calls, the
comparison with the plain reference, and the result's line.

The run, in order:

1. set-up: seeded weights and calibration images, the port's compile of
   the network (``programs/<config>.py``; ``compile_s``), the traffic
   pool, and one ``serve`` call on each batch of the pool, which builds or
   loads the kernels and allocates the DRAM stack; ``setup_s`` runs from
   the start of the process to here;
2. the window: ``serve`` calls back to back for ``seconds`` (closed loop,
   one caller), each timed on the host clock from its issue to its logits
   on the host, every answer kept;
3. with ``trace``: a few more calls under the profiler
   (``trace_calls`` of the cell's file), for the per-layer metrics;
4. the program's state freed, the reference (``reference/<config>.py``)
   calibrates again from the same weights and images and works out the
   pool's logits, and every call's answers are compared with them.
"""

from __future__ import annotations

import gc
import math
import time
from typing import List, Optional, Tuple

import numpy as np

from . import check, seeds, trace, traffic
from .manifest import Cell


def nearest_rank(values: List[float], q: float) -> float:
    """The value at rank ``ceil(q·n/100)`` of the sorted values (1-based),
    the percentile of ``repro_torch.serving.vta.metrics.nearest_rank``."""
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q * len(ordered) / 100)) - 1]


def _device_info(torch, dev) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool,
             device: str, *, t_start: Optional[float] = None,
             images_per_call: Optional[int] = None
             ) -> Tuple[dict, List[str]]:
    """Run ``cell`` once on ``device``.  Returns the result's line (a dict
    whose last key is ``check``) and the lines for standard error: the
    set-up's steps, the reference's seconds, and last each compared
    number beside its limit.  ``images_per_call`` overrides the mix's
    batch (the CPU tests run small)."""
    import torch
    from repro_torch.kernels import ops

    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.empty(0, device=dev)          # the card's context, first
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("context", time.perf_counter()))
    cfg = cell.config
    weights = seeds.weights(cfg, seed)
    calib = traffic.calibration_images(cfg, seed)
    t = time.perf_counter()
    program = cell.program().compile(cfg, weights, calib)
    compile_s = time.perf_counter() - t
    marks.append(("compile", time.perf_counter()))
    pool = traffic.pool(cfg, cell.traffic, seed, images_per_call)
    batch = len(pool[0])
    marks.append(("pool", time.perf_counter()))

    def serve(i: int) -> Tuple[int, np.ndarray]:
        b = i % len(pool)
        out, _ = program.serve(pool[b], device=dev)
        return b, out.reshape(batch, -1)

    for i in range(len(pool)):
        serve(i)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", t_start + setup_s))

    outputs, lat = [], []
    t0 = te = time.perf_counter()
    while te - t0 < seconds or not lat:
        ts = time.perf_counter()
        outputs.append(serve(len(lat)))
        te = time.perf_counter()
        lat.append(te - ts)
    window_s = te - t0
    device_info = _device_info(torch, dev)

    tr = None
    if trace_on:
        calls = cell.workload["trace_calls"]
        before = ops.launches
        tr = trace.profile(
            lambda j: outputs.append(serve(len(lat) + j)), calls)
        tr.update(calls=calls, images=calls * batch,
                  launches=ops.launches - before)
        lo, hi = trace.window(tr)
        device_info["busy_s"] = trace.busy_us(tr) * 1e-6
        device_info["window_s"] = (hi - lo) * 1e-6

    del program, serve
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = cell.reference()
    plan = ref.calibrate(cfg, weights, calib)
    block = cell.workload["reference_images_per_block"]
    refs = [ref.forward(cfg, weights, plan, p, dev, block=block)
            for p in pool]
    numbers = check.compare(outputs, refs)
    correct, shown = check.judge(numbers, cell.workload["limits"])

    images = len(lat) * batch
    rec = {"config": cfg, "batch": batch, "compile_s": compile_s,
           "window": {"seconds": window_s, "calls": len(lat),
                      "images": images},
           "device": device_info, "trace": tr}
    if trace_on:
        metrics = {}
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, reader in cell.metric_readers().items():
            value = reader.read(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        e2e = {"images_per_s": images / window_s,
               "batch_latency_p95_ms": nearest_rank(lat, 95) * 1e3,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": numbers["images"],
              "failed": numbers["failed_images"], "metrics": metrics,
              "device": device_info}
    if tr is not None and tr["device"]:
        result["breakdown"] = {"device_ops": trace.top_device_ops(tr),
                               "idle_gaps": trace.idle_gaps(tr)}
    result["check"] = shown
    steps = [(name, t - prev) for (name, t), prev
             in zip(marks, [t_start] + [t for _, t in marks[:-1]])]
    lines = ["setup_s by step: " + ", ".join(f"{n} {s:.3f}" for n, s in steps),
             f"reference and comparison: {time.perf_counter() - t_ref:.3f} s"]
    lines += [f"{name} {v['value']} limit {v['limit']}"
              for name, v in shown.items()]
    return result, lines
