"""The traced stretch of a run: ``torch.profiler`` over a few ``serve``
calls, each inside a span of the harness's own (``SPAN``), reduced from
the profiler's Chrome trace to what the per-layer readers read.

Times are microseconds on the profiler's clock, which CPU and device
events share.  The traced window runs from the first span's start to the
last span's end.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

SPAN = "perfbench.serve"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def profile(call: Callable[[int], None], calls: int) -> dict:
    """Run ``call(i)`` for ``i < calls`` under the profiler, each in a
    ``SPAN`` range, and reduce the trace (:func:`reduce`)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for i in range(calls):
            with record_function(SPAN):
                call(i)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events)


def short_kernel(name: str) -> str:
    """A kernel's name without its template arguments, parameters and
    return type (``at::native::elementwise_kernel``); copies and sets keep
    theirs."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)", "(anonymous)")
    out, depth = [], 0
    for ch in name:
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and out and out[-1] != " ":
            break
        if depth == 0 and ch not in "<>":
            out.append(ch)
    return "".join(out).replace("void ", "").strip()


def _outermost(ops: List[Tuple[float, float, str]]) -> List[tuple]:
    """The operations of one thread that no other of them contains."""
    top: List[tuple] = []
    for a, b, name in sorted(ops, key=lambda o: (o[0], -o[1])):
        if not top or a >= top[-1][1]:
            top.append((a, b, name))
    return top


def reduce(events: List[dict]) -> dict:
    """The trace's spans, device operations, host operations and the
    runtime calls in which the host waited for the device (a
    synchronisation, or a copy to the host).  Each device operation is
    ``(name, start, end, label)``; the label names the outermost host
    operation that launched it and the kernel without its template
    arguments, for the breakdown."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    iv = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    corr = lambda e: e.get("args", {}).get("correlation")
    spans = sorted(iv(e) for e in xs
                   if e.get("cat") == "user_annotation" and e["name"] == SPAN)
    ops: Dict[object, list] = {}
    for e in xs:
        if e.get("cat") == "cpu_op":
            ops.setdefault(e.get("tid"), []).append(iv(e) + (e["name"],))
    tops = {tid: _outermost(v) for tid, v in ops.items()}
    starts = {tid: [t[0] for t in v] for tid, v in tops.items()}
    launcher = {}
    for e in xs:
        tid = e.get("tid")
        if e.get("cat") in RUNTIME_CATS and corr(e) is not None \
                and tid in tops:
            ts = float(e["ts"])
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and ts <= tops[tid][i][1]:
                launcher[corr(e)] = tops[tid][i][2]
    device = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            label = short_kernel(e["name"])
            if corr(e) in launcher:
                label = f"{launcher[corr(e)]} > {label}"
            device.append((e["name"],) + iv(e) + (label,))
    to_host = {corr(e) for e in xs
               if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]}
    to_host.discard(None)
    waits = [iv(e) for e in xs if e.get("cat") in RUNTIME_CATS
             and ("Synchronize" in e["name"] or corr(e) in to_host)]
    host = [(e["name"],) + iv(e) for e in xs
            if e.get("cat") in ("cpu_op",) + RUNTIME_CATS]
    return {"spans": spans, "device": sorted(device, key=lambda d: d[1]),
            "waits": sorted(waits), "host": host}


def window(tr: dict) -> Tuple[float, float]:
    return tr["spans"][0][0], tr["spans"][-1][1]


def clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def union(intervals) -> List[Tuple[float, float]]:
    """Overlapping intervals merged, in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(tr: dict) -> float:
    """Microseconds of the traced window in which a device operation ran
    (the union of their intervals)."""
    lo, hi = window(tr)
    return sum(b - a for a, b in union(clip(
        [d[1:3] for d in tr["device"]], lo, hi)))


def device_us(tr: dict, keep: Callable[[str], bool]) -> float:
    """Summed device time, within the traced window, of the operations
    whose name ``keep`` accepts."""
    lo, hi = window(tr)
    return sum(b - a for a, b in clip(
        [d[1:3] for d in tr["device"] if keep(d[0])], lo, hi))


def top_device_ops(tr: dict) -> List[list]:
    """The ``TOP`` device operations by summed time, by label:
    ``[label, seconds]``."""
    lo, hi = window(tr)
    total: Dict[str, float] = {}
    for _, s, e, label in tr["device"]:
        for a, b in clip([(s, e)], lo, hi):
            total[label] = total.get(label, 0.0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[n, us * 1e-6] for n, us in ranked]


def idle_gaps(tr: dict) -> List[list]:
    """The ``TOP`` longest stretches of the traced window with no device
    operation, each named by what the host was doing at its middle: the
    innermost host operation or runtime call there, else whether the host
    was inside a serve call or between two: ``[name, seconds]``."""
    lo, hi = window(tr)
    busy = union(clip([d[1:3] for d in tr["device"]], lo, hi))
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) / 2
        around = [h for h in tr["host"] if h[1] <= mid <= h[2]]
        if around:
            name = min(around, key=lambda h: h[2] - h[1])[0]
        elif any(s <= mid <= e for s, e in tr["spans"]):
            name = f"{SPAN} (python)"
        else:
            name = "harness, between calls"
        out.append([name, (b - a) * 1e-6])
    return out
