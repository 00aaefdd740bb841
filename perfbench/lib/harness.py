"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result's line.

The run of an ``offline`` cell, in order:

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

The run of a ``server`` cell (``lib/traffic.py``), in order:

1. set-up: the arrivals' process starts and draws the schedule; the same
   weights, compile and pool as above; every rung of the engine's pad
   ladder served twice; with ``trace``, one call under the profiler (its
   first start in a process is slow); one ``VTAServingEngine`` started (its
   warm-up probe); ``setup_s`` ends once the engine has started and the
   arrivals' process is ready;
2. the arrivals: each ``(index, due)`` the process sends is submitted by a
   receiving thread as image ``index mod pool_images``; requests due in
   the first ``warmup_s`` are served but not timed, those due in the next
   ``seconds`` are the window; each is timed from its due time to its
   logits on the host (the engine's ``RequestRecord.complete_t``, on the
   same clock);
3. with ``trace``: ``trace_s`` more seconds of the same arrivals, a
   moment after the window, under the profiler (the schedule runs up to
   ``TRACE_LEAD_S`` further, in which the profiler starts, and ends when
   the traced span closes);
4. every request answered (waiting up to ``WAIT_S`` past the last due
   time), the engine drained and stopped, and every answer compared with
   the reference's logits of its image.  A request that was rejected
   (``QueueFull``) counts in ``failed``; one left unanswered, or answered
   with an error, counts in ``failed`` and as ten wrong logits.
"""

from __future__ import annotations

import collections
import gc
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import check, seeds, trace, traffic
from .manifest import Cell

WAIT_S = 60.0        # the longest a request's answer is waited for
TRACE_GAP_S = 0.25   # between the window's close and the profiler's start
# arrivals scheduled past the window for the profiler to start in: the
# traced span opens once it has started and closes ``trace_s`` later
TRACE_LEAD_S = 5.0
HARVEST_S = 0.05     # how often answered requests are moved into arrays


def nearest_rank(values, q: float) -> float:
    """The value at rank ``ceil(q·n/100)`` of the sorted values (1-based),
    the percentile of ``repro_torch.serving.vta.metrics.nearest_rank``."""
    ordered = sorted(values)
    return float(ordered[max(1, math.ceil(q * len(ordered) / 100)) - 1])


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
    number beside its limit.  ``images_per_call`` overrides an offline
    mix's batch (the CPU tests run small)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    kind = cell.traffic["kind"]
    if kind not in traffic.KINDS:
        raise ValueError(f"traffic kind {kind!r} is not one of "
                         f"{traffic.KINDS}")
    marks = [("imports", time.perf_counter())]
    gen = None
    if kind == "server":      # drawing the schedule overlaps the set-up
        gen = traffic.Generator(
            cell.traffic["rate_per_s"], seed, cell.traffic["warmup_s"]
            + seconds + (TRACE_GAP_S + TRACE_LEAD_S + cell.workload["trace_s"]
                         if trace_on else 0.0))
    try:
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
        marks.append(("pool", time.perf_counter()))
        if gen is None:
            run = _offline(cell, program, pool, seconds, trace_on, dev,
                           t_start, marks)
        else:
            run = _server(cell, program, pool[0], gen, seconds, trace_on,
                          dev, t_start, marks)
    finally:
        if gen is not None:
            gen.close()
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = cell.reference()
    plan = ref.calibrate(cfg, weights, calib)
    block = cell.workload["reference_images_per_block"]
    refs = [ref.forward(cfg, weights, plan, p, dev, block=block)
            for p in pool]
    outputs, refs = run["answers"](refs)
    numbers = check.compare(outputs, refs)
    correct, shown = check.judge(numbers, cell.workload["limits"])

    rec = dict(run["rec"], config=cfg, compile_s=compile_s)
    if trace_on:
        metrics = {}
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, reader in cell.metric_readers().items():
            value = reader.read(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        metrics = {m["name"]: {"value": run["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    tr = rec["trace"]
    result = {"correct": correct,
              "attempted": numbers["images"] + run["rejected"],
              "failed": numbers["failed_images"] + run["rejected"],
              "metrics": metrics, "device": rec["device"]}
    if tr is not None and tr["device"]:
        result["breakdown"] = {"device_ops": trace.top_device_ops(tr),
                               "idle_gaps": trace.idle_gaps(tr)}
    if "generator" in run:
        result["generator"] = run["generator"]
    result["check"] = shown
    steps = [(name, t - prev) for (name, t), prev
             in zip(marks, [t_start] + [t for _, t in marks[:-1]])]
    lines = ["setup_s by step: " + ", ".join(f"{n} {s:.3f}" for n, s in steps)]
    lines += run["lines"]
    lines.append(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s")
    lines += [f"{name} {v['value']} limit {v['limit']}"
              for name, v in shown.items()]
    return result, lines


def _traced(call, calls, dev) -> dict:
    """``calls`` runs of ``call`` under the profiler, reduced
    (``lib/trace.py``), with the ``vta_matmul`` launches they made.  On
    the card every traced stretch launches kernels: a trace that holds
    none has lost the device's records, and the run fails."""
    from repro_torch.kernels import ops
    before = ops.launches
    tr = trace.profile(call, calls)
    tr["launches"] = ops.launches - before
    if dev.type == "cuda" and all(d[0].startswith(("Memcpy", "Memset"))
                                  for d in tr["device"]):
        raise RuntimeError("the traced stretch holds no kernel: the "
                           "profiler lost the device's records")
    return tr


def _busy(tr: dict) -> Dict[str, float]:
    """``busy_s`` and ``window_s`` of the traced window."""
    lo, hi = trace.window(tr)
    return {"busy_s": trace.busy_us(tr) * 1e-6, "window_s": (hi - lo) * 1e-6}


def _offline(cell, program, pool, seconds, trace_on, dev, t_start,
             marks) -> dict:
    """Steps 1–3 of an offline run: the warm calls, the window of closed-
    loop calls and the traced calls."""
    import torch
    batch = len(pool[0])

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
        tr = _traced(lambda j: outputs.append(serve(len(lat) + j)), calls,
                     dev)
        tr.update(calls=calls, images=calls * batch)
        device_info.update(_busy(tr))
    images = len(lat) * batch
    return {"e2e": {"images_per_s": images / window_s,
                    "batch_latency_p95_ms": nearest_rank(lat, 95) * 1e3,
                    "setup_s": setup_s},
            "rec": {"batch": batch,
                    "window": {"seconds": window_s, "calls": len(lat),
                               "images": images},
                    "device": device_info, "trace": tr},
            "answers": lambda refs: (outputs, refs),
            "rejected": 0, "lines": []}


class PerfClock:
    """The serving engine's clock on ``time.perf_counter``, the clock the
    arrivals' process stamps due times on (the engine reads ``now()``
    alone)."""

    def now(self) -> float:
        return time.perf_counter()


def warm_ladder(program, pool: np.ndarray, mix: dict, dev) -> list:
    """Serve every rung of the engine's pad ladder twice on each worker's
    backend, as the engine will call it; returns the pool as a list of
    requests, one ``(1, C, H, W)`` image each."""
    requests = list(pool[:, None])
    for backend in dict.fromkeys(mix["workers"]):
        for size in program.padded_batch_sizes(mix["policy"]["max_batch"]):
            for _ in range(2):
                program.serve(requests[:size], backend=backend, device=dev)
    return requests


class OpenLoop:
    """One seeded open-loop replay through one ``VTAServingEngine``.

    ``start()`` starts the engine and waits for the arrivals' process;
    ``go()`` starts the schedule and a thread that submits each arrival as
    its message comes; ``wait_until(t)`` sleeps until ``t``
    (``time.perf_counter``), meanwhile moving answered requests into the
    arrays below; ``finish(deadline)`` waits for that thread and for every
    answer until ``deadline``, then drains and stops the engine.

    A request's answer, its ``RequestRecord``'s stamps and its state go into
    one row of ``self.rows`` (numpy arrays, one entry an arrival) as soon
    as it is answered, and its ticket is let go: the harness holds no
    object a request, so the interpreter's collector has no more to walk
    than the program gives it.  ``state`` is -1 for an arrival never sent
    (``stop()`` ended the schedule early), 0 unanswered, 1 answered, 2
    rejected."""

    def __init__(self, program, requests, mix: dict, gen, dev):
        from repro_torch.serving.vta import BatchPolicy, VTAServingEngine
        self.requests, self.gen = requests, gen
        self.engine = VTAServingEngine(
            program, policy=BatchPolicy(**mix["policy"]),
            backends=tuple(mix["workers"]), device=dev, clock=PerfClock())
        self.pending: collections.deque = collections.deque()
        self.rows: Dict[str, np.ndarray] = {}
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self.engine.start()
        n = self.gen.ready()
        self.rows = {k: np.zeros(n) for k in (
            "due", "sent", "enqueue", "dispatch", "complete")}
        self.rows.update({k: np.zeros(n, np.int64) for k in (
            "batch", "padded", "worker")})
        self.rows["state"] = np.full(n, -1)
        self.rows["index"] = np.arange(n)
        self.rows["answer"] = None
        return n

    def go(self) -> float:
        t0 = time.perf_counter()
        self.gen.go(t0)
        self.thread = threading.Thread(target=self._receive,
                                       name="perfbench-arrivals")
        self.thread.start()
        return t0

    def _receive(self) -> None:
        from repro_torch.serving.vta import QueueFull
        submit, reqs, pending = self.engine.submit, self.requests, self.pending
        due, sent, state = (self.rows[k] for k in ("due", "sent", "state"))
        n = len(reqs)
        try:
            for msgs in self.gen.messages():
                for index, t_due, t_sent in msgs:
                    i = int(index)
                    due[i], sent[i], state[i] = t_due, t_sent, 0
                    try:
                        pending.append((i, submit(reqs[i % n])))
                    except QueueFull:
                        state[i] = 2
        except BaseException as exc:       # noqa: BLE001 - re-raised in finish
            self.error = exc

    def _harvest(self, deadline: Optional[float] = None) -> None:
        """Move the answered requests at the head of ``pending`` into the
        rows; with ``deadline``, wait for each until then."""
        from repro_torch.serving.vta import QueueClosed, ServingError
        rows, pending = self.rows, self.pending
        while pending:
            i, ticket = pending[0]
            if deadline is None and not ticket.done():
                return
            pending.popleft()
            try:
                answer = np.asarray(ticket.result(
                    None if deadline is None
                    else max(0.0, deadline - time.perf_counter())))
            except (TimeoutError, ServingError, QueueClosed):
                continue                    # stays "unanswered"
            if rows["answer"] is None:
                rows["answer"] = np.zeros(
                    (len(rows["due"]), answer.size), answer.dtype)
            rec = ticket.record
            rows["answer"][i] = answer.reshape(-1)
            rows["enqueue"][i], rows["dispatch"][i] = (rec.enqueue_t,
                                                       rec.dispatch_t)
            rows["complete"][i] = rec.complete_t
            rows["batch"][i], rows["padded"][i] = (rec.batch_size,
                                                   rec.padded_size)
            rows["worker"][i], rows["state"][i] = rec.worker, 1

    def wait_until(self, t: float) -> None:
        while True:
            self._harvest()
            now = time.perf_counter()
            if now >= t:
                return
            time.sleep(min(HARVEST_S, t - now))

    def stop(self) -> None:
        """End the schedule here: the arrivals' process ends, and the
        receiving thread with it."""
        self.gen.proc.terminate()

    def finish(self, deadline: float) -> Dict[str, np.ndarray]:
        if self.thread is not None:
            self.thread.join(max(0.0, deadline - time.perf_counter()))
        self._harvest(deadline)
        self.close(drain=not (self.rows["state"] == 0).any())
        if self.error is not None:
            raise self.error
        if self.thread is not None and self.thread.is_alive():
            raise RuntimeError("the receiving thread did not end")
        return self.rows

    def close(self, drain: bool = False) -> None:
        self.engine.shutdown(drain=drain, timeout=WAIT_S)


def _server(cell, program, pool, gen, seconds, trace_on, dev, t_start,
            marks) -> dict:
    """Steps 1–3 of a server run."""
    import torch
    mix = cell.traffic
    requests = warm_ladder(program, pool, mix, dev)
    marks.append(("ladder", time.perf_counter()))
    if trace_on:
        # a process's first profiler start took 10-16 s on the card's
        # machine: after the window it stalled the engine and overflowed
        # its queue, so it is paid here, on one call of the smallest rung
        trace.profile(lambda _: program.serve(
            requests[:1], backend=mix["workers"][0], device=dev), 1)
        marks.append(("profiler", time.perf_counter()))
    loop = OpenLoop(program, requests, mix, gen, dev)
    try:
        loop.start()
        setup_s = time.perf_counter() - t_start
        marks.append(("engine and arrivals", t_start + setup_s))
        t0 = loop.go()
    except BaseException:
        loop.close()
        raise
    ws = t0 + mix["warmup_s"]
    we = ws + seconds
    last = we
    tr, opened = None, []
    try:
        loop.wait_until(we)
        if trace_on:
            loop.wait_until(we + TRACE_GAP_S)
            last = we + TRACE_GAP_S + TRACE_LEAD_S + cell.workload["trace_s"]

            def span(_):
                opened.append(time.perf_counter())
                loop.wait_until(min(opened[0] + cell.workload["trace_s"],
                                    last))

            tr = _traced(span, 1, dev)
            loop.stop()
    finally:
        rows = loop.finish(last + WAIT_S)
    device_info = _device_info(torch, dev)
    if tr is not None:
        device_info.update(_busy(tr))
    horizon = last + WAIT_S
    sent = rows["state"] >= 0
    rows = {k: v[sent] for k, v in rows.items() if v is not None}
    state, due = rows["state"], rows["due"]
    window = (due >= ws) & (due < we)
    if not window.any():
        raise RuntimeError("no request was due in the window")
    done = window & (state == 1)
    # a request rejected or never answered misses every latency limit
    lat = np.where(state == 1, rows["complete"], horizon)[window] - due[window]
    completed = int(((state == 1) & (rows["complete"] >= ws)
                     & (rows["complete"] < we)).sum())
    late = (rows["sent"] - due)[window]
    generator = {"late_p50_ms": nearest_rank(late, 50) * 1e3,
                 "late_p99_ms": nearest_rank(late, 99) * 1e3,
                 "sent": len(due)}

    def answers(refs):
        ref = refs[0]
        idx = rows["index"] % len(ref)
        ok = state == 1
        outs = rows["answer"][ok] if "answer" in rows \
            else np.empty((0,) + ref.shape[1:], ref.dtype)
        outputs, want = [(0, outs)], [ref[idx[ok]]]
        if (state == 0).any():       # answers missing: every logit is wrong
            outputs.append((1, np.empty((0,) + ref.shape[1:], ref.dtype)))
            want.append(ref[idx[state == 0]])
        return outputs, want

    return {"e2e": {"images_per_s": completed / seconds,
                    "latency_p95_ms": nearest_rank(lat, 95) * 1e3,
                    "setup_s": setup_s},
            "rec": {"batch": None,
                    "window": {"seconds": seconds,
                               "calls": int(window.sum()),
                               "images": completed},
                    "requests": {k: rows[k][done] for k in (
                        "due", "enqueue", "dispatch", "complete", "batch",
                        "padded", "worker")},
                    "device": device_info, "trace": tr},
            "answers": answers,
            "rejected": int((state == 2).sum()),
            "generator": generator,
            "lines": ([f"traced span: opened {opened[0] - we:.3f} s after "
                       f"the window closed"] if tr is not None else []) + [
                      f"generator: {len(due)} sent, in the window late p50 "
                      f"{generator['late_p50_ms']:.4f} ms, p99 "
                      f"{generator['late_p99_ms']:.4f} ms; "
                      f"{int(window.sum())} requests due in the window, "
                      f"{int(done.sum())} answered"]}
