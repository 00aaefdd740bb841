"""Virtual-clock discrete-event simulation of the serving engine.

The hermetic half of the subsystem (DESIGN.md §Serving): the same
queue/batch-former policy the threaded engine runs
(:func:`~repro_torch.serving.vta.policy.ready_count`, the same padding ladder),
driven by a :class:`~repro_torch.serving.vta.clock.VirtualClock` over a seeded
arrival source, with batch service times taken from a deterministic
:class:`ServiceModel` instead of wall time.  Same seed + same model ⇒
bit-identical request traces and latency histograms on any machine —
the ``servelat/*/deterministic_replay`` benchmark row asserts exactly
that (EXPERIMENTS.md §Serving-latency).

When ``net`` is passed, every formed batch is *really executed* through
``NetworkProgram.serve`` on ``device`` (the card unless the caller names
another; padded up the compiled-shape ladder, pad rows sliced off), so
the simulation doubles as the differential harness: the outputs it
returns must be bit-identical to a direct ``serve`` of the same images,
while latency accounting stays virtual.

Event loop: a single heap of ``(time, seq, kind)`` events — arrivals
(admission-checked against ``max_depth``), max-wait timers (scheduled at
``enqueue + max_wait`` so the float comparison in ``ready_count`` is
exact), and batch completions (which free their worker and may schedule
closed-loop re-submissions).  ``seq`` makes equal-time ordering
deterministic.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

from .clock import VirtualClock
from .loadgen import request_images
from .metrics import RequestRecord, ServingMetrics
from .policy import BatchPolicy, pad_ladder, padded_size, ready_count


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Deterministic batch service time: ``base + per_image * rows``.

    ``rows`` is the *padded* stack size — what the batch backend actually
    executes — so padding's cost is modeled, not hidden."""

    base_s: float
    per_image_s: float

    def service_s(self, padded_rows: int) -> float:
        return self.base_s + self.per_image_s * padded_rows


def calibrate_service_model(net, *, backend: str = "cuda",
                            device: DeviceLike = None, batch: int = 8,
                            repeats: int = 3, seed: int = 0) -> ServiceModel:
    """Fit a :class:`ServiceModel` from real timed serves at stack sizes
    1 and ``batch`` on ``device`` (median of ``repeats``).  Calibration is
    the one wall-clock step; everything downstream of the returned model
    is deterministic.  Each timed ``serve`` ends in the copy of its logits
    to the host, which waits for the device."""
    dev = resolve_device(device)
    images = request_images(net, batch, seed)
    net.serve(images[:1], backend=backend, device=dev)   # warm plans/kernels
    net.serve(images, backend=backend, device=dev)

    def _median_serve_s(imgs) -> float:
        samples = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            net.serve(imgs, backend=backend, device=dev)
            samples.append(time.perf_counter() - t0)
        return sorted(samples)[len(samples) // 2]

    t1 = _median_serve_s(images[:1])
    tb = _median_serve_s(images)
    per_image = max((tb - t1) / (batch - 1), 0.0) if batch > 1 else 0.0
    base = max(t1 - per_image, 1e-9)
    return ServiceModel(base_s=base, per_image_s=per_image)


@dataclasses.dataclass
class _SimRequest:
    rid: int
    enqueue_t: float


@dataclasses.dataclass
class SimResult:
    """What one simulation run produced."""

    metrics: ServingMetrics
    records: List[RequestRecord]            # completion order
    outputs: Optional[Dict[int, np.ndarray]]  # rid -> logits (net runs)

    def trace(self) -> List[tuple]:
        """Canonical comparable request trace (deterministic replay)."""
        return [r.as_tuple() for r in self.records]


def simulate(source, policy: BatchPolicy, service_model: ServiceModel, *,
             workers: int = 1, backend: str = "cuda",
             device: DeviceLike = None, slo_s: Optional[float] = None,
             net=None) -> SimResult:
    """Run the serving policy over a seeded arrival source on the virtual
    clock; see the module docstring for semantics.  ``device`` is resolved
    only when ``net`` is passed: a model-only run touches no device."""
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    dev = resolve_device(device) if net is not None else None
    clock = VirtualClock()
    ladder = (net.padded_batch_sizes(policy.max_batch) if net is not None
              else pad_ladder(policy.max_batch))
    metrics = ServingMetrics(slo_s=slo_s)
    records: List[RequestRecord] = []
    outputs: Optional[Dict[int, np.ndarray]] = {} if net is not None else None

    events: list = []
    seq = itertools.count()

    def push(t: float, kind: str, payload) -> None:
        heapq.heappush(events, (t, next(seq), kind, payload))

    pending: deque = deque()
    free_workers = list(range(workers))

    def try_dispatch(now: float) -> None:
        while free_workers and pending:
            n = ready_count(len(pending), pending[0].enqueue_t, now, policy)
            if not n:
                return
            reqs = [pending.popleft() for _ in range(n)]
            widx = free_workers.pop(0)
            padded = padded_size(n, ladder)
            if net is not None:
                imgs = [source.image_for(r.rid) for r in reqs]
                exec_imgs = imgs + [imgs[-1]] * (padded - n)
                outs, _ = net.serve(exec_imgs, backend=backend,
                                    device=dev)
                for r, out in zip(reqs, outs):
                    outputs[r.rid] = out
            push(now + service_model.service_s(padded), "complete",
                 (widx, reqs, now, n, padded))

    for t, rid in source.initial_arrivals():
        push(t, "arrival", rid)

    while events:
        t, _, kind, payload = heapq.heappop(events)
        clock.advance_to(t)
        if kind == "arrival":
            metrics.on_submit()
            if len(pending) >= policy.max_depth:
                metrics.on_reject()
                for t2, rid2 in source.on_reject(payload, t):
                    push(t2, "arrival", rid2)
            else:
                pending.append(_SimRequest(payload, t))
                push(t + policy.max_wait_s, "timer", None)
                try_dispatch(t)
        elif kind == "timer":
            try_dispatch(t)
        else:                                   # complete
            widx, reqs, dispatch_t, n, padded = payload
            free_workers.append(widx)
            free_workers.sort()                 # deterministic assignment
            for r in reqs:
                record = RequestRecord(
                    rid=r.rid, enqueue_t=r.enqueue_t,
                    dispatch_t=dispatch_t, complete_t=t,
                    batch_size=n, padded_size=padded,
                    backend=backend, worker=widx)
                metrics.observe(record)
                records.append(record)
                for t2, rid2 in source.on_complete(r.rid, t):
                    push(t2, "arrival", rid2)
            try_dispatch(t)

    assert not pending, "simulation ended with requests still queued"
    return SimResult(metrics=metrics, records=records, outputs=outputs)
