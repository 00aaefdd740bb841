"""Async VTA serving engine: queue → dynamic batch former → worker pool.

The production-shaped layer over compiled
:class:`~repro_torch.core.network_compiler.NetworkProgram` plans (DESIGN.md
§Serving): callers ``submit()`` single images and get a
:class:`~repro_torch.serving.vta.queueing.Ticket`; worker threads block on
the shared :class:`~repro_torch.serving.vta.queueing.RequestQueue`, form
batches under the max-batch/max-wait
:class:`~repro_torch.serving.vta.policy.BatchPolicy`, pad them up the
compiled-shape ladder (:meth:`NetworkProgram.padded_batch_sizes`), execute
``NetworkProgram.serve`` on one device, and resolve the tickets.

Design points (the reference's engine, with ``cuda`` in the place of
``pallas``):

* **Workers** — ``backends=("cuda", "batched")`` starts one worker thread
  per entry; every entry must be in the port's ``SERVE_BACKENDS`` — the
  ``vta_gemm`` kernel backend or the batched instruction interpreter, both
  bit-identical per request, so which worker serves a request is
  unobservable in the results.  All
  workers serve on the engine's one device, resolved when the engine is
  constructed (the card unless the caller names another), and all issue
  their device work on that device's default stream: their batches
  serialise on the device, and the caching allocator's reuse of a freed
  block by another thread stays ordered on that one stream.  Workers
  overlap only their host work (staging, launches, the GIL's turns).
* **Admission control** — submissions beyond ``max_depth`` raise
  :class:`~repro_torch.serving.vta.queueing.QueueFull`; mis-shaped images
  are rejected at the door against :meth:`NetworkProgram.input_signature`.
* **Graceful drain** — ``shutdown(drain=True)`` closes the queue (new
  submissions raise ``QueueClosed``), lets workers finish every queued
  request, then joins them; ``drain=False`` cancels queued tickets with
  a typed error instead.  Either way no ticket is left unresolved.
* **Failures** — a batch whose serve raises (a kernel error, a sticky
  CUDA fault) resolves each of its tickets with
  :class:`~repro_torch.serving.vta.queueing.ServingError`; nothing falls
  back to the CPU or to a plain version.
* **Guarded serving** — ``guard=GuardPolicy()`` routes batches through
  the integrity stack (:mod:`repro_torch.harden`).  Guarded execution
  mutates/restores shared network state on detection, so it is serialized
  across workers by an engine lock and pinned to the batched backend (the
  guard stack's typed refusal otherwise).
* **Compile-once under traffic** — the warm-up at ``start()`` serves one
  probe image before any worker thread exists, so the device cache (the
  image and its layers' ``LayerConsts``), the plan caches and the kernel
  build are filled single-threaded.  A ladder rung's first batch still pays for its
  ``vta_gemm.plan`` entries and the allocator's growth.
"""

from __future__ import annotations

import itertools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.errors import CompileError
from repro_torch.core.network_compiler import SERVE_BACKENDS
from repro_torch.device import DeviceLike, resolve_device

from .clock import WallClock
from .metrics import RequestRecord, ServingMetrics
from .policy import BatchPolicy, padded_size
from .queueing import (QueueClosed, QueueFull, RequestQueue, ServingError,
                       Ticket)


class VTAServingEngine:
    """Threaded async serving over one compiled network on one device."""

    def __init__(self, net, *, policy: Optional[BatchPolicy] = None,
                 backends: Sequence[str] = ("cuda",),
                 device: DeviceLike = None, guard=None,
                 slo_s: Optional[float] = None, warmup: bool = True,
                 clock=None):
        if not backends:
            raise ValueError("engine needs at least one worker backend")
        for be in backends:
            if be not in SERVE_BACKENDS:
                raise CompileError(
                    f"engine worker backend must be in {SERVE_BACKENDS} "
                    f"(the per-image simulators serve no batch stack), "
                    f"got {be!r}", constraint="serve-backend")
        if guard is not None and any(be != "batched" for be in backends):
            raise CompileError(
                "guarded serving runs on the batched instruction "
                "interpreter only; drop guard= or use "
                "backends=('batched', ...)",
                constraint="serve-guard-backend")
        self.device = resolve_device(device)
        self.net = net
        self.guard = guard
        self.policy = policy or BatchPolicy()
        self.backends = tuple(backends)
        self.clock = clock or WallClock()
        self.metrics = ServingMetrics(slo_s=slo_s)
        self._ladder = net.padded_batch_sizes(self.policy.max_batch)
        self._signature = net.input_signature()
        self._queue = RequestQueue(self.policy)
        self._rid = itertools.count()
        self._threads: List[threading.Thread] = []
        self._started = False
        self._stopped = False
        self._warmup = warmup
        # guarded serving restores shared segments in place → serialize
        self._guard_lock = threading.Lock() if guard is not None else None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "VTAServingEngine":
        if self._started:
            raise RuntimeError("engine already started")
        self._started = True
        if self._warmup:
            probe = np.zeros(self._signature[0], dtype=self._signature[1])
            for be in set(self.backends):
                self.net.serve([probe], backend=be, device=self.device)
        for widx, be in enumerate(self.backends):
            t = threading.Thread(target=self._worker, args=(widx, be),
                                 name=f"vta-serve-{widx}-{be}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop accepting requests; with ``drain`` (default) serve every
        queued request first, otherwise cancel them with ``QueueClosed``.
        Idempotent."""
        if self._stopped:
            return
        self._stopped = True
        if not drain:
            cancelled = self._queue.cancel_pending()
            for ticket in cancelled:
                ticket.resolve(None, QueueClosed(
                    f"request {ticket.rid}: cancelled by non-draining "
                    f"shutdown"))
            self.metrics.on_cancel(len(cancelled))
        self._queue.close()
        for t in self._threads:
            t.join(timeout)

    def __enter__(self) -> "VTAServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # ---------------------------------------------------------- caller API
    def submit(self, image: np.ndarray) -> Ticket:
        """Enqueue one request; raises ``QueueFull`` under backpressure,
        ``QueueClosed`` after shutdown, ``ValueError`` on a mis-shaped
        image (validated against the compiled input signature)."""
        image = np.asarray(image)
        want_shape, want_dtype = self._signature
        if image.shape != want_shape:
            raise ValueError(
                f"request image shape {image.shape} != compiled input "
                f"signature {want_shape}")
        ticket = Ticket(next(self._rid), image.astype(want_dtype),
                        self.clock.now())
        self.metrics.on_submit()
        try:
            self._queue.submit(ticket)
        except QueueFull:
            self.metrics.on_reject()
            raise
        except QueueClosed:
            self.metrics.on_cancel()
            raise
        return ticket

    def depth(self) -> int:
        return self._queue.depth()

    # ---------------------------------------------------------- workers
    def _worker(self, widx: int, backend: str) -> None:
        if self.device.type == "cuda":      # the current device is per thread
            torch.cuda.set_device(self.device)
        while True:
            batch = self._queue.take_batch(self.clock)
            if batch is None:
                return
            self._execute(batch, widx, backend)

    def _execute(self, batch: List[Ticket], widx: int,
                 backend: str) -> None:
        dispatch_t = self.clock.now()
        images = [t.image for t in batch]
        padded = padded_size(len(images), self._ladder)
        exec_images = images + [images[-1]] * (padded - len(images))
        guard_reports = None
        try:
            if self.guard is not None:
                with self._guard_lock:
                    outs, _, guard_reports = self.net.serve(
                        exec_images, backend=backend, device=self.device,
                        guard=self.guard)
            else:
                outs, _ = self.net.serve(exec_images, backend=backend,
                                         device=self.device)
        except Exception as exc:                      # noqa: BLE001
            self.metrics.on_fail(len(batch))
            err = ServingError(f"batch execution failed on "
                               f"{backend!r}: {type(exc).__name__}: {exc}")
            err.__cause__ = exc
            for ticket in batch:
                ticket.resolve(None, err)
            return
        # serve returns after its logits reached the host (a device sync)
        complete_t = self.clock.now()
        for i, ticket in enumerate(batch):
            if guard_reports is not None:
                ticket.guard_report = guard_reports[i]
            if outs is None or (guard_reports is not None
                                and not guard_reports[i].ok):
                self.metrics.on_fail()
                ticket.resolve(None, ServingError(
                    f"request {ticket.rid}: guard outcome 'failed' — "
                    f"unrecoverable corruption, no result"))
                continue
            record = RequestRecord(
                rid=ticket.rid, enqueue_t=ticket.enqueue_t,
                dispatch_t=dispatch_t, complete_t=complete_t,
                batch_size=len(batch), padded_size=padded,
                backend=backend, worker=widx)
            ticket.record = record
            self.metrics.observe(record)
            ticket.resolve(outs[i])


def serve_all(engine: VTAServingEngine, images: Sequence[np.ndarray],
              *, timeout_s: float = 120.0
              ) -> Tuple[np.ndarray, List[Ticket]]:
    """Convenience driver: submit every image (blocking briefly on
    backpressure rather than shedding), wait for all results, return them
    stacked in submission order plus the tickets."""
    tickets = []
    for img in images:
        while True:
            try:
                tickets.append(engine.submit(img))
                break
            except QueueFull:
                threading.Event().wait(0.001)     # bounded retry backoff
    outs = [t.result(timeout=timeout_s) for t in tickets]
    return np.stack(outs), tickets
