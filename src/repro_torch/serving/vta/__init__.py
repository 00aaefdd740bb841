"""Async VTA serving subsystem on the port's ``cuda`` backend.

The production-shaped layer over compiled
:class:`~repro_torch.core.network_compiler.NetworkProgram` plans: a
thread-safe bounded request queue with typed backpressure, a
max-batch/max-wait dynamic batch former padding to the compiled-shape
ladder, a pool of ``cuda`` workers draining batches concurrently on one
device, per-request latency + SLO metrics, and a seeded virtual-clock
load generator + discrete-event simulation for hermetic latency curves.

The queue, policy, metrics, clock and load generator are the reference
package's (``repro.serving.vta``), copied; the engine and the simulation
serve on a torch device (the card unless the caller names another).
"""

from .clock import VirtualClock, WallClock
from .engine import VTAServingEngine, serve_all
from .loadgen import (ClosedLoopSource, PoissonSource,
                      poisson_arrival_times, request_images)
from .metrics import RequestRecord, ServingMetrics, nearest_rank
from .policy import BatchPolicy, pad_ladder, padded_size, ready_count
from .queueing import (QueueClosed, QueueFull, RequestQueue, ServingError,
                       Ticket)
from .simulate import (ServiceModel, SimResult, calibrate_service_model,
                       simulate)

__all__ = [
    "BatchPolicy", "ClosedLoopSource", "PoissonSource", "QueueClosed",
    "QueueFull", "RequestQueue", "RequestRecord", "ServiceModel",
    "ServingError", "ServingMetrics", "SimResult", "Ticket",
    "VTAServingEngine", "VirtualClock", "WallClock",
    "calibrate_service_model", "nearest_rank", "pad_ladder",
    "padded_size", "poisson_arrival_times", "ready_count",
    "request_images", "serve_all", "simulate",
]
