"""Dynamic-batching policy: when to dispatch, and at what stack shape.

The decision function :func:`ready_count` is deliberately *pure* — both
execution substrates call the same function with the same arguments:

* the threaded :class:`~repro_torch.serving.vta.engine.VTAServingEngine`
  evaluates it under the queue lock with wall-clock time;
* the virtual-clock discrete-event simulation
  (:mod:`repro_torch.serving.vta.simulate`) evaluates it at event boundaries.

That sharing is the core of the determinism argument (DESIGN.md
§Serving): the simulation exercises the *same* max-batch/max-wait policy
the production engine runs, only the clock differs.

Padding ladder: the ``cuda`` backend executes a ``(B, nbytes)`` DRAM
stack for any ``B``, but serving every possible occupancy would touch a
new stack shape (a new ``vta_gemm`` plan and new allocator sizes) per
batch.  :func:`pad_ladder` fixes a small closed set of compiled batch
shapes — powers of two up to ``max_batch`` — and :func:`padded_size`
rounds a formed batch up to the next rung.  Pad rows replicate the last
real request and are sliced off after execution; per-request results are
unaffected because the ``cuda`` backend treats stack rows independently
(``tests/test_torch_conformance.py`` holds a padded serve's real rows
equal to their unpadded serve).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.errors import CompileError


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Max-batch / max-wait dynamic batching + admission control.

    ``max_batch``   — most requests per formed batch (and the top rung of
                      the padding ladder).
    ``max_wait_s``  — longest the oldest queued request may wait before a
                      partial batch dispatches; ``0`` means *immediate*
                      dispatch of whatever is queued.
    ``max_depth``   — admission control: submissions beyond this queue
                      depth are rejected with a typed
                      :class:`~repro_torch.serving.vta.queueing.QueueFull`
                      (backpressure, never silent dropping).
    """

    max_batch: int = 8
    max_wait_s: float = 0.002
    max_depth: int = 64

    def __post_init__(self):
        if self.max_batch < 1:
            # typed + constraint-tagged: the policy is where a degenerate
            # ladder is born, so it is rejected here at construction (and
            # again in pad_ladder for direct callers) instead of as a bare
            # ValueError deep in padded_size (CompileError subclasses
            # ValueError, so pre-existing catchers keep working)
            raise CompileError(
                f"max_batch must be >= 1, got {self.max_batch}",
                constraint="policy-max-batch")
        if self.max_wait_s < 0:
            raise ValueError(
                f"max_wait_s must be >= 0, got {self.max_wait_s}")
        if self.max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {self.max_depth}")


def ready_count(pending: int, oldest_enqueue_t: float, now: float,
                policy: BatchPolicy, *, closed: bool = False) -> int:
    """How many requests to dispatch right now (0 = keep waiting).

    Dispatch fires when the batch is full, when the oldest request has
    waited ``max_wait_s`` (compared as ``now >= enqueue + max_wait`` so a
    timer scheduled at exactly that sum triggers despite float rounding),
    or when the queue is closed and draining.
    """
    if pending <= 0:
        return 0
    if pending >= policy.max_batch:
        return policy.max_batch
    if closed or now >= oldest_enqueue_t + policy.max_wait_s:
        return pending
    return 0


def pad_ladder(max_batch: int) -> Tuple[int, ...]:
    """The closed set of compiled batch shapes: powers of two up to
    ``max_batch``, plus ``max_batch`` itself when it is not a power of
    two.  Non-positive ``max_batch`` is rejected with a typed
    :class:`~repro_torch.core.errors.CompileError` — the old code silently
    returned the degenerate ladder ``(0,)``, deferring the failure to a
    bare ``ValueError`` in :func:`padded_size` at dispatch time."""
    if max_batch < 1:
        raise CompileError(
            f"padding ladder needs max_batch >= 1, got {max_batch}",
            constraint="ladder-max-batch")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def padded_size(n: int, ladder: Tuple[int, ...]) -> int:
    """Smallest ladder rung >= n (n must fit the ladder's top rung)."""
    for rung in ladder:
        if rung >= n:
            return rung
    raise ValueError(f"batch of {n} exceeds ladder top {ladder[-1]}")
