"""Thread-safe bounded request queue with typed admission control.

The front door of the async engine (DESIGN.md §Serving): submissions
beyond ``BatchPolicy.max_depth`` are rejected with :class:`QueueFull`
(backpressure the caller can act on — shed, retry, or degrade), and
submissions after ``close()`` raise :class:`QueueClosed`.  Nothing is
ever silently dropped.

``take_batch`` is the worker side: it blocks until the shared
:func:`~repro_torch.serving.vta.policy.ready_count` decision function says a
batch is ready (full, or the oldest request aged past ``max_wait_s``, or
the queue is closed and draining), then pops the batch FIFO.  Returns
``None`` exactly once per worker when the queue is closed *and* empty —
the graceful drain-and-shutdown handshake.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, List, Optional

import numpy as np

from .policy import BatchPolicy, ready_count


class QueueFull(RuntimeError):
    """Admission control rejected the request (backpressure)."""

    def __init__(self, depth: int, max_depth: int):
        self.depth = depth
        self.max_depth = max_depth
        super().__init__(
            f"request queue full: depth {depth} >= max_depth {max_depth} "
            f"(backpressure — retry later or shed load)")


class QueueClosed(RuntimeError):
    """The queue no longer accepts submissions (shutdown in progress)."""


class ServingError(RuntimeError):
    """A request could not produce a result (execution failure or guard
    outcome ``failed``) — surfaced on ``Ticket.result()``, never as a
    silently missing/wrong answer."""


class Ticket:
    """Caller-side handle for one submitted request (a minimal future)."""

    def __init__(self, rid: int, image: np.ndarray, enqueue_t: float):
        self.rid = rid
        self.image = image
        self.enqueue_t = enqueue_t
        self.record = None                   # RequestRecord once completed
        self.guard_report = None             # GuardReport under guard=
        self._event = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    # worker side ------------------------------------------------------
    def resolve(self, result: Optional[np.ndarray],
                error: Optional[BaseException] = None) -> None:
        self._result = result
        self._error = error
        self._event.set()

    # caller side ------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid}: no result within "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class RequestQueue:
    """FIFO of :class:`Ticket` with bounded depth and drain semantics."""

    def __init__(self, policy: BatchPolicy):
        self.policy = policy
        self._cond = threading.Condition()
        self._items: deque = deque()
        self._closed = False

    def depth(self) -> int:
        with self._cond:
            return len(self._items)

    def submit(self, ticket: Ticket) -> None:
        with self._cond:
            if self._closed:
                raise QueueClosed(
                    f"request {ticket.rid}: queue is closed (engine "
                    f"shutting down)")
            if len(self._items) >= self.policy.max_depth:
                raise QueueFull(len(self._items), self.policy.max_depth)
            self._items.append(ticket)
            self._cond.notify_all()

    def take_batch(self, clock) -> Optional[List[Ticket]]:
        """Block until a batch is ready per the shared policy; ``None``
        when closed and fully drained."""
        with self._cond:
            while True:
                now = clock.now()
                n = ready_count(
                    len(self._items),
                    self._items[0].enqueue_t if self._items else 0.0,
                    now, self.policy, closed=self._closed)
                if n:
                    batch = [self._items.popleft() for _ in range(n)]
                    self._cond.notify_all()   # free depth → unblock waiters
                    return batch
                if self._closed:              # closed and empty: drain done
                    return None
                if self._items:
                    # partial batch: sleep until the oldest request's
                    # max-wait deadline (submissions/close notify earlier)
                    deadline = (self._items[0].enqueue_t
                                + self.policy.max_wait_s)
                    self._cond.wait(timeout=max(0.0, deadline - now))
                else:
                    self._cond.wait()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def cancel_pending(self) -> List[Ticket]:
        """Pop every queued ticket (the non-draining shutdown path); the
        caller resolves them with :class:`QueueClosed` errors."""
        with self._cond:
            items = list(self._items)
            self._items.clear()
            self._cond.notify_all()
            return items
