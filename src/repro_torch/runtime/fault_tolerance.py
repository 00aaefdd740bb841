"""Fault-tolerant training runtime (port of the reference's
``runtime/fault_tolerance.py``: a copy, its imports changed).

``resilient_train_loop`` is the driver a cluster scheduler would invoke on
every (re)start of a job:

  1. restore the latest complete checkpoint (possibly onto a *different*
     device count — elastic re-mesh: shardings are re-derived from the
     logical spec tree against whatever mesh exists now);
  2. run steps, checkpointing every ``ckpt_every``;
  3. on a step failure (device loss manifests as an exception), retry from
     the last checkpoint up to ``max_restarts`` times — the deterministic
     data pipeline regenerates the exact same batches;
  4. a watchdog thread enforces a per-step deadline: a hung collective
     (the classic multi-pod failure mode) trips it and the loop restarts
     rather than hanging the job forever.

``FailureInjector`` deterministically raises at chosen steps — the tests
use it to prove loss trajectories are bit-identical with and without
failures (checkpoint → restart → replay is exact).

Straggler mitigation: per-step wall times feed an EWMA; steps slower than
``straggler_factor ×`` the EWMA are counted and reported so an external
scheduler can rotate the slow host out.  (In-process we can only observe;
the *mitigation* — preemptive re-scheduling — is the scheduler's move, and
our restart path is what makes that move cheap.)
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer


class StepTimeout(RuntimeError):
    pass


class FailureInjector:
    """Raises RuntimeError at the given global steps.  Repeating a step in
    ``fail_at`` fails it that many times (a deterministic 'hard' failure
    that exhausts the restart budget)."""

    def __init__(self, fail_at: List[int]):
        from collections import Counter
        self.pending = Counter(fail_at)

    def check(self, step: int) -> None:
        if self.pending.get(step, 0) > 0:
            self.pending[step] -= 1
            raise RuntimeError(f"injected failure at step {step}")


class Watchdog:
    """Per-step deadline enforcement in a daemon thread."""

    def __init__(self, deadline_s: float):
        self.deadline = deadline_s
        self._armed_at: Optional[float] = None
        self._tripped = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(min(0.05, self.deadline / 4)):
            armed = self._armed_at
            if armed is not None and time.monotonic() - armed > self.deadline:
                self._tripped.set()

    def arm(self) -> None:
        self._tripped.clear()
        self._armed_at = time.monotonic()

    def disarm(self) -> None:
        self._armed_at = None

    def check(self) -> None:
        if self._tripped.is_set():
            raise StepTimeout("step exceeded watchdog deadline")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


@dataclasses.dataclass
class StragglerStats:
    ewma_s: float = 0.0
    slow_steps: int = 0
    total_steps: int = 0

    def update(self, dt: float, factor: float = 3.0) -> bool:
        self.total_steps += 1
        if self.ewma_s == 0.0:
            self.ewma_s = dt
            return False
        slow = dt > factor * self.ewma_s
        if slow:
            self.slow_steps += 1
        # slow steps pollute the EWMA less
        alpha = 0.05 if slow else 0.2
        self.ewma_s = (1 - alpha) * self.ewma_s + alpha * dt
        return slow


@dataclasses.dataclass
class LoopReport:
    final_step: int
    restarts: int
    metrics_history: List[Dict[str, float]]
    straggler: StragglerStats


def resilient_train_loop(
    *, state: Any,
    step_fn: Callable[[Any, int], Any],
    save_tree_fn: Callable[[Any], Any],
    restore_fn: Callable[[Checkpointer, int, Any], Any],
    checkpointer: Checkpointer,
    total_steps: int,
    ckpt_every: int = 50,
    max_restarts: int = 5,
    watchdog_deadline_s: Optional[float] = None,
    failure_injector: Optional[FailureInjector] = None,
    metrics_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
) -> LoopReport:
    """Run ``step_fn(state, step) → state`` with checkpoint/restart.

    ``save_tree_fn(state)`` extracts the checkpointable pytree;
    ``restore_fn(ckptr, step, state)`` rebuilds state from a checkpoint
    (this is where elastic re-meshing happens — the caller re-derives
    shardings for the current mesh)."""
    restarts = 0
    history: List[Dict[str, float]] = []
    straggler = StragglerStats()
    watchdog = Watchdog(watchdog_deadline_s) if watchdog_deadline_s else None

    start = checkpointer.latest_step()
    step = 0
    if start is not None:
        state = restore_fn(checkpointer, start, state)
        step = start

    try:
        while step < total_steps:
            try:
                t0 = time.monotonic()
                if watchdog:
                    watchdog.arm()
                if failure_injector:
                    failure_injector.check(step)
                state = step_fn(state, step)
                if watchdog:
                    watchdog.check()
                    watchdog.disarm()
                straggler.update(time.monotonic() - t0)
                step += 1
                if metrics_fn:
                    history.append(dict(metrics_fn(state), step=step))
                if step % ckpt_every == 0 or step == total_steps:
                    checkpointer.save_async(step, save_tree_fn(state))
            except (RuntimeError, StepTimeout) as e:
                restarts += 1
                if restarts > max_restarts:
                    raise RuntimeError(
                        f"exceeded {max_restarts} restarts") from e
                checkpointer.wait()
                last = checkpointer.latest_step()
                if last is None:
                    step = 0           # restart from scratch
                else:
                    state = restore_fn(checkpointer, last, state)
                    step = last
        checkpointer.wait()
    finally:
        if watchdog:
            watchdog.stop()
    return LoopReport(final_step=step, restarts=restarts,
                      metrics_history=history, straggler=straggler)
