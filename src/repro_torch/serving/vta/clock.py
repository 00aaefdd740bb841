"""Clock abstraction for the VTA serving engine (DESIGN.md §Serving).

Two implementations share one two-method interface (``now()`` /
``sleep_until()``):

* :class:`WallClock` — ``time.monotonic``; what the threaded
  :class:`~repro_torch.serving.vta.engine.VTAServingEngine` runs on.
* :class:`VirtualClock` — a manually-advanced monotonic counter; what the
  discrete-event simulation (:mod:`repro_torch.serving.vta.simulate`) and the
  seeded load generator run on, so latency traces are *hermetic*: the
  same seed produces bit-identical request traces and latency histograms
  on any machine, because no wall time ever enters the computation.
"""

from __future__ import annotations

import time


class WallClock:
    """Real monotonic time (the threaded engine's clock)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep_until(self, t: float) -> None:
        delay = t - self.now()
        if delay > 0:
            time.sleep(delay)


class VirtualClock:
    """Deterministic manual-advance clock (the simulation's clock).

    ``advance_to`` enforces monotonicity — a discrete-event loop that
    tried to move time backwards has a scheduling bug, and failing loudly
    here is what keeps the determinism argument (DESIGN.md §Serving)
    sound.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t < self._now:
            raise ValueError(
                f"virtual clock cannot move backwards: at {self._now!r}, "
                f"asked to advance to {t!r}")
        self._now = float(t)

    def advance(self, dt: float) -> None:
        self.advance_to(self._now + dt)

    def sleep_until(self, t: float) -> None:
        # sleeping *is* advancing when time is virtual
        if t > self._now:
            self.advance_to(t)
