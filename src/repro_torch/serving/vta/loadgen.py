"""Seeded deterministic load generation (DESIGN.md §Serving).

Two arrival processes, both pure functions of their seed so the
virtual-clock simulation replays bit-identically:

* **Poisson (open loop)** — exponential inter-arrival gaps at a given
  offered load in requests/second; models independent user traffic and
  is what the throughput–latency curves sweep
  (EXPERIMENTS.md §Serving-latency).
* **Closed loop** — N clients, each keeping exactly one request in
  flight and re-submitting ``think_s`` after its completion (or after a
  backpressure rejection); models a fixed client population and bounds
  concurrency by construction.

Sources speak one small interface consumed by
:func:`repro_torch.serving.vta.simulate.simulate`: ``initial_arrivals()`` plus
``on_complete``/``on_reject`` callbacks that may schedule more arrivals,
and ``image_for(rid)`` when batches are really executed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def poisson_arrival_times(rate_rps: float, n: int, seed: int,
                          start: float = 0.0) -> List[float]:
    """n seeded Poisson-process arrival times at ``rate_rps``."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return list(start + np.cumsum(gaps))


def request_images(net, n: int, seed: int) -> List[np.ndarray]:
    """n seeded request images matching the network's compiled input
    signature (the engine's admission contract)."""
    shape, dtype = net.input_signature()
    rng = np.random.default_rng(seed)
    return [rng.integers(-64, 64, shape).astype(dtype) for _ in range(n)]


class PoissonSource:
    """Open-loop source: every arrival time is fixed up front."""

    def __init__(self, rate_rps: float, n: int, seed: int,
                 images: Optional[Sequence[np.ndarray]] = None):
        self.n = n
        self.times = poisson_arrival_times(rate_rps, n, seed)
        self.images = list(images) if images is not None else None

    def initial_arrivals(self) -> List[Tuple[float, int]]:
        return [(t, rid) for rid, t in enumerate(self.times)]

    def on_complete(self, rid: int, t: float) -> List[Tuple[float, int]]:
        return []

    def on_reject(self, rid: int, t: float) -> List[Tuple[float, int]]:
        return []        # open loop: a shed request is simply lost

    def image_for(self, rid: int) -> np.ndarray:
        if self.images is None:
            raise ValueError("PoissonSource built without images")
        return self.images[rid % len(self.images)]


class ClosedLoopSource:
    """Closed-loop source: ``clients`` requests in flight at most, each
    client re-submitting ``think_s`` after its previous request resolves,
    until ``n`` total requests have been issued."""

    def __init__(self, clients: int, n: int, *, think_s: float = 0.0,
                 stagger_s: float = 0.0, retry_s: float = 1e-3,
                 images: Optional[Sequence[np.ndarray]] = None):
        if clients < 1:
            raise ValueError(f"clients must be >= 1, got {clients}")
        if retry_s <= 0:
            # a zero-delay retry after a rejection would re-arrive into
            # the same queue state at the same virtual instant, forever
            raise ValueError(f"retry_s must be > 0, got {retry_s}")
        self.clients = clients
        self.n = n
        self.think_s = think_s
        self.stagger_s = stagger_s
        self.retry_s = retry_s
        self.images = list(images) if images is not None else None
        self.issued = 0
        self._owner: Dict[int, int] = {}       # rid -> client

    def _issue(self, client: int, t: float) -> List[Tuple[float, int]]:
        if self.issued >= self.n:
            return []
        rid = self.issued
        self.issued += 1
        self._owner[rid] = client
        return [(t, rid)]

    def initial_arrivals(self) -> List[Tuple[float, int]]:
        out: List[Tuple[float, int]] = []
        for c in range(min(self.clients, self.n)):
            out.extend(self._issue(c, c * self.stagger_s))
        return out

    def on_complete(self, rid: int, t: float) -> List[Tuple[float, int]]:
        return self._issue(self._owner[rid], t + self.think_s)

    def on_reject(self, rid: int, t: float) -> List[Tuple[float, int]]:
        """A rejected client backs off (strictly positive delay), then
        retries with a *new* request."""
        return self._issue(self._owner[rid],
                           t + max(self.think_s, self.retry_s))

    def image_for(self, rid: int) -> np.ndarray:
        if self.images is None:
            raise ValueError("ClosedLoopSource built without images")
        return self.images[rid % len(self.images)]
