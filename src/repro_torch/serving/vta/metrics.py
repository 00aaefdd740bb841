"""Per-request latency + SLO accounting for the VTA serving engine.

Every served request leaves one :class:`RequestRecord` (enqueue →
dispatch → completion timestamps, formed/padded batch sizes, backend,
worker); :class:`ServingMetrics` aggregates them into the summary the
benchmarks publish (DESIGN.md §Serving, EXPERIMENTS.md §Serving-latency):
p50/p95/p99 latency, throughput, mean batch occupancy, and SLO-violation
counts.

Percentiles use the *nearest-rank* definition on the sorted latency list
— no interpolation — so a virtual-clock run's percentiles are exactly
reproducible across machines (the deterministic-replay benchmark row
compares them bit-for-bit).

``audit()`` is the self-check the CI smoke asserts empty: counter
conservation (submitted == completed + rejected + cancelled + failed +
in-flight), timestamp monotonicity per record, and an independent
recount of the SLO-violation counter.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from fractions import Fraction
from typing import Dict, List, Optional


@dataclasses.dataclass
class RequestRecord:
    """One completed request's life cycle."""

    rid: int
    enqueue_t: float
    dispatch_t: float
    complete_t: float
    batch_size: int          # real requests in the formed batch
    padded_size: int         # stack rows actually executed (ladder rung)
    backend: str
    worker: int

    @property
    def latency_s(self) -> float:
        return self.complete_t - self.enqueue_t

    @property
    def queue_wait_s(self) -> float:
        return self.dispatch_t - self.enqueue_t

    @property
    def service_s(self) -> float:
        return self.complete_t - self.dispatch_t

    def as_tuple(self):
        """Canonical comparable form (the deterministic-replay check)."""
        return (self.rid, self.enqueue_t, self.dispatch_t, self.complete_t,
                self.batch_size, self.padded_size, self.backend, self.worker)


def nearest_rank(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) on an ascending list:
    the element at rank ``ceil(q·n/100)`` (1-based; rank 1 for q=0).

    The ceiling is computed *exactly* over the rational ``q·n/100``
    (``fractions.Fraction``, no float product): the old
    ``int(q * n)`` truncated the product before the ceiling division,
    silently under-ranking every non-integer quantile — p99.9 of 1000
    samples read rank 999 instead of 1000.
    """
    if not sorted_values:
        raise ValueError("percentile of an empty sample")
    if not 0 <= q <= 100:
        raise ValueError(f"quantile must be in [0, 100], got {q}")
    n = len(sorted_values)
    rank = max(1, math.ceil(Fraction(q) * n / 100))
    return sorted_values[min(rank, n) - 1]


class ServingMetrics:
    """Thread-safe accumulator (one per engine / simulation run)."""

    def __init__(self, slo_s: Optional[float] = None):
        self.slo_s = slo_s
        self._lock = threading.Lock()
        self.records: List[RequestRecord] = []
        self.submitted = 0
        self.rejected = 0          # QueueFull admissions
        self.cancelled = 0         # discarded by non-draining shutdown
        self.failed = 0            # execution raised / guard unrecoverable
        self.slo_violations = 0

    # ------------------------------------------------------- recording --
    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def on_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def on_cancel(self, n: int = 1) -> None:
        with self._lock:
            self.cancelled += n

    def on_fail(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def observe(self, record: RequestRecord) -> None:
        with self._lock:
            self.records.append(record)
            if self.slo_s is not None and record.latency_s > self.slo_s:
                self.slo_violations += 1

    # ------------------------------------------------------- reading ----
    def latencies_s(self) -> List[float]:
        with self._lock:
            return sorted(r.latency_s for r in self.records)

    def latency_histogram(self, n_bins: int = 20) -> List[int]:
        """Fixed-bin latency histogram over [0, max]; purely a function
        of the recorded latencies, so same-seed virtual-clock runs
        produce identical lists."""
        lats = self.latencies_s()
        if not lats:
            return [0] * n_bins
        top = lats[-1] or 1e-12
        counts = [0] * n_bins
        for lat in lats:
            idx = min(int(n_bins * lat / top), n_bins - 1)
            counts[idx] += 1
        return counts

    def summary(self) -> Dict[str, float]:
        lats = self.latencies_s()
        with self._lock:
            records = list(self.records)
            out: Dict[str, float] = {
                "submitted": self.submitted,
                "completed": len(records),
                "rejected": self.rejected,
                "cancelled": self.cancelled,
                "failed": self.failed,
                "slo_violations": self.slo_violations,
            }
        if records:
            span = (max(r.complete_t for r in records)
                    - min(r.enqueue_t for r in records))
            out["throughput_rps"] = (len(records) / span if span > 0
                                     else float("inf"))
            out["p50_ms"] = nearest_rank(lats, 50) * 1e3
            out["p95_ms"] = nearest_rank(lats, 95) * 1e3
            out["p99_ms"] = nearest_rank(lats, 99) * 1e3
            out["mean_latency_ms"] = sum(lats) / len(lats) * 1e3
            out["mean_batch_occupancy"] = (
                sum(r.batch_size for r in records) / len(records))
            out["mean_padded_size"] = (
                sum(r.padded_size for r in records) / len(records))
        return out

    def audit(self) -> List[str]:
        """Accounting self-check; returns the list of violations (empty =
        clean).  ``in_flight`` covers requests submitted but not yet
        resolved when the audit runs — an engine audited *after* drain
        must have zero."""
        errors: List[str] = []
        with self._lock:
            records = list(self.records)
            resolved = (len(records) + self.rejected + self.cancelled
                        + self.failed)
            if resolved > self.submitted:
                errors.append(
                    f"over-accounted: {resolved} resolved > "
                    f"{self.submitted} submitted")
            violations = self.slo_violations
        for r in records:
            if not (r.enqueue_t <= r.dispatch_t <= r.complete_t):
                errors.append(f"rid {r.rid}: non-monotonic timestamps "
                              f"{r.enqueue_t}/{r.dispatch_t}/{r.complete_t}")
            if not (1 <= r.batch_size <= r.padded_size):
                errors.append(f"rid {r.rid}: batch {r.batch_size} vs "
                              f"padded {r.padded_size}")
        if self.slo_s is not None:
            recount = sum(1 for r in records if r.latency_s > self.slo_s)
            if recount != violations:
                errors.append(f"slo_violations counter {violations} != "
                              f"recount {recount}")
        seen = set()
        for r in records:
            if r.rid in seen:
                errors.append(f"rid {r.rid}: completed twice")
            seen.add(r.rid)
        return errors

    def drained(self) -> bool:
        """True when every submitted request has been resolved."""
        with self._lock:
            return (len(self.records) + self.rejected + self.cancelled
                    + self.failed) == self.submitted
