"""admission_p95_ms: the nearest-rank p95, over the requests due in the
window, of the time from each request's due time to its entry into the
engine's queue (``RequestRecord.enqueue_t``): how late the receiving
thread submitted it, the arrivals' process's lateness included, in
milliseconds."""

from perfbench.lib import harness


def read(rec: dict):
    req = rec.get("requests")
    if not req or not len(req["enqueue"]):
        return None
    return harness.nearest_rank(req["enqueue"] - req["due"], 95) * 1e3
