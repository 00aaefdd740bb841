"""queue_wait_p95_ms: the nearest-rank p95, over the requests due in the
window, of the time each waited in the engine's queue for the batch
former: ``RequestRecord.dispatch_t - enqueue_t``, in milliseconds."""

from perfbench.lib import harness


def read(rec: dict):
    req = rec.get("requests")
    if not req or not len(req["dispatch"]):
        return None
    return harness.nearest_rank(req["dispatch"] - req["enqueue"], 95) * 1e3
