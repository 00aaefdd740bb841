"""service_p95_ms: the nearest-rank p95, over the requests due in the
window, of the time from each request's batch leaving the queue to its
logits on the host: ``RequestRecord.complete_t - dispatch_t`` (padding,
``NetworkProgram.serve`` and the copy back), in milliseconds."""

from perfbench.lib import harness


def read(rec: dict):
    req = rec.get("requests")
    if not req or not len(req["complete"]):
        return None
    return harness.nearest_rank(req["complete"] - req["dispatch"], 95) * 1e3
