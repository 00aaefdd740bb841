"""host_ms_per_call: host milliseconds a ``serve`` call spends outside
waiting for the device, in the traced calls: each call's span less the
runtime calls in it that waited (a synchronisation or a copy to the
host), over the calls.  Read under the profiler, which adds its own cost
to every operation."""

from perfbench.lib import trace


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["device"] or not tr["spans"]:
        return None
    spans = sum(b - a for a, b in tr["spans"])
    waits = sum(b - a for a, b in trace.union(
        [w for w in tr["waits"]
         if any(s <= w[0] and w[1] <= e for s, e in tr["spans"])]))
    return (spans - waits) / 1e3 / tr["calls"]
