"""idle_share: the percentage of the traced window in which no operation
ran on the device (one less the union of the device operations'
intervals over the window)."""

from perfbench.lib import trace


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    lo, hi = trace.window(tr)
    return 100.0 * (1.0 - trace.busy_us(tr) / (hi - lo))
