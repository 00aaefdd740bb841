"""mfu: the whole network's share of the card's int8 peak over the
untraced window: the configuration's multiply-accumulates an image
(``lib/shapes.py``, two operations each) times the images the window's
calls returned, over the window's seconds, over the peak, in percent."""

from perfbench.lib import peaks, shapes


def read(rec: dict):
    peak = peaks.peak(rec["device"]["kind"])
    win = rec["window"]
    if peak is None or not win["seconds"]:
        return None
    ops = 2 * shapes.macs_per_image(rec["config"]) * win["images"]
    return 100.0 * ops / win["seconds"] / peak["int8_ops_per_s"]
