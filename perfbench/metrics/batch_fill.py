"""batch_fill: the mean, over the batches that served the window's
requests, of the real requests a batch holds over the rows of the ladder
rung it was padded to (``RequestRecord.batch_size / padded_size``), in
percent: the share of the device's rows that serve a request."""

import numpy as np


def read(rec: dict):
    req = rec.get("requests")
    if not req or not len(req["batch"]):
        return None
    # one batch: one worker's dispatch time
    _, first = np.unique(np.stack([req["worker"], req["dispatch"]]),
                         axis=1, return_index=True)
    return float(100.0 * np.mean(req["batch"][first] / req["padded"][first]))
