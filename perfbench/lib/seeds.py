"""The run's seeded draws: weights, calibration images and the traffic
pool each from a stream of their own, so one seed gives the same inputs
in every run and a change to one draw moves no other."""

from __future__ import annotations

import numpy as np

WEIGHTS, CALIBRATION, TRAFFIC = 1, 2, 3


def rng(seed: int, stream: int, *sub: int) -> np.random.Generator:
    """The generator of ``stream`` (and of its part ``sub``, where given)
    for ``--seed`` ``seed`` (any whole number; taken modulo 2**64)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, stream, *sub]))


def weights(config: dict, seed: int) -> dict:
    """Seeded int8 weights and int32 biases of every layer, named
    ``<layer>_w`` / ``<layer>_b``: a conv's ``(out, in, k, k)``, a dense
    layer's ``(in, out)``; weights uniform in ``[-range, range]``, biases in
    ``[-bias_range, bias_range]`` (the configuration's ``weights``)."""
    r = rng(seed, WEIGHTS)
    wr, br = config["weights"]["range"], config["weights"]["bias_range"]
    out = {}
    for layer in config["layers"]:
        shape = ((layer["out"], layer["in"], layer["k"], layer["k"])
                 if layer["kind"] == "conv" else (layer["in"], layer["out"]))
        out[layer["name"] + "_w"] = r.integers(-wr, wr + 1, shape,
                                               dtype=np.int8)
        out[layer["name"] + "_b"] = r.integers(-br, br + 1, (layer["out"],),
                                               dtype=np.int32)
    return out
