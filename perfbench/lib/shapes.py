"""The network's GEMMs from the configuration's published shapes: a conv
of ``in`` → ``out`` channels, kernel ``k``, on an ``hw`` × ``hw`` input is
``M = batch · Ho · Wo``, ``K = in · k · k``, ``N = out``; a dense layer
``M = batch``, ``K = in``, ``N = out``.  Padding the port adds to fit its
blocks is not counted: the counts are the work the network needs,
whatever runs it."""

from __future__ import annotations

from typing import List, Tuple


def out_hw(layer: dict) -> int:
    return (layer["hw"] + 2 * layer["pad"] - layer["k"]) // layer["stride"] + 1


def gemms(config: dict, batch: int) -> List[Tuple[str, int, int, int]]:
    """``(layer, M, K, N)`` of every layer for ``batch`` images."""
    out = []
    for layer in config["layers"]:
        if layer["kind"] == "conv":
            ho = out_hw(layer)
            out.append((layer["name"], batch * ho * ho,
                        layer["in"] * layer["k"] ** 2, layer["out"]))
        else:
            out.append((layer["name"], batch, layer["in"], layer["out"]))
    return out


def macs_per_image(config: dict) -> int:
    """Multiply-accumulates of one image through every layer."""
    return sum(m * k * n for _, m, k, n in gemms(config, 1))
