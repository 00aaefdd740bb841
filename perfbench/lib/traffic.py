"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and the configuration's input (``input``: shape
and the range of the int8 values) and draws the images from the seed.

``offline`` (MLPerf Inference's Offline scenario): the whole sample set is
there at once, so one caller issues ``serve`` calls of
``images_per_call`` images back to back, taking the batches of a pool of
``pool_batches`` in turn.

The images are uniform int8 over ``[low, high)``, as the port's seeded
request generators draw them (``serving/vta/loadgen.request_images``,
``lenet5_e2e.request_images``), drawn in one call a batch.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import seeds

KINDS = ("offline",)


def images(config: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` images ``(n,) + input shape``, int8, uniform over the
    configuration's ``[low, high)``."""
    spec = config["input"]
    return rng.integers(spec["low"], spec["high"],
                        (n,) + tuple(spec["shape"]), dtype=np.int8)


def calibration_images(config: dict, seed: int) -> np.ndarray:
    """The configuration's calibration images and, last, the compile-time
    input: ``calibration.images + 1`` images."""
    n = config["calibration"]["images"] + 1
    return images(config, n, seeds.rng(seed, seeds.CALIBRATION))


def pool(config: dict, mix: dict, seed: int,
         images_per_call: Optional[int] = None) -> List[np.ndarray]:
    """The batches the cell's calls take in turn.  ``images_per_call``
    overrides the mix's (the CPU tests run the harness small)."""
    if mix["kind"] not in KINDS:
        raise ValueError(f"traffic kind {mix['kind']!r} is not one of "
                         f"{KINDS}")
    b = images_per_call or mix["images_per_call"]
    rng = seeds.rng(seed, seeds.TRAFFIC)
    return [images(config, b, rng) for _ in range(mix["pool_batches"])]
