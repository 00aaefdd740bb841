"""LeNet-5 through the port: ``repro_torch.models.lenet``'s layer specs,
shifts from ``calibrate_shifts`` and ``compile_network``, as
``repro_torch.lenet5_e2e.compile_lenet5`` runs them, on the benchmark's
seeded weights and calibration images."""

from __future__ import annotations

from typing import Dict

import numpy as np


def compile(config: dict, weights: Dict[str, np.ndarray], calib: np.ndarray):
    """The compiled ``NetworkProgram``.  ``calib`` holds the calibration
    images and, last, the compile-time input."""
    from repro_torch.core.network_compiler import compile_network
    from repro_torch.models.lenet import (calibrate_shifts,
                                          lenet5_specs,
                                          lenet_weights_from_arrays)
    cal = config["calibration"]
    images = [img[None] for img in calib]
    w = lenet_weights_from_arrays(weights)
    shifts = calibrate_shifts(w, images[:cal["images"]],
                              margin=cal["margin"])
    return compile_network(lenet5_specs(w, shifts), images[-1])
