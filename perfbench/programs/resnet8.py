"""resnet8 through the port: ``repro_torch.models.resnet8``'s graph,
its two-phase calibration and ``repro_torch.graph.compile_graph``, as
``compile_resnet8`` runs them, on the benchmark's seeded weights and
calibration images."""

from __future__ import annotations

from typing import Dict

import numpy as np


def compile(config: dict, weights: Dict[str, np.ndarray], calib: np.ndarray):
    """The compiled ``NetworkProgram``.  ``calib`` holds the calibration
    images and, last, the compile-time input."""
    from repro_torch.graph import compile_graph
    from repro_torch.models.resnet8 import (build_resnet8,
                                            calibrate_weight_exps,
                                            resnet8_weights_from_arrays)
    cal = config["calibration"]
    images = [img[None] for img in calib]
    w = resnet8_weights_from_arrays(weights)
    wexps = calibrate_weight_exps(w, images[:cal["images"]],
                                  margin=cal["margin"])
    return compile_graph(build_resnet8(w, wexps), images[-1], calib=images,
                         margin=cal["margin"])
