"""ResNet-50 v1.5 through the port: ``repro_torch.models.resnet50``'s
graph, its two-phase calibration and ``repro_torch.graph.compile_graph``,
as ``compile_resnet50`` runs them, on the benchmark's seeded weights and
calibration images.  The configuration's ``architecture`` and ``input``
give the model's shape, and its ``layers`` must be the model's."""

from __future__ import annotations

from typing import Dict

import numpy as np


def shape_of(config: dict):
    """The model's ``ResNet50Shape`` for the configuration."""
    from repro_torch.models.resnet50 import ResNet50Shape
    arch = config["architecture"]
    c, h, w = config["input"]["shape"]
    if h != w:
        raise ValueError(f"resnet50 takes a square input, got {h}x{w}")
    return ResNet50Shape(input_hw=h, in_channels=c,
                         stem_width=arch["stem_width"],
                         widths=tuple(arch["widths"]),
                         blocks=tuple(arch["blocks"]),
                         expansion=arch["expansion"],
                         classes=arch["classes"])


def compile(config: dict, weights: Dict[str, np.ndarray], calib: np.ndarray):
    """The compiled ``NetworkProgram``.  ``calib`` holds the calibration
    images and, last, the compile-time input."""
    from repro_torch.models.resnet50 import (compile_resnet50, layers,
                                             resnet50_weights_from_arrays)
    shape = shape_of(config)
    if layers(shape) != config["layers"]:
        raise ValueError("the configuration's layers are not the model's "
                         "for its architecture and input")
    cal = config["calibration"]
    images = [img[None] for img in calib]
    net, _ = compile_resnet50(resnet50_weights_from_arrays(weights, shape),
                              images[:cal["images"]], images[-1],
                              margin=cal["margin"], shape=shape)
    return net
