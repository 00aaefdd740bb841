"""Float-parameter → PTQ-model bridges for the repo's two topologies.

Parameter dicts (from :mod:`repro_torch.quantize.train` or an imported
``.npz`` checkpoint) become the float inputs :func:`repro_torch.quantize.ptq.
quantize_network` accepts: LeNet-5 as a flat :class:`FloatLayer` chain
mirroring :func:`repro_torch.models.lenet.lenet5_specs`, resnet8 as a
float-weighted graph built by the *same*
:func:`repro_torch.models.resnet8.build_resnet8` the int8 model uses (the IR
carries dtype-agnostic arrays; PTQ quantises the nodes in place).
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from repro_torch.graph import Graph

from .ptq import FloatLayer

CHANNELS = {"lenet5": 1, "resnet8": 3}


def lenet5_float_layers(params: Dict[str, np.ndarray]) -> List[FloatLayer]:
    """The five float layers of §4.3, field-for-field against
    :func:`repro_torch.models.lenet.lenet5_specs`."""
    return [
        FloatLayer("l1_conv", "conv", params["conv1_w"], params["conv1_b"],
                   relu=True, pool="avg2x2"),
        FloatLayer("l2_conv", "conv", params["conv2_w"], params["conv2_b"],
                   relu=True, pool="avg2x2"),
        FloatLayer("l3_conv", "conv", params["conv3_w"], params["conv3_b"],
                   relu=True),
        FloatLayer("l4_fc", "fc", params["fc4_w"], params["fc4_b"],
                   relu=True),
        FloatLayer("l5_fc", "fc", params["fc5_w"], params["fc5_b"]),
    ]


def resnet8_float_graph(params: Dict[str, np.ndarray]) -> Graph:
    """The resnet8 DAG carrying float weights (unplanned requants,
    ``weight_exp=0`` placeholders) — graph PTQ rewrites the linear nodes
    in place during planning."""
    from repro_torch.models.resnet8 import Resnet8Weights, build_resnet8
    weights = Resnet8Weights(**{k: np.asarray(v, np.float32)
                                for k, v in params.items()})
    return build_resnet8(weights)


def float_model(net: str, params: Dict[str, np.ndarray]
                ) -> Union[List[FloatLayer], Graph]:
    """The :func:`quantize_network`-ready float model for ``net``."""
    if net == "lenet5":
        return lenet5_float_layers(params)
    if net == "resnet8":
        return resnet8_float_graph(params)
    raise ValueError(f"net must be lenet5|resnet8, got {net!r}")
