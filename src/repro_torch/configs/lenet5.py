"""LeNet-5 — the paper's own workload (§4.3), served through the VTA
compiler pipeline rather than the LM stack.  ``full()``/``smoke()`` return
the layer specs + weights bundle used by examples/lenet5_e2e.py."""

import dataclasses
from typing import List

from repro_torch.core.layer_compiler import LayerSpec
from repro_torch.models.lenet import (LeNetWeights, lenet5_random_weights,
                                lenet5_specs)


@dataclasses.dataclass
class LeNetBundle:
    weights: LeNetWeights
    specs: List[LayerSpec]


def full(seed: int = 0) -> LeNetBundle:
    w = lenet5_random_weights(seed=seed)
    return LeNetBundle(weights=w, specs=lenet5_specs(w))


def smoke(seed: int = 0) -> LeNetBundle:
    return full(seed)
