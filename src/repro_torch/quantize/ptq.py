"""Two-phase §4.2 weight-scale calibration for integer-weight graph models.

Copied from the reference's ``quantize/ptq.py``: the one function of that
module the port's graph models (resnet8, resnet_tiny) need.  The rest of
it — float weights to int8 (``quantize_network``) — belongs to the float
front door, which the port does not have yet.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.graph import plan_requant


def calibrate_integer_weight_exps(build_probe, calib: Sequence[np.ndarray],
                                  linear_nodes: Sequence[str], *,
                                  margin: int = 1,
                                  octave_keep: Sequence[str] = ()
                                  ) -> Dict[str, int]:
    """Two-phase §4.2 weight-scale calibration for *integer-weight*
    graph models — the model-agnostic generalisation of the two
    model-private ``calibrate_weight_exps`` copies that used to live in
    ``models/resnet_tiny.py`` and ``models/resnet8.py``.

    Random int8 weights amplify (a k3 conv over 16 channels gains ~2^5),
    so with ``weight_exp = 0`` the raw-integer skip of a residual block
    sits many octaves above its branch.  Real quantised CNNs absorb that
    gain into the *weight scale*: each linear node's ``weight_exp`` is
    set to its planned requant shift over a throwaway probe graph
    (``build_probe()`` → unplanned graph with ``weight_exp = 0``), which
    normalises every post-requant activation to scale ≈ 0 — the
    trained-network situation.  Nodes in ``octave_keep`` then keep one
    octave of gain (``- 1``) so their join operands land scales apart
    and the planner must equalise with a genuine on-device pre-shift.
    """
    probe = build_probe()
    plan = plan_requant(probe, list(calib), margin=margin)
    exps = {name: plan.shifts[f"{name}_q"] for name in linear_nodes}
    for name in octave_keep:
        exps[name] -= 1
    return exps
