"""Weights carried across from the reference package.

A model's weights travel between the two packages as a mapping of named
numpy arrays (``dataclasses.asdict`` of either package's weight
dataclass).  :func:`checked_arrays` holds such a mapping to a model's
table of names and shapes: every name present and no other, each array
of its shape, ``*_w`` int8 and ``*_b`` int32.  A fault raises
:class:`WeightsError` naming the entry and the constraint it breaks.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np


class WeightsError(ValueError):
    """A weights mapping does not fit its model.  ``name`` is the offending
    entry (None for a set-level fault); ``constraint`` one of
    ``weights-missing``, ``weights-unexpected``, ``weights-shape``,
    ``weights-dtype``."""

    def __init__(self, message: str, *, name: Optional[str],
                 constraint: str):
        self.name = name
        self.constraint = constraint
        super().__init__(f"{message} [constraint: {constraint}]")


def checked_arrays(arrays: Mapping[str, np.ndarray],
                   shapes: Mapping[str, Tuple[int, ...]],
                   model: str) -> Dict[str, np.ndarray]:
    """``arrays`` held to ``shapes`` (name → shape) of ``model``; returns
    the arrays by name, in the table's order."""
    missing = sorted(set(shapes) - set(arrays))
    if missing:
        raise WeightsError(f"missing {model} weights {missing}",
                           name=missing[0], constraint="weights-missing")
    extra = sorted(set(arrays) - set(shapes))
    if extra:
        raise WeightsError(f"unexpected weights {extra}", name=extra[0],
                           constraint="weights-unexpected")
    checked = {}
    for name, shape in shapes.items():
        arr = np.asarray(arrays[name])
        if arr.shape != tuple(shape):
            raise WeightsError(f"{name} has shape {arr.shape}, {model} "
                               f"needs {tuple(shape)}", name=name,
                               constraint="weights-shape")
        want = np.int8 if name.endswith("_w") else np.int32
        if arr.dtype != want:
            raise WeightsError(f"{name} is {arr.dtype}, {model} needs "
                               f"{np.dtype(want)}", name=name,
                               constraint="weights-dtype")
        checked[name] = arr
    return checked
