"""Typed compiler diagnostics (certification-style traceability).

The paper's workflow argument rests on every compilation failure being
*traceable*: a rejected layer must name itself and the constraint it
violated, not die on a bare assert three stack frames deep.
:class:`CompileError` is the single exception type the lowering stack
raises for unsupported shapes, strides, pool kinds, SRAM-capacity
violations and requant overflows; it subclasses :class:`ValueError` so
pre-existing callers (and tests) that caught ``ValueError`` keep working.

Convention: ``layer`` names the :class:`~repro_torch.core.layer_compiler.LayerSpec`
(or graph node) being compiled; ``constraint`` is a short machine-greppable
identifier of the violated rule (e.g. ``"conv-input-rank"``,
``"acc-chunk-capacity"``), stable across message rewordings.
"""

from __future__ import annotations

from typing import Optional


class CompileError(ValueError):
    """A layer/program cannot be lowered to the VTA.

    Attributes
    ----------
    layer:
        Name of the layer (or graph node) being compiled, when known.
    constraint:
        Short identifier of the violated constraint — stable for tests
        and tooling to match on, independent of message wording.
    """

    def __init__(self, message: str, *, layer: Optional[str] = None,
                 constraint: Optional[str] = None):
        self.layer = layer
        self.constraint = constraint
        parts = []
        if layer is not None:
            parts.append(f"layer {layer!r}: ")
        parts.append(message)
        if constraint is not None:
            parts.append(f" [constraint: {constraint}]")
        super().__init__("".join(parts))
