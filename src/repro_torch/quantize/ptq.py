"""Post-training quantization: float checkpoint → VTA-ready int8 model
(DESIGN.md §Quantization).

The PTQ scheme is the paper's §4.2 discipline generalised to *trained
float* weights:

* **Weight scales** — per linear layer, the largest power-of-2 exponent
  ``e_w`` with ``round(max|W| · 2^e_w) <= 127``: the int8 weight tensor
  represents ``W_float · 2^e_w``, using as much of the int8 range as a
  power-of-2 scale can.
* **Bias at accumulator scale** — biases add to the int32 accumulator,
  which sits at ``2^(e_in + e_w)`` above the real-valued feature, so
  ``b_int32 = round(b_float · 2^(e_in + e_w))``.
* **Activation-range scan** — requant shifts are chosen over a
  calibration batch under the *device's* truncate/saturate semantics:
  the chain path drives :func:`repro_torch.core.network_compiler.
  calibrate_network` layer by layer (interleaved with the exponent
  bookkeeping above), the graph path rides
  :func:`repro_torch.graph.plan_requant`'s ``on_linear`` hook so weights
  are quantised in place at exactly the moment the planner knows their
  input's scale (the planner *raises* on any int8 overfeed rather than
  wrapping, so the graph path is drift-free by construction).

:func:`quantize_network` is the single model-agnostic entry point: it
accepts either a flat :class:`FloatLayer` chain (LeNet-5 shape) or a
float-weighted :class:`~repro_torch.graph.Graph` (resnet8 shape) and returns a
:class:`QuantizedModel` ready to ``compile()`` into a
:class:`~repro_torch.core.network_compiler.NetworkProgram`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.errors import CompileError
from repro_torch.core.layer_compiler import LayerSpec
from repro_torch.core.network_compiler import (NetworkProgram,
                                               calibrate_network,
                                               compile_network)
from repro_torch.graph import Graph, compile_graph, plan_requant

# Float images live in [0, 1]; the device input is int8, so the front
# door maps pixel p → round(p · 2^7) clipped to int8 — input scale 2^7.
INPUT_EXP = 7

# Weight-scale search bound (|exponent|): 2^12 resolves weights down to
# ~2.4e-4 of the int8 range, far below PTQ noise for these nets.
WEIGHT_EXP_MAX = 12


@dataclasses.dataclass(frozen=True)
class FloatLayer:
    """One float layer of a sequential chain — the PTQ-side mirror of
    :class:`~repro_torch.core.layer_compiler.LayerSpec` (same fields, float
    ``weights``/``bias``, no shift: PTQ chooses ``requant_shift``)."""

    name: str
    kind: str                      # "conv" | "fc"
    weights: np.ndarray            # float (F, C, kh, kw) | (D, F)
    bias: Optional[np.ndarray] = None
    stride: int = 1
    padding: int = 0
    relu: bool = False
    pool: Optional[str] = None


def choose_weight_exp(weights: np.ndarray, *,
                      max_exp: int = WEIGHT_EXP_MAX) -> int:
    """Largest exponent ``e`` with ``round(max|W| · 2^e) <= 127``."""
    m = float(np.abs(np.asarray(weights, np.float64)).max(initial=0.0))
    if m == 0.0:
        return max_exp
    e = 0
    while e < max_exp and round(m * 2.0 ** (e + 1)) <= 127:
        e += 1
    while round(m * 2.0 ** e) > 127 and e > -max_exp:
        e -= 1
    return e


def quantize_weights(weights: np.ndarray, exp: int) -> np.ndarray:
    """``round(W · 2^exp)`` as int8 (clipped to ±127, symmetric)."""
    q = np.round(np.asarray(weights, np.float64) * 2.0 ** exp)
    return np.clip(q, -127, 127).astype(np.int8)


def quantize_bias(bias: np.ndarray, exp: int) -> np.ndarray:
    """``round(b · 2^exp)`` as int32 — ``exp`` is the accumulator scale
    ``e_in + e_w`` of the layer the bias adds into."""
    q = np.round(np.asarray(bias, np.float64) * 2.0 ** exp)
    lim = np.iinfo(np.int32).max
    return np.clip(q, -lim - 1, lim).astype(np.int32)


def quantize_images(images: np.ndarray, *,
                    input_exp: int = INPUT_EXP) -> np.ndarray:
    """Float [0, 1] images → device int8 at scale ``2^input_exp``."""
    q = np.round(np.asarray(images, np.float64) * 2.0 ** input_exp)
    return np.clip(q, -128, 127).astype(np.int8)


@dataclasses.dataclass
class QuantizedModel:
    """What PTQ decided, plus everything needed to compile and serve.

    ``weight_exps``/``shifts`` are observability (the invariant tests
    assert against them); ``calib_int`` is the quantised calibration set
    — its first image doubles as the compile-time reference input.
    """

    kind: str                           # "chain" | "graph"
    input_exp: int
    weight_exps: Dict[str, int]
    shifts: Dict[str, int]
    calib_int: List[np.ndarray]
    specs: Optional[List[LayerSpec]] = None
    graph: Optional[Graph] = None
    margin: int = 1

    def compile(self, *, cfg=None, dram_offset: int = 0,
                schedule: str = "serialized") -> NetworkProgram:
        if self.kind == "chain":
            return compile_network(self.specs, self.calib_int[0], cfg=cfg,
                                   dram_offset=dram_offset,
                                   schedule=schedule)
        return compile_graph(self.graph, self.calib_int[0],
                             calib=self.calib_int, margin=self.margin,
                             cfg=cfg, dram_offset=dram_offset,
                             schedule=schedule)

    def quantize_images(self, images: np.ndarray) -> np.ndarray:
        return quantize_images(images, input_exp=self.input_exp)


def quantize_network(model: Union[Sequence[FloatLayer], Graph],
                     calib_images: np.ndarray, *, margin: int = 1,
                     saturate: bool = False,
                     input_exp: int = INPUT_EXP) -> QuantizedModel:
    """PTQ front door: float model + float calibration images → int8
    :class:`QuantizedModel`.

    ``model`` is either a sequence of :class:`FloatLayer` (sequential
    chain) or a float-weighted :class:`~repro_torch.graph.Graph` with
    unplanned requants.  ``calib_images`` is a float ``(N, C, H, W)``
    batch in [0, 1] (N >= 1).  ``saturate`` selects the device requant
    mode the chain calibration advances under (must match how the
    compiled network will be executed).
    """
    calib = np.asarray(calib_images, np.float64)
    if calib.ndim != 4 or calib.shape[0] < 1:
        raise CompileError(
            f"calibration images must be a (N, C, H, W) float batch, "
            f"got shape {calib.shape}", constraint="calibration")
    calib_int = [quantize_images(img[None], input_exp=input_exp)
                 for img in calib]
    if isinstance(model, Graph):
        return _quantize_graph(model, calib_int, margin=margin,
                               input_exp=input_exp)
    return _quantize_chain(list(model), calib_int, margin=margin,
                           saturate=saturate, input_exp=input_exp)


def _quantize_chain(layers: List[FloatLayer],
                    calib_int: List[np.ndarray], *, margin: int,
                    saturate: bool, input_exp: int) -> QuantizedModel:
    """Sequential PTQ: weight-exp choice, bias at accumulator scale, and
    the §4.2 activation scan interleave layer by layer, because layer
    k+1's accumulator scale ``e_in + e_w`` depends on shift k."""
    e_act = input_exp
    cur = calib_int
    specs: List[LayerSpec] = []
    weight_exps: Dict[str, int] = {}
    shifts: Dict[str, int] = {}
    for fl in layers:
        if fl.kind not in ("conv", "fc"):
            raise CompileError(f"FloatLayer kind must be conv|fc, got "
                               f"{fl.kind!r}", layer=fl.name,
                               constraint="node-kind")
        e_w = choose_weight_exp(fl.weights)
        w_int = quantize_weights(fl.weights, e_w)
        b_int = (quantize_bias(fl.bias, e_act + e_w)
                 if fl.bias is not None else None)
        spec = LayerSpec(fl.name, fl.kind, w_int, b_int, stride=fl.stride,
                         padding=fl.padding, relu=fl.relu, pool=fl.pool)
        # one step of the shared device-semantics scan (shift + advance)
        (shift,), traces = calibrate_network([spec], cur, margin=margin,
                                             saturate=saturate)
        specs.append(dataclasses.replace(spec, requant_shift=shift))
        cur = traces[0]
        weight_exps[fl.name] = e_w
        shifts[fl.name] = shift
        # pool divisions cancel against their exponent gain, so the
        # activation scale steps by e_w - shift regardless of pooling
        e_act = e_act + e_w - shift
    return QuantizedModel("chain", input_exp, weight_exps, shifts,
                          list(calib_int), specs=specs, margin=margin)


def _quantize_graph(graph: Graph, calib_int: List[np.ndarray], *,
                    margin: int, input_exp: int) -> QuantizedModel:
    """Graph PTQ: ride the requant planner's topo walk — the
    ``on_linear`` hook quantises each conv/fc node in place the moment
    the planner knows its input's scale exponent (mutates ``graph``,
    exactly as :func:`plan_requant` already mutates shifts)."""
    weight_exps: Dict[str, int] = {}

    def on_linear(node, rel_exp: int) -> None:
        if not np.issubdtype(np.asarray(node.weights).dtype, np.floating):
            raise CompileError(
                f"graph PTQ expects float weights, node {node.name!r} "
                f"has dtype {node.weights.dtype}", layer=node.name,
                constraint="ptq-float-weights")
        e_w = choose_weight_exp(node.weights)
        if node.bias is not None:
            # planner exponents are relative to the graph input; the
            # absolute accumulator scale adds the input's own 2^input_exp
            node.bias = quantize_bias(node.bias, input_exp + rel_exp + e_w)
        node.weights = quantize_weights(node.weights, e_w)
        node.weight_exp = e_w
        weight_exps[node.name] = e_w

    plan = plan_requant(graph, calib_int, margin=margin,
                        on_linear=on_linear)
    return QuantizedModel("graph", input_exp, weight_exps,
                          dict(plan.shifts), list(calib_int), graph=graph,
                          margin=margin)


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
