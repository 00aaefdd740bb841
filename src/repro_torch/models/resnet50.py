"""ResNet-50 v1.5 — the MLPerf Inference vision model, as an int8 VTA
network through the graph IR (DESIGN.md §Strided-lowering).

He et al., arXiv:1512.03385, with v1.5's stride on each bottleneck's 3×3
conv (torchvision ``resnet50``), at its published widths and 224×224
input by default:

  stem  conv 3→64 k7 s2 p3 + ReLU + max pool 3×3 s2 p1    → (1,64,56,56)
  s1–s4 bottleneck blocks (3, 4, 6, 3 of them; widths 64/128/256/512,
        expansion 4):
        a  conv 1×1 + ReLU
        b  conv 3×3 p1 + ReLU            (stride 2 in the first block of
                                          stages 2–4)
        p  conv 1×1 projection shortcut  (first block of each stage; the
                                          same stride as b: 1×1/s2)
        c  conv 1×1, **add(skip)** + ReLU (skip: the block's input or p)
  head  the last join + ReLU + global-average pool (7×7 = 49 positions),
        flatten + fc 2048→1000                             → (1,1000) logits

53 convs and one dense layer, 25.5 M int8 weights, 4.1 G multiply-
accumulates an image.  Every join closes on the VTA (ALU vector-vector
ADD against the ACC-loaded skip), the max pool runs in the stem's VTA
program (``max3x3s2``: MAX pairs into each window's centre) and the GAP
in the last join's (its ADD tree after the join's ReLU).  As in resnet8
the network is integer: power-of-two requant shifts with the int8 wrap,
BatchNorm folded into the seeded weights and biases, and the GAP a sum
whose ÷49 is left to the planned requant shift (a power of two).

:class:`ResNet50Shape` sets the widths, depth and input, so the tests
build the same topology small.  The bit-exact integer reference is the
graph evaluation itself (:func:`repro_torch.graph.evaluate_graph`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hwconfig import VTAConfig
from repro_torch.graph import Graph, GraphBuilder, compile_graph

from .weights import checked_arrays


@dataclasses.dataclass(frozen=True)
class ResNet50Shape:
    """The published ResNet-50 by default; any widths, block counts and
    input size give the same topology."""

    input_hw: int = 224
    in_channels: int = 3
    stem_width: int = 64
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    blocks: Tuple[int, ...] = (3, 4, 6, 3)
    expansion: int = 4
    classes: int = 1000


def layers(shape: ResNet50Shape = ResNet50Shape()) -> List[dict]:
    """The linear layers in order, each ``{name, kind, in, out, k, stride,
    pad, hw, relu}`` (``hw`` the input's side) and, where the layer's
    program has a TensorAlu epilogue, ``alu``: ``maxpool3x3s2`` (the
    stem), ``join`` (a block's c conv) or ``join+gap`` (the last one).
    A c conv's ReLU comes after its join (``relu`` false here)."""
    out: List[dict] = []

    def conv(name, cin, cout, k, stride, pad, hw, relu, alu=None):
        entry = {"name": name, "kind": "conv", "in": cin, "out": cout,
                 "k": k, "stride": stride, "pad": pad, "hw": hw,
                 "relu": relu}
        if alu:
            entry["alu"] = alu
        out.append(entry)
        return (hw + 2 * pad - k) // stride + 1

    hw = conv("stem", shape.in_channels, shape.stem_width, 7, 2, 3,
              shape.input_hw, True, "maxpool3x3s2")
    hw = (hw - 1) // 2 + 1
    cin = shape.stem_width
    last = (len(shape.widths), shape.blocks[-1])
    for i, (width, count) in enumerate(zip(shape.widths, shape.blocks), 1):
        cout = width * shape.expansion
        for j in range(1, count + 1):
            name = f"s{i}b{j}"
            stride = 2 if j == 1 and i > 1 else 1
            conv(name + "a", cin, width, 1, 1, 0, hw, True)
            hw_b = conv(name + "b", width, width, 3, stride, 1, hw, True)
            if j == 1:
                conv(name + "p", cin, cout, 1, stride, 0, hw, False)
            conv(name + "c", width, cout, 1, 1, 0, hw_b, False,
                 "join+gap" if (i, j) == last else "join")
            cin, hw = cout, hw_b
    out.append({"name": "fc", "kind": "fc", "in": cin, "out": shape.classes,
                "relu": False})
    return out


def linear_nodes(shape: ResNet50Shape = ResNet50Shape()) -> Tuple[str, ...]:
    return tuple(layer["name"] for layer in layers(shape))


def weight_shapes(shape: ResNet50Shape = ResNet50Shape()
                  ) -> Dict[str, Tuple[int, ...]]:
    """Name → shape of every weight and bias: a conv's ``(out, in, k, k)``,
    the dense layer's ``(in, out)``."""
    table: Dict[str, Tuple[int, ...]] = {}
    for layer in layers(shape):
        table[layer["name"] + "_w"] = (
            (layer["out"], layer["in"], layer["k"], layer["k"])
            if layer["kind"] == "conv" else (layer["in"], layer["out"]))
        table[layer["name"] + "_b"] = (layer["out"],)
    return table


def resnet50_random_weights(shape: ResNet50Shape = ResNet50Shape(),
                            seed: int = 0, scale: int = 5,
                            bias_scale: int = 64) -> Dict[str, np.ndarray]:
    """Deterministic int8 weights in ``[-scale, scale]`` and int32 biases in
    ``[-bias_scale, bias_scale]`` (resnet8's ranges), in layer order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in weight_shapes(shape).items():
        if name.endswith("_w"):
            out[name] = rng.integers(-scale, scale + 1, s,
                                     dtype=np.int64).astype(np.int8)
        else:
            out[name] = rng.integers(-bias_scale, bias_scale + 1, s,
                                     dtype=np.int64).astype(np.int32)
    return out


def resnet50_weights_from_arrays(arrays: Mapping[str, np.ndarray],
                                 shape: ResNet50Shape = ResNet50Shape()
                                 ) -> Dict[str, np.ndarray]:
    """Checked weights from named arrays: every name of
    :func:`weight_shapes` present and no other, each of its shape, ``*_w``
    int8 and ``*_b`` int32; a fault raises
    :class:`~repro_torch.models.weights.WeightsError`."""
    return checked_arrays(arrays, weight_shapes(shape), "resnet50")


def build_resnet50(weights: Mapping[str, np.ndarray],
                   weight_exps: Optional[Dict[str, int]] = None,
                   shape: ResNet50Shape = ResNet50Shape()) -> Graph:
    """The ResNet-50 DAG with unplanned requants.  ``weight_exps`` maps a
    linear node's name to the fixed-point scale of its int8 weights (see
    :func:`calibrate_weight_exps`)."""
    wexp = lambda n: (weight_exps or {}).get(n, 0)
    bld = GraphBuilder("resnet50")
    by_name = {layer["name"]: layer for layer in layers(shape)}

    def conv(name: str, x: str) -> str:
        layer = by_name[name]
        return bld.conv(name, x, weights[name + "_w"], weights[name + "_b"],
                        stride=layer["stride"], padding=layer["pad"],
                        weight_exp=wexp(name))

    x = bld.input("image", shape=(1, shape.in_channels, shape.input_hw,
                                  shape.input_hw))
    v = bld.relu("stem_r", conv("stem", x))
    v = bld.pool("stem_pool", v, "max3x3s2")
    v = bld.requant("stem_q", v)
    for i, count in enumerate(shape.blocks, 1):
        for j in range(1, count + 1):
            n = f"s{i}b{j}"
            a = bld.requant(n + "a_q", bld.relu(n + "a_r", conv(n + "a", v)))
            b = bld.requant(n + "b_q", bld.relu(n + "b_r", conv(n + "b", a)))
            skip = (bld.requant(n + "p_q", conv(n + "p", v))
                    if n + "p" in by_name else v)
            c = bld.requant(n + "c_q", conv(n + "c", b))
            v = bld.relu(n + "_r", bld.add(n + "_join", c, skip))
            if (i, j) != (len(shape.blocks), count):
                v = bld.requant(n + "_q", v)
    v = bld.requant("head_q", bld.global_avg_pool("head_gap", v))
    v = bld.fc("fc", bld.flatten("flat", v), weights["fc_w"],
               weights["fc_b"], weight_exp=wexp("fc"))
    bld.output(bld.requant("fc_q", v))
    return bld.build()


def calibrate_weight_exps(weights: Mapping[str, np.ndarray],
                          calib: Sequence[np.ndarray], *, margin: int = 1,
                          shape: ResNet50Shape = ResNet50Shape()
                          ) -> Dict[str, int]:
    """Per-layer fixed-point weight scales from a calibration pass over a
    throwaway graph (the two-phase §4.2 discipline of resnet8, through
    :func:`repro_torch.quantize.ptq.calibrate_integer_weight_exps`)."""
    from repro_torch.quantize.ptq import calibrate_integer_weight_exps
    return calibrate_integer_weight_exps(
        lambda: build_resnet50(weights, shape=shape), calib,
        linear_nodes(shape), margin=margin)


def synthetic_image(seed: int = 0,
                    shape: ResNet50Shape = ResNet50Shape()) -> np.ndarray:
    """A deterministic int8 test image in [-64, 64) (resnet8's range)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-64, 64, (1, shape.in_channels, shape.input_hw,
                                  shape.input_hw),
                        dtype=np.int64).astype(np.int8)


def compile_resnet50(weights: Mapping[str, np.ndarray],
                     calib: Sequence[np.ndarray], image: np.ndarray, *,
                     margin: int = 1,
                     shape: ResNet50Shape = ResNet50Shape(),
                     cfg: Optional[VTAConfig] = None):
    """Calibrate (weight scales on ``calib``, then the requant shifts and
    pre-shifts on ``calib`` and ``image``) and compile; returns ``(net,
    graph)``, the graph carrying the planned shifts, so that
    :func:`repro_torch.graph.evaluate_graph` on it is the bit-exact
    integer reference of the compiled network."""
    calib = list(calib)
    wexps = calibrate_weight_exps(weights, calib, margin=margin, shape=shape)
    graph = build_resnet50(weights, wexps, shape)
    net = compile_graph(graph, image, calib=calib + [image], margin=margin,
                        cfg=cfg)
    return net, graph
