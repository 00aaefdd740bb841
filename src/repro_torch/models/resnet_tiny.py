"""resnet_tiny — the first *branching* workload (DESIGN.md §Graph).

A CIFAR-10-scale ResNet with **two residual joins**, built through the
graph IR (`repro_torch.graph`) rather than a flat layer list — the topology the
paper's sequential compiler could not express and the YOLO-NAS follow-up
needs:

  stem    conv 3→16  k3 same + ReLU + max-pool 2×2      (1,3,32,32) → (1,16,16,16)
  block1  conv 16→16 k3 same + ReLU                     (branch, multi-chunk)
          conv 16→16 k3 same, **add(stem out)** + ReLU  → (1,16,16,16)
  mid     conv 16→32 k3 same + ReLU + max-pool 2×2      → (1,32,8,8)
  block2  conv 32→32 k3 same + ReLU                     (branch)
          conv 32→32 k3 same, **add(mid out)**  + ReLU  → (1,32,8,8)
  head    flatten + fc 2048→10                          → (1,10) logits

Both joins close on the VTA itself: the skip activation is ACC-loaded
beside the GEMM result and merged by an ALU vector-vector ADD (DESIGN.md
§Graph) — never a host-side numpy add.  Block 1's conv matrices are
256×144 (2304 INP vectors against the 2048-vector buffer), so its layers
— including the residual one, with its halved per-chunk ACC budget — are
multi-chunk *by construction*.

The bit-exact integer reference is the graph evaluation itself
(:func:`repro_torch.graph.evaluate_graph`): one semantics shared by the
planner, the lowering and the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graph import (Graph, GraphBuilder, compile_graph,
                         evaluate_graph)

from .weights import checked_arrays

# The linear (conv/fc) nodes of the topology, in order.
LINEAR_NODES = ("stem", "b1a", "b1b", "mid", "b2a", "b2b", "head")


@dataclasses.dataclass
class ResnetTinyWeights:
    stem_w: np.ndarray    # (16, 3, 3, 3)   int8
    stem_b: np.ndarray    # (16,)           int32
    b1a_w: np.ndarray     # (16, 16, 3, 3)
    b1a_b: np.ndarray
    b1b_w: np.ndarray     # (16, 16, 3, 3)
    b1b_b: np.ndarray
    mid_w: np.ndarray     # (32, 16, 3, 3)
    mid_b: np.ndarray
    b2a_w: np.ndarray     # (32, 32, 3, 3)
    b2a_b: np.ndarray
    b2b_w: np.ndarray     # (32, 32, 3, 3)
    b2b_b: np.ndarray
    head_w: np.ndarray    # (2048, 10)
    head_b: np.ndarray


def resnet_tiny_random_weights(seed: int = 0,
                               scale: int = 6) -> ResnetTinyWeights:
    """Deterministic int8 weights in a narrow range (static power-of-2
    requant keeps every activation healthy, as for the CIFAR CNN)."""
    rng = np.random.default_rng(seed)
    w = lambda *s: rng.integers(-scale, scale + 1, s,
                                dtype=np.int64).astype(np.int8)
    b = lambda n: rng.integers(-64, 65, (n,), dtype=np.int64).astype(np.int32)
    return ResnetTinyWeights(
        stem_w=w(16, 3, 3, 3), stem_b=b(16),
        b1a_w=w(16, 16, 3, 3), b1a_b=b(16),
        b1b_w=w(16, 16, 3, 3), b1b_b=b(16),
        mid_w=w(32, 16, 3, 3), mid_b=b(32),
        b2a_w=w(32, 32, 3, 3), b2a_b=b(32),
        b2b_w=w(32, 32, 3, 3), b2b_b=b(32),
        head_w=w(2048, 10), head_b=b(10),
    )


RESNET_TINY_SHAPES: Dict[str, Tuple[int, ...]] = {
    "stem_w": (16, 3, 3, 3), "stem_b": (16,),
    "b1a_w": (16, 16, 3, 3), "b1a_b": (16,),
    "b1b_w": (16, 16, 3, 3), "b1b_b": (16,),
    "mid_w": (32, 16, 3, 3), "mid_b": (32,),
    "b2a_w": (32, 32, 3, 3), "b2a_b": (32,),
    "b2b_w": (32, 32, 3, 3), "b2b_b": (32,),
    "head_w": (2048, 10), "head_b": (10,),
}


def resnet_tiny_weights_from_arrays(arrays: Mapping[str, np.ndarray]
                                    ) -> ResnetTinyWeights:
    """Checked :class:`ResnetTinyWeights` from named arrays (the
    reference's weight dataclass as ``dataclasses.asdict``): every name of
    :data:`RESNET_TINY_SHAPES` present and no other, each of its shape,
    ``*_w`` int8 and ``*_b`` int32; a fault raises
    :class:`~repro_torch.models.weights.WeightsError`."""
    return ResnetTinyWeights(**checked_arrays(arrays, RESNET_TINY_SHAPES,
                                              "resnet_tiny"))


def _basic_block(bld: GraphBuilder, name: str, x: str, wa, ba, wb, bb,
                 wexp) -> str:
    """conv+ReLU, conv, on-VTA residual add of ``x``, ReLU — the classic
    pre-downsample ResNet basic block (requants planned by the pass)."""
    v = bld.conv(f"{name}a", x, wa, ba, padding=1,
                 weight_exp=wexp(f"{name}a"))
    v = bld.relu(f"{name}a_r", v)
    v = bld.requant(f"{name}a_q", v)
    v = bld.conv(f"{name}b", v, wb, bb, padding=1,
                 weight_exp=wexp(f"{name}b"))
    v = bld.requant(f"{name}b_q", v)
    v = bld.add(f"{name}_join", v, x)
    v = bld.relu(f"{name}_r", v)
    return bld.requant(f"{name}_q", v)


def build_resnet_tiny(weights: ResnetTinyWeights,
                      weight_exps: Optional[Dict[str, int]] = None) -> Graph:
    """The resnet_tiny DAG (unplanned requants; ≥2 residual joins).

    ``weight_exps`` maps linear-node name → the fixed-point scale of its
    int8 weights (see :func:`calibrate_weight_exps`); the requant planner
    uses it to equalise the two branch joins in *real* feature scale.
    """
    wexp = lambda n: (weight_exps or {}).get(n, 0)
    bld = GraphBuilder("resnet_tiny")
    x = bld.input("image", shape=(1, 3, 32, 32))
    v = bld.conv("stem", x, weights.stem_w, weights.stem_b, padding=1,
                 weight_exp=wexp("stem"))
    v = bld.relu("stem_r", v)
    v = bld.pool("stem_p", v, "max2x2")
    v = bld.requant("stem_q", v)
    v = _basic_block(bld, "b1", v, weights.b1a_w, weights.b1a_b,
                     weights.b1b_w, weights.b1b_b, wexp)
    v = bld.conv("mid", v, weights.mid_w, weights.mid_b, padding=1,
                 weight_exp=wexp("mid"))
    v = bld.relu("mid_r", v)
    v = bld.pool("mid_p", v, "max2x2")
    v = bld.requant("mid_q", v)
    v = _basic_block(bld, "b2", v, weights.b2a_w, weights.b2a_b,
                     weights.b2b_w, weights.b2b_b, wexp)
    v = bld.flatten("flat", v)
    v = bld.fc("head", v, weights.head_w, weights.head_b,
               weight_exp=wexp("head"))
    v = bld.requant("head_q", v)
    bld.output(v)
    return bld.build()


def calibrate_weight_exps(weights: ResnetTinyWeights,
                          calib: Sequence[np.ndarray], *,
                          margin: int = 1) -> Dict[str, int]:
    """Per-conv fixed-point weight scales from a calibration pass.

    Random int8 weights amplify (a k3 conv over 16 channels gains ~2^5),
    so with ``weight_exp = 0`` the raw-integer skip of a residual block
    sits many octaves above its branch and the join planner would
    rightly shift it to nothing.  Real quantised CNNs absorb that gain
    into the *weight scale*: we calibrate each linear node's
    ``weight_exp`` to its planned requant shift (a plan over a throwaway
    graph), which normalises every post-requant activation to scale ≈ 0
    — the trained-network situation the blueprint's two-operand ALU was
    designed for.  The b2 block then deliberately keeps one octave of
    gain per conv (``- 1``), so its join operands land two scales apart
    and the planner must equalise with a genuine on-device pre-shift.

    Delegates to the model-agnostic
    :func:`repro_torch.quantize.ptq.calibrate_integer_weight_exps` (imported
    lazily so models/ does not pull the quantize stack at import time).
    """
    from repro_torch.quantize.ptq import calibrate_integer_weight_exps
    return calibrate_integer_weight_exps(
        lambda: build_resnet_tiny(weights), calib, LINEAR_NODES,
        margin=margin, octave_keep=("b2a", "b2b"))


def synthetic_image(seed: int = 0) -> np.ndarray:
    """A deterministic 3×32×32 int8 test image (centred dynamic range)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-64, 64, (1, 3, 32, 32),
                        dtype=np.int64).astype(np.int8)


def compile_resnet_tiny(weights: Optional[ResnetTinyWeights] = None, *,
                        calib_seeds: Sequence[int] = range(1, 9),
                        input_seed: int = 0, margin: int = 1):
    """Build + plan + compile resnet_tiny; returns ``(net, graph)``.

    Two-phase §4.2 calibration: first the weight scales
    (:func:`calibrate_weight_exps`), then the requant/pre-shift plan over
    the final graph.  The returned graph carries the planned shifts, so
    :func:`repro_torch.graph.evaluate_graph` on it *is* the bit-exact integer
    reference for the compiled network."""
    weights = weights or resnet_tiny_random_weights()
    calib = [synthetic_image(s) for s in calib_seeds]
    wexps = calibrate_weight_exps(weights, calib, margin=margin)
    graph = build_resnet_tiny(weights, wexps)
    net = compile_graph(graph, synthetic_image(input_seed),
                        calib=calib + [synthetic_image(input_seed)],
                        margin=margin)
    return net, graph


def reference_forward_int8(graph: Graph, image: np.ndarray) -> np.ndarray:
    """Bit-exact integer logits for a *planned* graph (the semantics the
    VTA execution must reproduce)."""
    vals = evaluate_graph(graph, np.asarray(image).astype(np.int64))
    return vals[graph.outputs[0]].astype(np.int8)
