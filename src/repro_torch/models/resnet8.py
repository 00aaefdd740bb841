"""resnet8 — the first *ResNet-scale* workload (DESIGN.md §Strided-lowering).

A 3-stage CIFAR-10-scale ResNet-8 built through the graph IR: the
stage-transition vocabulary (stride-2 downsampling convolutions, a
projection shortcut, a global-average-pool head) the paper's "larger CNN
architectures" claim — and the YOLO-NAS follow-up — actually require:

  stem  conv 3→16   k3 s1 p1 + ReLU                    (1,3,32,32) → (1,16,32,32)
  b1    conv 16→16  k3 p1 + ReLU                       (identity basic block,
        conv 16→16  k3 p1, **add(stem out)** + ReLU     multi-chunk by
                                                        construction) → 32×32
  t2    conv 16→32  k3 **s2** p1 + ReLU                (stage transition #1)
        conv 16→32  k2 **s2** p0                       (projection shortcut)
        conv 32→32  k3 p1, **add(projection)** + ReLU  → (1,32,16,16)
  t3    conv 32→64  k3 **s2** p1 + ReLU                (stage transition #2)
        conv 32→64  k2 **s2** p0                       (projection shortcut)
        conv 64→64  k3 p1, **add(projection)** + ReLU  → (1,64,8,8)
  head  conv 64→64  k1 + ReLU + **global_avg_pool**    → (1,64,1,1)
        flatten + fc 64→10                             → (1,10) logits

Every join closes on the VTA (ALU vector-vector ADD against the
ACC-loaded skip operand); the GAP head executes as the on-device ADD-pair
tree reduction + SHR of DESIGN.md §Strided-lowering, fused with the 1×1
mixing conv into one VTA layer.  The projection shortcuts are k2/s2
convs — they tile the input exactly (the `conv-stride-tiling` grid
constraint), unlike the torch-classic lossy 1×1/s2.

The bit-exact integer reference is the graph evaluation itself
(:func:`repro_torch.graph.evaluate_graph`), shared by the planner, the
lowering and the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graph import (Graph, GraphBuilder, compile_graph,
                         evaluate_graph)

from .weights import checked_arrays

# The linear (conv/fc) nodes of the topology, in order.
LINEAR_NODES = ("stem", "b1a", "b1b", "t2a", "t2p", "t2b",
                "t3a", "t3p", "t3b", "head", "fc")


@dataclasses.dataclass
class Resnet8Weights:
    stem_w: np.ndarray    # (16, 3, 3, 3)   int8
    stem_b: np.ndarray    # (16,)           int32
    b1a_w: np.ndarray     # (16, 16, 3, 3)
    b1a_b: np.ndarray
    b1b_w: np.ndarray     # (16, 16, 3, 3)
    b1b_b: np.ndarray
    t2a_w: np.ndarray     # (32, 16, 3, 3)  stride-2 main path
    t2a_b: np.ndarray
    t2p_w: np.ndarray     # (32, 16, 2, 2)  stride-2 projection
    t2p_b: np.ndarray
    t2b_w: np.ndarray     # (32, 32, 3, 3)
    t2b_b: np.ndarray
    t3a_w: np.ndarray     # (64, 32, 3, 3)  stride-2 main path
    t3a_b: np.ndarray
    t3p_w: np.ndarray     # (64, 32, 2, 2)  stride-2 projection
    t3p_b: np.ndarray
    t3b_w: np.ndarray     # (64, 64, 3, 3)
    t3b_b: np.ndarray
    head_w: np.ndarray    # (64, 64, 1, 1)  1×1 mixing conv ahead of GAP
    head_b: np.ndarray
    fc_w: np.ndarray      # (64, 10)
    fc_b: np.ndarray


def resnet8_random_weights(seed: int = 0, scale: int = 5) -> Resnet8Weights:
    """Deterministic int8 weights in a narrow range (static power-of-2
    requant keeps every activation healthy, as for resnet_tiny)."""
    rng = np.random.default_rng(seed)
    w = lambda *s: rng.integers(-scale, scale + 1, s,
                                dtype=np.int64).astype(np.int8)
    b = lambda n: rng.integers(-64, 65, (n,), dtype=np.int64).astype(np.int32)
    return Resnet8Weights(
        stem_w=w(16, 3, 3, 3), stem_b=b(16),
        b1a_w=w(16, 16, 3, 3), b1a_b=b(16),
        b1b_w=w(16, 16, 3, 3), b1b_b=b(16),
        t2a_w=w(32, 16, 3, 3), t2a_b=b(32),
        t2p_w=w(32, 16, 2, 2), t2p_b=b(32),
        t2b_w=w(32, 32, 3, 3), t2b_b=b(32),
        t3a_w=w(64, 32, 3, 3), t3a_b=b(64),
        t3p_w=w(64, 32, 2, 2), t3p_b=b(64),
        t3b_w=w(64, 64, 3, 3), t3b_b=b(64),
        head_w=w(64, 64, 1, 1), head_b=b(64),
        fc_w=w(64, 10), fc_b=b(10),
    )


RESNET8_SHAPES: Dict[str, Tuple[int, ...]] = {
    "stem_w": (16, 3, 3, 3), "stem_b": (16,),
    "b1a_w": (16, 16, 3, 3), "b1a_b": (16,),
    "b1b_w": (16, 16, 3, 3), "b1b_b": (16,),
    "t2a_w": (32, 16, 3, 3), "t2a_b": (32,),
    "t2p_w": (32, 16, 2, 2), "t2p_b": (32,),
    "t2b_w": (32, 32, 3, 3), "t2b_b": (32,),
    "t3a_w": (64, 32, 3, 3), "t3a_b": (64,),
    "t3p_w": (64, 32, 2, 2), "t3p_b": (64,),
    "t3b_w": (64, 64, 3, 3), "t3b_b": (64,),
    "head_w": (64, 64, 1, 1), "head_b": (64,),
    "fc_w": (64, 10), "fc_b": (10,),
}


def resnet8_weights_from_arrays(arrays: Mapping[str, np.ndarray]
                                ) -> Resnet8Weights:
    """Checked :class:`Resnet8Weights` from named arrays (the reference's
    weight dataclass as ``dataclasses.asdict``): every name of
    :data:`RESNET8_SHAPES` present and no other, each of its shape, ``*_w``
    int8 and ``*_b`` int32; a fault raises
    :class:`~repro_torch.models.weights.WeightsError`."""
    return Resnet8Weights(**checked_arrays(arrays, RESNET8_SHAPES,
                                           "resnet8"))


def _identity_block(bld: GraphBuilder, name: str, x: str, wa, ba, wb, bb,
                    wexp) -> str:
    """conv+ReLU, conv, on-VTA residual add of ``x``, ReLU — the classic
    same-resolution ResNet basic block."""
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


def _downsample_block(bld: GraphBuilder, name: str, x: str, wa, ba, wp, bp,
                      wb, bb, wexp) -> str:
    """The stride-2 stage transition (DESIGN.md §Strided-lowering):
    k3/s2/p1 conv + ReLU, k2/s2 projection shortcut of ``x``, k3/s1 conv,
    on-VTA residual add of the projection, ReLU."""
    v = bld.conv(f"{name}a", x, wa, ba, stride=2, padding=1,
                 weight_exp=wexp(f"{name}a"))
    v = bld.relu(f"{name}a_r", v)
    v = bld.requant(f"{name}a_q", v)
    p = bld.conv(f"{name}p", x, wp, bp, stride=2,
                 weight_exp=wexp(f"{name}p"))
    p = bld.requant(f"{name}p_q", p)
    v = bld.conv(f"{name}b", v, wb, bb, padding=1,
                 weight_exp=wexp(f"{name}b"))
    v = bld.requant(f"{name}b_q", v)
    v = bld.add(f"{name}_join", v, p)
    v = bld.relu(f"{name}_r", v)
    return bld.requant(f"{name}_q", v)


def build_resnet8(weights: Resnet8Weights,
                  weight_exps: Optional[Dict[str, int]] = None) -> Graph:
    """The resnet8 DAG (unplanned requants; 3 joins, 4 stride-2 convs,
    GAP head).  ``weight_exps`` maps linear-node name → the fixed-point
    scale of its int8 weights (see :func:`calibrate_weight_exps`)."""
    wexp = lambda n: (weight_exps or {}).get(n, 0)
    bld = GraphBuilder("resnet8")
    x = bld.input("image", shape=(1, 3, 32, 32))
    v = bld.conv("stem", x, weights.stem_w, weights.stem_b, padding=1,
                 weight_exp=wexp("stem"))
    v = bld.relu("stem_r", v)
    v = bld.requant("stem_q", v)
    v = _identity_block(bld, "b1", v, weights.b1a_w, weights.b1a_b,
                        weights.b1b_w, weights.b1b_b, wexp)
    v = _downsample_block(bld, "t2", v, weights.t2a_w, weights.t2a_b,
                          weights.t2p_w, weights.t2p_b,
                          weights.t2b_w, weights.t2b_b, wexp)
    v = _downsample_block(bld, "t3", v, weights.t3a_w, weights.t3a_b,
                          weights.t3p_w, weights.t3p_b,
                          weights.t3b_w, weights.t3b_b, wexp)
    v = bld.conv("head", v, weights.head_w, weights.head_b,
                 weight_exp=wexp("head"))
    v = bld.relu("head_r", v)
    v = bld.global_avg_pool("head_gap", v)
    v = bld.requant("head_q", v)
    v = bld.flatten("flat", v)
    v = bld.fc("fc", v, weights.fc_w, weights.fc_b, weight_exp=wexp("fc"))
    v = bld.requant("fc_q", v)
    bld.output(v)
    return bld.build()


def calibrate_weight_exps(weights: Resnet8Weights,
                          calib: Sequence[np.ndarray], *,
                          margin: int = 1) -> Dict[str, int]:
    """Per-conv fixed-point weight scales from a calibration pass (the
    two-phase §4.2 discipline of resnet_tiny): each linear node's
    ``weight_exp`` is calibrated to its planned requant shift over a
    throwaway graph, normalising every post-requant activation to scale
    ≈ 0 — the trained-network situation.  The t3 branch then keeps one
    octave of gain per conv (``- 1``), so its join operands land two
    scales apart and the planner must equalise with a genuine on-device
    pre-shift over the projection operand.

    Delegates to the model-agnostic
    :func:`repro_torch.quantize.ptq.calibrate_integer_weight_exps` (imported
    lazily so models/ does not pull the quantize stack at import time).
    """
    from repro_torch.quantize.ptq import calibrate_integer_weight_exps
    return calibrate_integer_weight_exps(
        lambda: build_resnet8(weights), calib, LINEAR_NODES,
        margin=margin, octave_keep=("t3a", "t3b"))


def synthetic_image(seed: int = 0) -> np.ndarray:
    """A deterministic 3×32×32 int8 test image (centred dynamic range)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-64, 64, (1, 3, 32, 32),
                        dtype=np.int64).astype(np.int8)


def compile_resnet8(weights: Optional[Resnet8Weights] = None, *,
                    calib_seeds: Sequence[int] = range(1, 9),
                    input_seed: int = 0, margin: int = 1,
                    schedule: str = "serialized"):
    """Build + plan + compile resnet8; returns ``(net, graph)``.

    Two-phase §4.2 calibration (weight scales, then requant/pre-shift
    planning over the final graph); the returned graph carries the
    planned shifts, so :func:`repro_torch.graph.evaluate_graph` on it *is* the
    bit-exact integer reference for the compiled network."""
    weights = weights or resnet8_random_weights()
    calib = [synthetic_image(s) for s in calib_seeds]
    wexps = calibrate_weight_exps(weights, calib, margin=margin)
    graph = build_resnet8(weights, wexps)
    net = compile_graph(graph, synthetic_image(input_seed),
                        calib=calib + [synthetic_image(input_seed)],
                        margin=margin, schedule=schedule)
    return net, graph


def reference_forward_int8(graph: Graph, image: np.ndarray) -> np.ndarray:
    """Bit-exact integer logits for a *planned* graph (the semantics the
    VTA execution must reproduce)."""
    vals = evaluate_graph(graph, np.asarray(image).astype(np.int64))
    return vals[graph.outputs[0]].astype(np.int8)
