"""Graph → VTA lowering (DESIGN.md §Graph).

``compile_graph`` drives the whole pipeline: structural verification,
shape inference, requant planning, linearization, then per-step lowering
onto the existing layer compiler — every step against one shared DRAM
allocation (§4.2), residual steps with their skip operand compiled into a
``res`` region and merged on the VTA by an ALU vector-vector ADD.

Traceability: after compiling each step the lowering asserts the layer's
reference output equals the graph evaluation of the step's output value —
a compiler whose fused semantics drift from the IR semantics fails here,
at compile time, not with wrong bytes at run time.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.conv_lowering import mat2tensor
from repro_torch.core.dram import DramAllocator
from repro_torch.core.errors import CompileError
from repro_torch.core.hwconfig import VTAConfig, vta_default
from repro_torch.core.layer_compiler import CompiledLayer, LayerSpec, compile_layer
from repro_torch.core.network_compiler import NetworkProgram

from .ir import Graph
from .passes import Step, evaluate_graph, linearize, plan_requant


def step_to_spec(step: Step) -> LayerSpec:
    """One fused step → the hardware-agnostic :class:`LayerSpec`."""
    return LayerSpec(
        name=step.name, kind=step.kind, weights=step.weights, bias=step.bias,
        stride=step.stride, padding=step.padding, relu=step.relu,
        pool=step.pool, requant_shift=step.requant_shift,
        residual_add=step.residual_source is not None,
        residual_pre_shift=step.residual_pre_shift,
        residual_shift=step.residual_shift)


def compile_graph(graph: Graph, input_tensor: np.ndarray, *,
                  calib: Optional[Sequence[np.ndarray]] = None,
                  margin: int = 1,
                  cfg: Optional[VTAConfig] = None,
                  dram_offset: int = 0,
                  schedule: str = "serialized") -> NetworkProgram:
    """Compile a branching CNN graph into a :class:`NetworkProgram`.

    ``calib`` is the §4.2 calibration set for the requant planner
    (defaults to just ``input_tensor``); pinned shifts on the graph are
    kept.  The returned program runs on every backend of the network
    runtime — ``run_functional``/``verify`` (oracle/fast), ``serve_one``,
    and batched ``serve`` — with residual adds executed on the VTA.
    """
    cfg = cfg or vta_default()
    graph.verify()
    if len(graph.outputs) != 1:
        raise CompileError(
            f"compile_graph expects exactly one output, got "
            f"{len(graph.outputs)}", constraint="single-output")
    plan_requant(graph, list(calib) if calib is not None
                 else [input_tensor], margin=margin)
    steps = linearize(graph)
    # Dead-step elimination: keep only steps whose output transitively
    # reaches the graph output.  With a single output the producing step
    # is then always last (everything live feeds it).
    live = _live_nodes(graph)
    steps = [s for s in steps if s.output_value in live]
    if not steps or steps[-1].output_value != graph.outputs[0]:
        raise CompileError(
            f"graph output {graph.outputs[0]!r} is not produced by the "
            f"final live step", constraint="output-materialized")
    vals = evaluate_graph(graph, np.asarray(input_tensor))

    alloc = DramAllocator(offset=dram_offset, page_bytes=cfg.page_bytes)
    layers: List[CompiledLayer] = []
    input_sources: List[int] = []
    residual_sources: List[Optional[int]] = []
    produced: Dict[str, int] = {}        # activation buffer → layer index
    inputs = set(graph.input_names)

    def source_index(value: str, step: Step) -> int:
        if value in inputs:
            return -1
        if value not in produced:
            raise CompileError(
                f"step consumes {value!r} before it is produced "
                f"(linearization invariant violated)", layer=step.name,
                constraint="step-order")
        return produced[value]

    for step in steps:
        spec = step_to_spec(step)
        src = source_index(step.input_value, step)
        inp = _as_activation(vals[step.input_value], step, "input")
        residual = None
        res_src: Optional[int] = None
        if step.residual_source is not None:
            res_src = source_index(step.residual_source, step)
            residual = _as_activation(vals[step.residual_source], step,
                                      "residual")
        layer = compile_layer(spec, inp, cfg=cfg, allocator=alloc,
                              residual=residual, schedule=schedule)
        _check_step_reference(layer, vals[step.output_value], step)
        produced[step.output_value] = len(layers)
        layers.append(layer)
        input_sources.append(src)
        residual_sources.append(res_src)

    return NetworkProgram(config=cfg, allocator=alloc, layers=layers,
                          input_tensor=np.asarray(input_tensor),
                          input_sources=input_sources,
                          residual_sources=residual_sources)


def _live_nodes(graph: Graph) -> set:
    """Backward closure from the graph outputs over value edges."""
    live = set()
    stack = list(graph.outputs)
    while stack:
        cur = stack.pop()
        if cur in live:
            continue
        live.add(cur)
        stack.extend(graph.node(cur).inputs)
    return live


def _as_activation(value: np.ndarray, step: Step, what: str) -> np.ndarray:
    """Graph values are int64; activation buffers must be int8-exact."""
    if int(np.abs(value).max(initial=0)) > 127:
        raise CompileError(
            f"{what} activation exceeds int8 (planner invariant violated)",
            layer=step.name, constraint="int8-feed")
    return value.astype(np.int8)


def _check_step_reference(layer: CompiledLayer, expected: np.ndarray,
                          step: Step) -> None:
    """The fused layer's compiled reference must equal the IR semantics."""
    ref = layer.ref_output_matrix
    if layer.spec.kind == "conv":
        ref = mat2tensor(ref, layer.out_h, layer.out_w)
    if not np.array_equal(ref.astype(np.int64), expected):
        raise CompileError(
            f"fused layer semantics diverge from the graph reference for "
            f"value {step.output_value!r}", layer=step.name,
            constraint="lowering-reference")
