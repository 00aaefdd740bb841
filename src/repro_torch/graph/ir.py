"""Graph IR: a small DAG of named tensor values (DESIGN.md §Graph).

Grammar
-------
A graph is a set of single-output *nodes*; a node's name is also the name
of the tensor value it produces (values are explicit — every edge is a
``(producer name → consumer)`` reference, and :meth:`Graph.topo_order`
certifies the whole structure is a DAG before any pass runs):

    input(shape)                 — a graph input (int8 activation)
    conv(x; W, b, stride, pad)   — dense linear (weights (F, C, kh, kw));
                                   stride 2 downsamples (§Strided-lowering)
    fc(x; W, b)                  — dense linear (weights (D, F))
    relu(x)                      — MAX(x, 0)
    pool(x; "max2x2"|"avg2x2")   — 2×2/stride-2 window; avg produces the
                                   window *sum* (÷4 lives in the requant)
    pool(x; "max3x3s2")          — 3×3/stride-2/pad-1 max window (ResNet's
                                   stem); the padding is left out
    global_avg_pool(x)           — (1,F,H,W) → (1,F,1,1) spatial *sum*
                                   (÷(H·W) lives in the requant, a power
                                   of two at least floor(log2(H·W)); needs
                                   a square map)
    requant(x; shift)            — arithmetic right shift (None = planned)
    add(a, b)                    — the residual join (+ planned pre-shifts)
    flatten(x)                   — NCHW → (1, C·H·W)

The IR deliberately mirrors the device semantics the §2 requantisation
discipline fixed: activations *between* fused layers are int8; values
inside a fused layer (conv accumulator, pool sum, pre-requant add) are
int32.  The pass pipeline (:mod:`repro_torch.graph.passes`) checks both.

Verification levels: :class:`GraphBuilder` rejects malformed nodes at
construction (unknown refs, bad arity, bad attributes); :meth:`Graph.verify`
re-checks the assembled structure — it is cheap and re-run by
:func:`repro_torch.graph.lower.compile_graph` before every compile, so a graph
mutated by hand still cannot reach the lowering in a broken state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.errors import CompileError

# kind -> number of value inputs
NODE_ARITY = {
    "input": 0, "conv": 1, "fc": 1, "relu": 1, "pool": 1,
    "global_avg_pool": 1, "requant": 1, "add": 2, "flatten": 1,
}
POOL_MODES = ("max2x2", "avg2x2", "max3x3s2")


@dataclasses.dataclass
class Node:
    """One IR node = one named tensor value.

    Only the attributes meaningful for ``kind`` are set; the rest stay at
    their defaults.  ``shift`` (requant) and ``pre_shifts`` (add) may be
    ``None`` at build time — the requant-planning pass fills them.
    """

    name: str
    kind: str
    inputs: Tuple[str, ...] = ()
    # conv / fc
    weights: Optional[np.ndarray] = None
    bias: Optional[np.ndarray] = None
    stride: int = 1
    padding: int = 0
    # Fixed-point scale of the stored int8 weights: they represent real
    # coefficients ``W · 2^-weight_exp`` (standard weight quantisation).
    # Bookkeeping only — it never changes the integer arithmetic, it
    # informs the requant planner's scale-exponent tracking so branch
    # joins equalise against the *real*-valued network (DESIGN.md §Graph).
    weight_exp: int = 0
    # pool
    mode: Optional[str] = None
    # requant
    shift: Optional[int] = None
    # add: per-operand scale-equalising SHR (filled by plan_requant)
    pre_shifts: Optional[Tuple[int, int]] = None
    # input
    shape: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass
class Graph:
    """A verified DAG of :class:`Node`\\ s (insertion-ordered)."""

    name: str
    nodes: Dict[str, Node]
    outputs: Tuple[str, ...]

    @property
    def input_names(self) -> Tuple[str, ...]:
        return tuple(n.name for n in self.nodes.values()
                     if n.kind == "input")

    def node(self, name: str) -> Node:
        return self.nodes[name]

    def consumers(self) -> Dict[str, List[str]]:
        """value name → names of nodes that read it."""
        out: Dict[str, List[str]] = {name: [] for name in self.nodes}
        for node in self.nodes.values():
            for ref in node.inputs:
                out[ref].append(node.name)
        return out

    # ------------------------------------------------------------------
    def topo_order(self) -> List[str]:
        """Kahn's algorithm over the value edges; raises
        :class:`CompileError` on a cycle (the DAG certificate)."""
        indeg = {name: len(node.inputs) for name, node in self.nodes.items()}
        ready = [n for n, d in indeg.items() if d == 0]
        cons = self.consumers()
        order: List[str] = []
        while ready:
            cur = ready.pop(0)
            order.append(cur)
            for consumer in cons[cur]:
                indeg[consumer] -= 1
                if indeg[consumer] == 0:
                    ready.append(consumer)
        if len(order) != len(self.nodes):
            cyclic = sorted(n for n, d in indeg.items() if d > 0)
            raise CompileError(f"graph {self.name!r} has a cycle through "
                               f"{cyclic}", constraint="graph-acyclic")
        return order

    def verify(self) -> None:
        """Structural verification: reference resolution, arities,
        per-kind attribute validity, acyclicity, output reachability."""
        if not self.nodes:
            raise CompileError(f"graph {self.name!r} is empty",
                               constraint="graph-nonempty")
        for node in self.nodes.values():
            if node.kind not in NODE_ARITY:
                raise CompileError(f"unknown node kind {node.kind!r}",
                                   layer=node.name, constraint="node-kind")
            if len(node.inputs) != NODE_ARITY[node.kind]:
                raise CompileError(
                    f"{node.kind} takes {NODE_ARITY[node.kind]} input(s), "
                    f"got {len(node.inputs)}", layer=node.name,
                    constraint="node-arity")
            for ref in node.inputs:
                if ref not in self.nodes:
                    raise CompileError(f"references unknown value {ref!r}",
                                       layer=node.name,
                                       constraint="value-resolution")
            _verify_attrs(node)
        if not self.outputs:
            raise CompileError(f"graph {self.name!r} declares no outputs",
                               constraint="graph-outputs")
        for out in self.outputs:
            if out not in self.nodes:
                raise CompileError(f"output {out!r} is not a node",
                                   constraint="value-resolution")
        if not self.input_names:
            raise CompileError(f"graph {self.name!r} has no input node",
                               constraint="graph-inputs")
        self.topo_order()


def _verify_attrs(node: Node) -> None:
    if node.kind == "input":
        if node.shape is None or len(node.shape) not in (2, 4):
            raise CompileError(
                f"input needs a 2-D or 4-D shape, got {node.shape}",
                layer=node.name, constraint="input-shape")
    elif node.kind == "conv":
        if node.weights is None or node.weights.ndim != 4:
            raise CompileError("conv needs (F, C, kh, kw) weights",
                               layer=node.name, constraint="conv-weight-rank")
        if node.stride < 1:
            raise CompileError(f"stride must be >= 1, got {node.stride}",
                               layer=node.name, constraint="conv-stride")
        if node.stride > 2:
            raise CompileError(
                f"stride {node.stride} unsupported — the strided lowering "
                f"covers strides 1 and 2 (DESIGN.md §Strided-lowering)",
                layer=node.name, constraint="conv-stride-max")
        if node.padding < 0:
            raise CompileError(f"padding must be >= 0, got {node.padding}",
                               layer=node.name, constraint="conv-padding")
    elif node.kind == "fc":
        if node.weights is None or node.weights.ndim != 2:
            raise CompileError("fc needs (D, F) weights", layer=node.name,
                               constraint="fc-weight-rank")
    elif node.kind == "pool":
        if node.mode not in POOL_MODES:
            raise CompileError(
                f"pool mode must be one of {POOL_MODES}, got {node.mode!r}",
                layer=node.name, constraint="pool-kind")
    elif node.kind == "requant":
        if node.shift is not None and node.shift < 0:
            raise CompileError(f"shift must be >= 0, got {node.shift}",
                               layer=node.name, constraint="requant-shift")


class GraphBuilder:
    """Declarative builder: each method adds one node and returns its
    value name, so graphs read as straight-line code:

        b = GraphBuilder("net")
        x = b.input("image", shape=(1, 3, 32, 32))
        v = b.requant("s1_q", b.relu("s1_r", b.conv("s1", x, w, bias)))
        v = b.requant("j_q", b.relu("j_r", b.add("j", v, x)))
        b.output(v)
        g = b.build()          # runs Graph.verify()
    """

    def __init__(self, name: str = "graph"):
        self.name = name
        self._nodes: Dict[str, Node] = {}
        self._outputs: List[str] = []

    # ------------------------------------------------------------------
    def _add(self, node: Node) -> str:
        if node.name in self._nodes:
            raise CompileError(f"duplicate node name {node.name!r}",
                               layer=node.name, constraint="node-name-unique")
        for ref in node.inputs:
            if ref not in self._nodes:
                raise CompileError(
                    f"references unknown value {ref!r} (nodes must be "
                    f"added in def-before-use order)", layer=node.name,
                    constraint="value-resolution")
        _verify_attrs(node)
        self._nodes[node.name] = node
        return node.name

    def input(self, name: str, shape: Sequence[int]) -> str:
        return self._add(Node(name, "input", shape=tuple(shape)))

    def conv(self, name: str, x: str, weights: np.ndarray,
             bias: Optional[np.ndarray] = None, *, stride: int = 1,
             padding: int = 0, weight_exp: int = 0) -> str:
        return self._add(Node(name, "conv", (x,), weights=weights, bias=bias,
                              stride=stride, padding=padding,
                              weight_exp=weight_exp))

    def fc(self, name: str, x: str, weights: np.ndarray,
           bias: Optional[np.ndarray] = None, *,
           weight_exp: int = 0) -> str:
        return self._add(Node(name, "fc", (x,), weights=weights, bias=bias,
                              weight_exp=weight_exp))

    def relu(self, name: str, x: str) -> str:
        return self._add(Node(name, "relu", (x,)))

    def pool(self, name: str, x: str, mode: str) -> str:
        return self._add(Node(name, "pool", (x,), mode=mode))

    def global_avg_pool(self, name: str, x: str) -> str:
        return self._add(Node(name, "global_avg_pool", (x,)))

    def requant(self, name: str, x: str,
                shift: Optional[int] = None) -> str:
        return self._add(Node(name, "requant", (x,), shift=shift))

    def add(self, name: str, a: str, b: str) -> str:
        return self._add(Node(name, "add", (a, b)))

    def flatten(self, name: str, x: str) -> str:
        return self._add(Node(name, "flatten", (x,)))

    def output(self, name: str) -> None:
        if name not in self._nodes:
            raise CompileError(f"output {name!r} is not a node",
                               constraint="value-resolution")
        self._outputs.append(name)

    def build(self) -> Graph:
        graph = Graph(name=self.name, nodes=dict(self._nodes),
                      outputs=tuple(self._outputs))
        graph.verify()
        return graph
