"""Pass pipeline over the graph IR (DESIGN.md §Graph).

Three passes, each with a declared invariant the unit tests assert
directly (`tests/test_graph_passes.py`):

* :func:`infer_shapes`   — forward shape inference.  Invariant: every
  value has a resolved shape; add operands agree; conv kernels fit.
* :func:`plan_requant`   — static requant-shift planning over a
  calibration set (§4.2 discipline), *including branch joins*: a
  power-of-2 scale exponent is tracked per value, and at every ``add``
  the operand with the larger exponent receives an on-device pre-shift
  equal to the difference.  Invariant: both operands of every join land
  in the same fixed-point scale; every dense-linear input fits int8.
* :func:`linearize`      — schedules the DAG into fused steps (one VTA
  layer each) with named activation buffers.  Invariant: steps are in
  dependency order; every non-input node is covered by exactly one step.

:func:`evaluate_graph` is the shared bit-exact int64 reference semantics
— the planner measures against it, the lowering compiles against it, and
the fuzz tests compare VTA execution to it ("compile or raise — never
wrong bytes").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.conv_lowering import (ConvGeometry, im2row, ker2col,
                                      mat2tensor, maxpool3x3s2_matrix,
                                      maxpool3x3s2_out, tensor2mat)
from repro_torch.core.layout import exact_matmul
from repro_torch.core.errors import CompileError
from repro_torch.core.layer_compiler import (check_gap_geometry,
                                       check_stride_tiling,
                                       choose_requant_shift)

from .ir import Graph, Node

# Device constraint: the fused avg-pool SHR is ``2 + layer_shift`` with
# ``layer_shift >= 0`` (DESIGN.md §2), so the requant node after an
# avg-pool must shift by at least the pool's ÷4.
AVG_POOL_DIV = 2


# ---------------------------------------------------------------------------
# Pass 1: shape inference
# ---------------------------------------------------------------------------

def infer_shapes(graph: Graph) -> Dict[str, Tuple[int, ...]]:
    """Forward shape inference; returns value name → shape.

    Raises :class:`CompileError` (naming the node) for rank mismatches,
    channel mismatches, kernels that do not fit, odd pooled extents and
    mismatched add operands.
    """
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name in graph.topo_order():
        node = graph.node(name)
        ins = [shapes[ref] for ref in node.inputs]
        shapes[name] = _node_shape(node, ins)
    return shapes


def _node_shape(node: Node, ins: List[Tuple[int, ...]]) -> Tuple[int, ...]:
    if node.kind == "input":
        return tuple(node.shape)
    if node.kind == "conv":
        s = ins[0]
        if len(s) != 4 or s[0] != 1:
            raise CompileError(f"conv input must be (1, C, H, W), got {s}",
                               layer=node.name, constraint="conv-input-rank")
        f, c, kh, kw = node.weights.shape
        if s[1] != c:
            raise CompileError(
                f"channel mismatch: input has {s[1]}, weights expect {c}",
                layer=node.name, constraint="conv-channels")
        geo = ConvGeometry(c, s[2], s[3], kh, kw, node.stride, node.padding)
        if geo.out_h <= 0 or geo.out_w <= 0:
            raise CompileError(
                f"kernel {kh}x{kw} (stride {node.stride}, pad "
                f"{node.padding}) does not fit the {s[2]}x{s[3]} input",
                layer=node.name, constraint="conv-kernel-fit")
        check_stride_tiling(geo, layer=node.name)
        return (1, f, geo.out_h, geo.out_w)
    if node.kind == "fc":
        s = ins[0]
        if len(s) != 2:
            raise CompileError(
                f"fc input must be 2-D (flatten first), got {s}",
                layer=node.name, constraint="fc-input-rank")
        d, f = node.weights.shape
        if s[1] != d:
            raise CompileError(f"fc dimension mismatch: {s} @ {(d, f)}",
                               layer=node.name, constraint="fc-shape")
        return (s[0], f)
    if node.kind in ("relu", "requant"):
        return ins[0]
    if node.kind == "pool":
        s = ins[0]
        if len(s) != 4:
            raise CompileError(f"pool input must be 4-D, got {s}",
                               layer=node.name, constraint="pool-input-rank")
        if node.mode == "max3x3s2":
            return (s[0], s[1], maxpool3x3s2_out(s[2]),
                    maxpool3x3s2_out(s[3]))
        if s[2] % 2 or s[3] % 2:
            raise CompileError(
                f"2x2 pooling needs even spatial dims, got {s[2]}x{s[3]}",
                layer=node.name, constraint="pool-even-dims")
        return (s[0], s[1], s[2] // 2, s[3] // 2)
    if node.kind == "global_avg_pool":
        s = ins[0]
        if len(s) != 4:
            raise CompileError(f"global_avg_pool input must be 4-D, got {s}",
                               layer=node.name, constraint="pool-input-rank")
        check_gap_geometry(s[2], s[3], layer=node.name)
        return (s[0], s[1], 1, 1)
    if node.kind == "add":
        if ins[0] != ins[1]:
            raise CompileError(
                f"add operands must agree in shape: {ins[0]} vs {ins[1]}",
                layer=node.name, constraint="add-shape")
        return ins[0]
    if node.kind == "flatten":
        s = ins[0]
        if len(s) != 4 or s[0] != 1:
            raise CompileError(f"flatten input must be (1, C, H, W), got {s}",
                               layer=node.name, constraint="flatten-input")
        return (1, s[1] * s[2] * s[3])
    raise CompileError(f"unknown node kind {node.kind!r}", layer=node.name,
                       constraint="node-kind")


# ---------------------------------------------------------------------------
# Reference semantics (shared by planning, lowering and fuzz tests)
# ---------------------------------------------------------------------------

def _check_int8(node: Node, ref: str, v: np.ndarray, what: str) -> None:
    m = int(np.abs(v).max(initial=0))
    if m > 127:
        raise CompileError(
            f"{what} {ref!r} holds values up to {m} — every dense-linear/"
            f"join operand must be a requantised int8 activation",
            layer=node.name, constraint="int8-feed")


def evaluate_graph(graph: Graph, feed: Union[np.ndarray, Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    """Bit-exact int64 evaluation of the whole graph (the integer
    reference the VTA execution must reproduce).  Every ``requant.shift``
    and ``add.pre_shifts`` must already be set — run :func:`plan_requant`
    first (or pin them in the builder).
    """
    inputs = graph.input_names
    if not isinstance(feed, dict):
        if len(inputs) != 1:
            raise CompileError(
                f"graph has {len(inputs)} inputs; pass a feed dict",
                constraint="graph-feed")
        feed = {inputs[0]: feed}
    vals: Dict[str, np.ndarray] = {}
    for name in graph.topo_order():
        node = graph.node(name)
        vals[name] = _eval_node(node, [vals[r] for r in node.inputs],
                                node.inputs, feed)
    return vals


def _eval_node(node: Node, ins: List[np.ndarray], refs: Tuple[str, ...],
               feed: Dict[str, np.ndarray]) -> np.ndarray:
    if node.kind == "input":
        if node.name not in feed:
            raise CompileError(f"no feed for input {node.name!r}",
                               constraint="graph-feed")
        arr = np.asarray(feed[node.name]).astype(np.int64)
        if arr.shape != tuple(node.shape):
            raise CompileError(
                f"feed shape {arr.shape} != declared {tuple(node.shape)}",
                layer=node.name, constraint="graph-feed")
        return arr
    if node.kind == "conv":
        _check_int8(node, refs[0], ins[0], "conv input")
        x = ins[0].astype(np.int8)
        f, c, kh, kw = node.weights.shape
        acc = exact_matmul(im2row(x, kh, kw, node.stride, node.padding),
                           ker2col(node.weights))
        if node.bias is not None:
            acc = acc + node.bias.astype(np.int64)[None, :]
        _, _, h, w = ins[0].shape
        geo = ConvGeometry(c, h, w, kh, kw, node.stride, node.padding)
        return mat2tensor(acc, geo.out_h, geo.out_w)
    if node.kind == "fc":
        _check_int8(node, refs[0], ins[0], "fc input")
        acc = exact_matmul(ins[0], node.weights)
        if node.bias is not None:
            acc = acc + node.bias.astype(np.int64)[None, :]
        return acc
    if node.kind == "relu":
        return np.maximum(ins[0], 0)
    if node.kind == "pool":
        t = ins[0]
        if node.mode == "max3x3s2":
            _, f, h, w = t.shape
            pooled = maxpool3x3s2_matrix(tensor2mat(t), w)
            return mat2tensor(pooled, maxpool3x3s2_out(h),
                              maxpool3x3s2_out(w))
        q = (t[:, :, 0::2, 0::2], t[:, :, 0::2, 1::2],
             t[:, :, 1::2, 0::2], t[:, :, 1::2, 1::2])
        if node.mode == "max2x2":
            return np.maximum(np.maximum(q[0], q[1]), np.maximum(q[2], q[3]))
        return q[0] + q[1] + q[2] + q[3]          # avg = sum; ÷4 in requant
    if node.kind == "global_avg_pool":
        # spatial *sum*; the ÷(H·W) SHR lives in the following requant
        return ins[0].sum(axis=(2, 3), keepdims=True)
    if node.kind == "requant":
        if node.shift is None:
            raise CompileError("requant shift unplanned — run plan_requant",
                               layer=node.name, constraint="requant-planned")
        return ins[0] >> node.shift
    if node.kind == "add":
        if node.pre_shifts is None:
            raise CompileError("add pre-shifts unplanned — run plan_requant",
                               layer=node.name, constraint="requant-planned")
        pa, pb = node.pre_shifts
        _check_int8(node, refs[0], ins[0], "add operand")
        _check_int8(node, refs[1], ins[1], "add operand")
        return (ins[0] >> pa) + (ins[1] >> pb)
    if node.kind == "flatten":
        _check_int8(node, refs[0], ins[0], "flatten input")
        return ins[0].reshape(1, -1)
    raise CompileError(f"unknown node kind {node.kind!r}", layer=node.name,
                       constraint="node-kind")


# ---------------------------------------------------------------------------
# Pass 2: requant-shift planning across branch joins
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RequantPlan:
    """What the planner decided (observability + invariant tests).

    ``exps[v]`` is the power-of-2 scale exponent of value ``v``: the int
    tensor ``v`` represents the real quantity ``r ≈ v · 2^{-exps[v]}``
    relative to the network input.  The planner's defining invariant:
    at every ``add``, both operands (after their planned pre-shifts)
    carry the same exponent.
    """

    shifts: Dict[str, int]                      # requant node → shift
    pre_shifts: Dict[str, Tuple[int, int]]      # add node → (pa, pb)
    exps: Dict[str, int]                        # value → scale exponent


def plan_requant(graph: Graph, calib: Sequence[np.ndarray], *,
                 margin: int = 1, on_linear=None) -> RequantPlan:
    """Fill every unpinned ``requant.shift`` / ``add.pre_shifts`` from a
    calibration set (mutates the graph nodes; §4.2 discipline: shifts are
    static, the margin bit guards unseen inputs).

    Planning walks the DAG once in topo order, carrying for every value
    (a) its int64 evaluation over all calibration images and (b) its
    scale exponent.  Requant shifts are the smallest that land int8
    (+ margin; ≥ 2 after an avg-pool — the device folds the ÷4 into the
    same SHR).  At each add the larger-exponent operand gets a pre-shift
    equal to the exponent difference, so both residual operands reach the
    TensorAlu ADD in the same fixed-point scale.

    ``on_linear(node, input_exp)`` — optional hook invoked on every
    conv/fc node right before its first evaluation, with the planner's
    scale exponent of the node's activation input.  PTQ
    (the reference's ``quantize_network``, DESIGN.md §Quantization)
    uses it to quantise float weights in place at exactly the moment the
    input scale is known: the hook may rewrite ``node.weights`` /
    ``node.bias`` / ``node.weight_exp``, and planning continues over the
    rewritten integer node.
    """
    if not calib:
        raise CompileError("empty calibration set", constraint="calibration")
    inputs = graph.input_names
    if len(inputs) != 1:
        raise CompileError("plan_requant expects a single-input graph",
                           constraint="graph-feed")
    shapes = infer_shapes(graph)                # shape invariant first
    vals: Dict[str, List[np.ndarray]] = {}
    exps: Dict[str, int] = {}
    shifts: Dict[str, int] = {}
    pre_shifts: Dict[str, Tuple[int, int]] = {}

    for name in graph.topo_order():
        node = graph.node(name)
        refs = node.inputs
        if node.kind == "requant":
            if node.shift is None:
                m = max(int(np.abs(v).max(initial=0))
                        for v in vals[refs[0]])
                shift = choose_requant_shift(np.asarray([m])) + margin
                shift = max(shift, _pool_floor(graph, node, shapes))
                node.shift = shift
            shifts[name] = node.shift
            exps[name] = exps[refs[0]] - node.shift
            vals[name] = [v >> node.shift for v in vals[refs[0]]]
            continue
        if node.kind == "add":
            ea, eb = exps[refs[0]], exps[refs[1]]
            if node.pre_shifts is None:
                node.pre_shifts = (max(0, ea - eb), max(0, eb - ea))
            pa, pb = node.pre_shifts
            if ea - pa != eb - pb:
                raise CompileError(
                    f"join operands disagree in scale even after "
                    f"pre-shifts: exponents {ea}-{pa} vs {eb}-{pb}",
                    layer=name, constraint="join-scale")
            pre_shifts[name] = node.pre_shifts
            exps[name] = ea - pa
            for ref in refs:
                for v in vals[ref]:
                    _check_int8(node, ref, v, "add operand")
            vals[name] = [(a >> pa) + (b >> pb)
                          for a, b in zip(vals[refs[0]], vals[refs[1]])]
            continue
        # every other kind evaluates per image with the shared semantics
        if node.kind == "input":
            vals[name] = [np.asarray(img).astype(np.int64) for img in calib]
            exps[name] = 0
        else:
            if node.kind in ("conv", "fc") and on_linear is not None:
                on_linear(node, exps[refs[0]])
            vals[name] = [_eval_node(node, [vals[r][i] for r in refs],
                                     refs, {}) for i in range(len(calib))]
            if node.kind in ("conv", "fc"):
                # int8 weights represent real coefficients W · 2^-weight_exp,
                # so the integer accumulator sits 2^weight_exp above the
                # real-valued feature (standard fixed-point bookkeeping).
                exps[name] = exps[refs[0]] + node.weight_exp
            elif node.kind == "pool" and node.mode == "avg2x2":
                exps[name] = exps[refs[0]] + AVG_POOL_DIV
            elif node.kind == "global_avg_pool":
                exps[name] = exps[refs[0]] + _gap_div(shapes[refs[0]])
            else:
                exps[name] = exps[refs[0]]
    return RequantPlan(shifts=shifts, pre_shifts=pre_shifts, exps=exps)


def _gap_div(in_shape: Tuple[int, ...]) -> int:
    """floor(log2) of a GAP node's spatial position count: the ÷(H·W) SHR
    on a power-of-two count, and on any other (7×7 = 49: 5) the
    power-of-two scale the GAP's sum stands at over the average."""
    return (in_shape[2] * in_shape[3]).bit_length() - 1


def _pool_floor(graph: Graph, requant: Node,
                shapes: Dict[str, Tuple[int, ...]]) -> int:
    """Minimum shift of a requant node: the device folds the producing
    pool's division (avg ÷4, GAP ÷(H·W)) into the same SHR."""
    producer = graph.node(requant.inputs[0])
    if producer.kind == "pool" and producer.mode == "avg2x2":
        return AVG_POOL_DIV
    if producer.kind == "global_avg_pool":
        return _gap_div(shapes[producer.inputs[0]])
    return 0


# ---------------------------------------------------------------------------
# Pass 3: linearization into fused steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Step:
    """One fused VTA layer scheduled out of the DAG.

    ``input_value``/``residual_source`` name activation buffers: the
    graph input or an earlier step's ``output_value`` (the lowering turns
    these into :class:`~repro_torch.core.network_compiler.NetworkProgram`
    ``input_sources``/``residual_sources`` indices).
    """

    name: str
    kind: str                        # conv | fc
    node_names: Tuple[str, ...]      # fused IR nodes, execution order
    input_value: str
    output_value: str
    weights: np.ndarray
    bias: Optional[np.ndarray]
    stride: int
    padding: int
    relu: bool
    pool: Optional[str]              # max2x2 | avg2x2 | max3x3s2 | gap |
                                     # None
    requant_shift: int               # LayerSpec shift (pool ÷4 excluded)
    residual_source: Optional[str] = None
    residual_pre_shift: int = 0
    residual_shift: Optional[int] = None


def linearize(graph: Graph) -> List[Step]:
    """Schedule the DAG into fused steps with named activation buffers.

    Fusable patterns (single-consumer chains off a dense-linear node):

        conv → [relu] → [pool|global_avg_pool] → requant       (linear)
        fc   → [relu] → requant                                (linear)
        conv|fc → requant → add(·, skip) → [relu]
                → [global_avg_pool] → requant                  (residual)

    plus ``flatten`` folded into the fc that consumes it.  Anything else
    raises :class:`CompileError`.  Requant shifts must be planned first.
    """
    shapes = infer_shapes(graph)
    cons = graph.consumers()
    materialized = set(graph.input_names)
    covered = set(graph.input_names)
    steps: List[Step] = []

    def single(name: str, why: str) -> str:
        c = cons[name]
        if len(c) != 1:
            raise CompileError(
                f"{why}: value {name!r} has {len(c)} consumers "
                f"(exactly one required to fuse)", layer=name,
                constraint="fusion-single-consumer")
        return c[0]

    def shift_of(qname: str) -> int:
        q = graph.node(qname)
        if q.shift is None:
            raise CompileError("requant shift unplanned — run plan_requant",
                               layer=qname, constraint="requant-planned")
        return q.shift

    for name in graph.topo_order():
        node = graph.node(name)
        if node.kind not in ("conv", "fc") or name in covered:
            continue
        chain: List[str] = []
        in_value = node.inputs[0]
        if node.kind == "fc" and in_value not in materialized:
            producer = graph.node(in_value)
            if producer.kind == "flatten" and in_value not in covered:
                single(in_value, "flatten must feed exactly one fc")
                chain.append(in_value)
                in_value = producer.inputs[0]
        if in_value not in materialized:
            raise CompileError(
                f"{node.kind} input {in_value!r} is not an activation "
                f"buffer (it is consumed mid-fusion elsewhere, or is an "
                f"unrequantised intermediate)", layer=name,
                constraint="fusion-input-materialized")
        chain.append(name)

        cur = name
        nxt = graph.node(single(cur, f"{node.kind} result must fuse"))
        relu = False
        pool = None
        if nxt.kind == "relu":
            relu = True
            chain.append(nxt.name)
            cur = nxt.name
            nxt = graph.node(single(cur, "relu result must fuse"))
        pool_div = 0
        if nxt.kind in ("pool", "global_avg_pool"):
            if node.kind == "fc":
                raise CompileError("pooling requires a conv layer",
                                   layer=nxt.name,
                                   constraint="pool-needs-conv")
            if nxt.kind == "global_avg_pool":
                pool = "gap"
                pool_div = _gap_div(shapes[nxt.inputs[0]])
            else:
                pool = nxt.mode
                pool_div = AVG_POOL_DIV if pool == "avg2x2" else 0
            chain.append(nxt.name)
            cur = nxt.name
            nxt = graph.node(single(cur, "pool result must fuse"))
        if nxt.kind != "requant":
            raise CompileError(
                f"{node.kind} chain must end in a requant before any other "
                f"consumer (found {nxt.kind} {nxt.name!r})", layer=name,
                constraint="requant-required")
        q = nxt
        chain.append(q.name)
        q_shift = shift_of(q.name)
        if q_shift < pool_div:
            raise CompileError(
                f"requant after a pooled reduction must shift by >= "
                f"{pool_div} (the fused division), got {q_shift}",
                layer=q.name,
                constraint="avg-pool-min-shift" if pool != "gap"
                else "gap-min-shift")

        # ---- residual continuation: requant feeding exactly one add
        # whose other operand is already materialized ----
        step = None
        if not relu and pool is None and len(cons[q.name]) == 1:
            maybe_add = graph.node(cons[q.name][0])
            if maybe_add.kind == "add":
                other = [r for r in maybe_add.inputs if r != q.name]
                if len(other) == 1 and other[0] in materialized:
                    step = _residual_step(graph, shapes, node, chain,
                                          in_value, q_shift, maybe_add,
                                          other[0], single, shift_of)
        if step is None:
            step = Step(name=name, kind=node.kind,
                        node_names=tuple(chain), input_value=in_value,
                        output_value=q.name, weights=node.weights,
                        bias=node.bias, stride=node.stride,
                        padding=node.padding, relu=relu, pool=pool,
                        requant_shift=q_shift - pool_div)
        covered.update(step.node_names)
        materialized.add(step.output_value)
        steps.append(step)

    uncovered = [n for n in graph.topo_order() if n not in covered]
    if uncovered:
        raise CompileError(
            f"nodes not reachable by any fusable pattern: {uncovered} "
            f"(each relu/pool/requant/add must extend a conv/fc chain)",
            layer=uncovered[0], constraint="fusion-coverage")
    for out in graph.outputs:
        if out not in materialized:
            raise CompileError(
                f"graph output {out!r} is a fused intermediate, not an "
                f"activation buffer", layer=out,
                constraint="output-materialized")
    return steps


def _residual_step(graph: Graph, shapes, linear: Node, chain: List[str],
                   in_value: str, q_shift: int, add: Node, skip: str,
                   single, shift_of) -> Step:
    """Fuse ``linear → requant → add(·, skip) → [relu] → [gap] →
    requant``; the last requant's shift covers the GAP's whole sum."""
    if add.pre_shifts is None:
        raise CompileError("add pre-shifts unplanned — run plan_requant",
                           layer=add.name, constraint="requant-planned")
    branch_pos = 0 if add.inputs[1] == skip else 1
    branch_pre = add.pre_shifts[branch_pos]
    skip_pre = add.pre_shifts[1 - branch_pos]
    chain = chain + [add.name]
    cur = add.name
    nxt = graph.node(single(cur, "add result must fuse"))
    relu = False
    if nxt.kind == "relu":
        relu = True
        chain.append(nxt.name)
        cur = nxt.name
        nxt = graph.node(single(cur, "relu result must fuse"))
    pool = None
    if nxt.kind == "global_avg_pool" and linear.kind == "conv":
        pool = "gap"
        chain.append(nxt.name)
        floor = _gap_div(shapes[nxt.inputs[0]])
        cur = nxt.name
        nxt = graph.node(single(cur, "pool result must fuse"))
    if nxt.kind != "requant":
        raise CompileError(
            f"residual add must be requantised before any other consumer "
            f"(found {nxt.kind} {nxt.name!r})", layer=add.name,
            constraint="requant-required")
    if pool is not None and shift_of(nxt.name) < floor:
        raise CompileError(
            f"requant after a pooled reduction must shift by >= {floor} "
            f"(the fused division), got {shift_of(nxt.name)}",
            layer=nxt.name, constraint="gap-min-shift")
    chain.append(nxt.name)
    return Step(name=linear.name, kind=linear.kind, node_names=tuple(chain),
                input_value=in_value, output_value=nxt.name,
                weights=linear.weights, bias=linear.bias,
                stride=linear.stride, padding=linear.padding, relu=relu,
                pool=pool,
                # the branch operand's scale-equalising shift folds into
                # the pre-add requant: (x >> q) >> pre == x >> (q + pre)
                requant_shift=q_shift + branch_pre,
                residual_source=skip, residual_pre_shift=skip_pre,
                residual_shift=shift_of(nxt.name))
