"""Per-device cost of a step, counted op by op as one rank runs it (the
port's counterpart of the reference's ``analysis/hlo_cost.py``).

Torch has no compiled module to parse.  :class:`OpCounter` is a
``TorchDispatchMode`` that sees every local op the rank runs — on its
shards, under a real process group or the dry run's ``fake`` one (every
tensor on ``meta``) — and records, per op:

* FLOPs — ``2·|out|·|contract|`` for ``mm``, ``bmm``, ``addmm``,
  ``baddbmm`` and convolutions (their backward too), as the reference's
  ``_dot_flops`` / ``_conv_flops``; elementwise ops (the ``pointwise``
  tag) ``|out|``, reductions ``|in|``, sorts ``|out|·log2 n``, as its
  ``op_cost``;
* ``bytes`` — operands plus outputs of every op that moves data (views,
  allocations without a write and the collectives' bookkeeping ops are
  free): in eager torch each op reads and writes its tensors, so this is
  the traffic a card really does;
* ``bytes_fused`` — the reference's fused model: matmul and convolution
  operands plus outputs, plus collective payloads and operands;
* collectives — every ``_c10d_functional.*`` and ``c10d.*`` op (DTensor's
  redistributions, the explicit pod sums, the gradient norm's
  all-reduce) by kind: the output bytes per participant (the reference
  dry run's ``collective_bytes``), the ring-factored wire bytes for the
  participant group's size (the reference's factors, copied:
  ``_group_geometry`` and the collective branch of ``op_cost``), and
  whether the group spans pods (ranks in different blocks of 256).

Python runs every layer, microbatch and chunk, so the count is
loop-aware by construction (``unknown_trip_whiles`` is 0).  The trace
holds the model's own dtypes, so no dtype correction applies:
:func:`analyze_trace` reports ``uncorrected`` equal to the corrected
numbers.

DTensor's sharding propagation runs ops once more on ``FakeTensor``s of
the *global* shapes.  The mode returns ``NotImplemented`` for an op on
DTensors (the subclass runs first, and its local ops reach the mode) and
counts an op only when its tensors are plain local tensors, never
``FakeTensor``s.

Only ops on the step's device type are counted (:func:`trace` takes it
from the arguments): on a 2×16×16 mesh DTensor computes shard offsets
with small integer ops on the host, which a card never sees.  A step on
the CPU cannot tell them apart: ``trace(..., all_devices=True)`` counts
every op, on either side of a comparison with one.

Memory: the peak of the bytes held by storages the step creates (each
freed when its last tensor dies), an estimate of the reference's
``memory_analysis`` temp bytes; the arguments' bytes come from the specs.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
POD = 256                     # devices a pod holds: groups across blocks
                              # of this many ranks are inter-pod

_aten = torch.ops.aten

# (op packet name) → collective kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
# ops that carry no data of their own
_FREE_NAMESPACED = {"wait_tensor", "_wrap_tensor_autograd", "barrier"}
_FREE = {
    _aten.detach.default, _aten.alias.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default, _aten.empty.memory_format,
    _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.set_.source_Storage_storage_offset, _aten.resize_.default,
    _aten.sym_size.int, _aten.sym_stride.int, _aten.sym_numel.default,
    _aten.sym_storage_offset.default, _aten.is_same_size.default,
    _aten._local_scalar_dense.default,
}
_MATMUL = {_aten.mm.default: "mm", _aten.bmm.default: "bmm",
           _aten.addmm.default: "addmm", _aten.baddbmm.default: "baddbmm"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "any", "all", "argmax", "argmin", "norm", "linalg_vector_norm", "var",
    "std", "var_mean", "std_mean", "cumsum", "cumprod", "logcumsumexp",
    "count_nonzero",
}
_SORTS = {"sort", "topk"}
# softmax as XLA lowers it: max, subtract, exp, sum, divide
_SOFTMAX = {"_softmax": 5, "_log_softmax": 5,
            "_softmax_backward_data": 3, "_log_softmax_backward_data": 3}


@dataclasses.dataclass
class OpRecord:
    """One local op as a rank ran it."""
    op: str                         # e.g. "aten.mm.default"
    shapes: Tuple[Any, ...]         # (shape, dtype) of each tensor operand
    flops: float = 0.0
    matmul_flops: float = 0.0       # the dot / convolution part of flops
    bytes: float = 0.0
    bytes_fused: float = 0.0
    collective: Optional[str] = None
    payload: float = 0.0            # output bytes per participant
    wire: float = 0.0               # ring-factored wire bytes
    group: int = 0                  # participants
    interpod: bool = False

    def key(self) -> Tuple[Any, ...]:
        """What two runs of one step must agree on, op for op."""
        return (self.op, self.shapes, self.flops, self.bytes,
                self.bytes_fused, self.collective, self.payload, self.group)


@dataclasses.dataclass
class Trace:
    """The ops of one step on one rank, and its storage peak."""
    records: List[OpRecord]
    peak_bytes: int = 0             # storages the step created, at most
    seconds: float = 0.0            # the traced call's wall time


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _flat(tree, out)
    return out


def _flat(x, out: List[torch.Tensor]) -> None:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)


def _key(x):
    """A hashable key of an op's arguments: each tensor by its shape,
    strides and dtype (what a ``meta`` op's result depends on)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    return x


def _unique(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


def _matmul_flops(func, args) -> float:
    name = _MATMUL[func]
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else args[:2]
    if name in ("mm", "addmm"):
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_flops(out_numel: int, weight: torch.Tensor) -> float:
    """``2·|out|·window·in_features``: the weight is (out, in / groups,
    *window)."""
    return 2.0 * out_numel * _prod(weight.shape[1:])


def _group_geometry(ranks: List[int]) -> Tuple[int, bool]:
    """(participants, spans pods?) of a group's global ranks."""
    g = max(1, len(ranks))
    spans = bool(ranks) and min(ranks) // POD != max(ranks) // POD
    return g, spans


def wire_bytes(kind: str, payload: float, g: int) -> float:
    """Ring-factored wire bytes per device of one collective (the
    reference's factors)."""
    ring = (g - 1) / g if g > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * payload * ring
    if kind == "reduce-scatter":
        return payload * (g - 1)       # output = input / g
    if kind in ("all-gather", "all-to-all"):
        return payload * ring
    return payload                     # collective-permute


class OpCounter(TorchDispatchMode):
    """Counts the local ops run inside it (see the module docstring)."""

    def __init__(self, device_type: Optional[str] = None):
        super().__init__()
        self.device_type = device_type
        self.records: List[OpRecord] = []
        self.live = 0
        self.peak = 0
        self._groups: Dict[Any, List[int]] = {}
        self._memo: Dict[Any, Any] = {}

    # -- process groups --------------------------------------------------
    def _ranks(self, func, args) -> List[int]:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        if func.namespace == "_c10d_functional":
            name = next(a for a in reversed(args) if isinstance(a, str))
            if name not in self._groups:
                self._groups[name] = dist.get_process_group_ranks(
                    _resolve_process_group(name))
            return self._groups[name]
        pg_type = torch._C._distributed_c10d.ProcessGroup
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = pg_type.unbox(a)
                except RuntimeError:          # a ReduceOp, a Work
                    continue
                key = pg.group_name
                if key not in self._groups:
                    self._groups[key] = dist.get_process_group_ranks(pg)
                return self._groups[key]
        raise ValueError(f"{func}: no process group among its arguments")

    # -- storages --------------------------------------------------------
    def _track(self, outs: List[torch.Tensor], ins: List[torch.Tensor]):
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in held or getattr(st, "_op_counted", False):
                continue
            st._op_counted = True
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    # -- the mode --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins) or (
                func.namespace in ("_c10d_functional", "c10d")
                and func._opname in _FREE_NAMESPACED):
            # DTensor's propagation on global shapes; a collective's wait
            # (when it runs depends on the backend) and autograd wrapper
            return func(*args, **kwargs)
        if ins and all(t.is_meta for t in ins) and not func.is_view \
                and func.namespace == "aten":
            return self._meta_op(func, args, kwargs, ins)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out
        if self.device_type is not None and (ins or outs) and \
                (ins or outs)[0].device.type != self.device_type:
            return out              # DTensor's own bookkeeping on the host
        self.records.append(self._record(func, args, ins, outs))
        if not func.is_view:
            self._track(outs, ins)
        return out

    def _meta_op(self, func, args, kwargs, ins):
        """An op on ``meta`` tensors, its result rebuilt from the last run
        with the same shapes, strides and dtypes where there was one (a
        ``meta`` op computes nothing but its result's layout, in Python
        for most ops: the dry run repeats each layer's ops thousands of
        times)."""
        try:
            first: Dict[int, int] = {}
            alias = tuple(first.setdefault(id(t), i)
                          for i, t in enumerate(ins))
            key = (func, _key(args), _key(kwargs), alias)
            hash(key)
        except TypeError:
            key = None
        hit = self._memo.get(key) if key is not None else None
        if hit is None:
            out = func(*args, **kwargs)
            outs = _tensors(out)
            rec = self._record(func, args, ins, outs)
            plan = _plan(out, ins)
            if key is not None and plan is not None:
                self._memo[key] = (plan, rec)
        else:
            plan, rec = hit
            out = _rebuild(plan, ins)
            outs = _tensors(out)
        self.records.append(rec)
        self._track(outs, ins)
        return out

    def _record(self, func, args, ins, outs) -> OpRecord:
        ins = _unique(ins)
        rec = OpRecord(str(func), tuple((tuple(t.shape), str(t.dtype))
                                        for t in ins))
        packet = func._opname
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = _COLLECTIVE_KIND.get(packet)
            if kind is None:
                raise NotImplementedError(f"collective {func} is not "
                                          f"counted")
            if func.namespace == "c10d":
                # in-place: the first tensor list is written
                first = args[0]
                written = _tensors(first)
                payload = float(sum(_nbytes(t) for t in written))
                operand = float(sum(_nbytes(t) for t in ins
                                    if all(t is not w for w in written)))
            else:
                payload = float(sum(_nbytes(t) for t in outs))
                operand = float(sum(_nbytes(t) for t in ins))
            g, spans = _group_geometry(self._ranks(func, args))
            wire = wire_bytes(kind, payload, g)
            rec.collective, rec.payload, rec.group = kind, payload, g
            rec.wire, rec.interpod = wire, spans
            rec.bytes = rec.bytes_fused = payload + operand
            return rec
        if func.is_view or func in _FREE:
            return rec
        moved = float(sum(_nbytes(t) for t in ins)
                      + sum(_nbytes(t) for t in _unique(outs)))
        rec.bytes = moved
        out_numel = sum(t.numel() for t in outs)
        if func in _MATMUL:
            rec.matmul_flops = _matmul_flops(func, args)
            rec.flops = rec.matmul_flops + (
                out_numel if _MATMUL[func] in ("addmm", "baddbmm") else 0)
            rec.bytes_fused = moved
        elif packet in ("convolution", "_convolution"):
            rec.matmul_flops = _conv_flops(out_numel, args[1])
            rec.flops = rec.matmul_flops
            rec.bytes_fused = moved
        elif packet == "convolution_backward":
            grad_out, _, weight = args[:3]
            mask = args[-1]
            one = _conv_flops(grad_out.numel(), weight)
            rec.matmul_flops = one * (int(mask[0]) + int(mask[1]))
            rec.flops = rec.matmul_flops + (grad_out.numel() if mask[2]
                                            else 0)
            rec.bytes_fused = moved
        elif packet in _SOFTMAX:
            rec.flops = _SOFTMAX[packet] * float(out_numel)
        elif packet in _SORTS:
            n = ins[0].shape[-1] if ins and ins[0].ndim else 1
            rec.flops = float(ins[0].numel()) * max(1.0, math.log2(
                max(2, n)))
        elif packet in _REDUCTIONS:
            rec.flops = float(sum(t.numel() for t in ins))
        elif torch.Tag.pointwise in func.tags:
            rec.flops = float(out_numel)
        return rec


def _plan(out, ins: List[torch.Tensor]):
    """How to rebuild ``out`` from an op's tensor operands: each output
    tensor one of the operands (in place) or a new empty tensor of its
    layout; None where an output shares an operand's storage otherwise."""
    held = {id(t.untyped_storage()) for t in ins}
    try:
        return _plan_one(out, ins, held)
    except LookupError:
        return None


def _plan_one(x, ins: List[torch.Tensor], held):
    if isinstance(x, torch.Tensor):
        for i, t in enumerate(ins):
            if x is t:
                return ("arg", i)
        if id(x.untyped_storage()) in held:
            raise LookupError
        return ("new", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_plan_one(y, ins, held) for y in x))
    if x is None or isinstance(x, (int, float, bool)):
        return ("value", x)
    raise LookupError


def _rebuild(plan, ins: List[torch.Tensor]):
    tag = plan[0]
    if tag == "arg":
        return ins[plan[1]]
    if tag == "new":
        return torch.empty_strided(plan[1], plan[2], dtype=plan[3],
                                   device="meta")
    if tag == "value":
        return plan[1]
    return plan[0](_rebuild(p, ins) for p in plan[1])


def _device_type(tree) -> Optional[str]:
    """The device type of the first tensor (a DTensor's local one) in a
    tree of arguments."""
    for t in _tensors(tree):
        return getattr(t, "_local_tensor", t).device.type
    return None


def trace(fn, *args, all_devices: bool = False, **kwargs
          ) -> Tuple[Any, Trace]:
    """``fn(*args, **kwargs)`` under an :class:`OpCounter` that counts the
    ops on the arguments' device type (the step's tensors: ``meta`` in a
    dry run, a card, the CPU), or with ``all_devices`` every op: (its
    result, the trace)."""
    import time
    counter = OpCounter(None if all_devices
                        else _device_type((args, kwargs)))
    t0 = time.perf_counter()
    with counter:
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    return out, Trace(counter.records, counter.peak, seconds)


def totals(records: List[OpRecord]) -> Dict[str, Any]:
    """Summed per-device cost of ``records``."""
    coll = {k: 0.0 for k in COLLECTIVES}
    out = {"flops": 0.0, "matmul_flops": 0.0, "bytes": 0.0,
           "bytes_fused": 0.0, "wire": 0.0, "wire_interpod": 0.0,
           "count": 0.0}
    for r in records:
        out["flops"] += r.flops
        out["matmul_flops"] += r.matmul_flops
        out["bytes"] += r.bytes
        out["bytes_fused"] += r.bytes_fused
        if r.collective is not None:
            coll[r.collective] += r.payload
            out["wire"] += r.wire
            if r.interpod:
                out["wire_interpod"] += r.wire
            out["count"] += 1
    out["collective_bytes"] = coll
    return out


def analyze_trace(tr: Trace, n_devices: int) -> Dict[str, Any]:
    """The reference's ``analyze_hlo`` keys for one rank's trace (the
    trace holds the model's dtypes: ``uncorrected`` equals the corrected
    numbers), plus the matmul FLOPs, the op count and the storage
    peak."""
    t = totals(tr.records)
    return {
        "flops_per_device": t["flops"],
        "bytes_per_device": t["bytes"],
        "bytes_fused_per_device": t["bytes_fused"],
        "collective_bytes": t["collective_bytes"],
        "collective_wire_per_device": t["wire"],
        "collective_wire_interpod": t["wire_interpod"],
        "collective_count": t["count"],
        "unknown_trip_whiles": 0,
        "uncorrected": {
            "bytes_fused_per_device": t["bytes_fused"],
            "collective_wire_per_device": t["wire"],
        },
        "matmul_flops_per_device": t["matmul_flops"],
        "ops": len(tr.records),
        "peak_temp_bytes_estimate": tr.peak_bytes,
        "n_devices": n_devices,
    }
