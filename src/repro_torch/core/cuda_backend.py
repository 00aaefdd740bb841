"""The CUDA backend: compiled VTA programs on the hand-written GEMM kernel.

The port's counterpart of the reference's ``core/pallas_backend.py``.
Where the simulators interpret an instruction stream, this backend
executes the semantics a compiled :class:`~repro_torch.core.program.VTAProgram`
encodes — one ``vta_gemm`` kernel launch per program (the plain torch
version for CPU tensors) plus a bit-exact TensorAlu epilogue — and commits
the result to the same DRAM OUT region the simulators write.  The DRAM is
a device-resident ``(B, nbytes)`` uint8 stack; the §3.2 codecs are dtype
views and reshapes of it, so nothing leaves the device.

Semantics contract (pinned by ``tests/test_torch_backend.py``):

* ``saturate=False`` (default) — faithful §2.1 truncation; OUT bytes are
  bit-identical to the reference's oracle for every compiled program.
* ``saturate=True`` — OUT equals ``clip(acc, -128, 127)`` of the oracle's
  pre-truncation ACC.

When the program's ALU epilogue is exactly the fused-kernel form
(``[relu?][shr?]`` with a row-broadcast bias) the whole layer runs inside
the kernel; richer programs (pool pair lattices, indexed SHR, residual
ADD) run the GEMM on the kernel with an int32 output and the remaining
TensorAlu ops as a second kernel, ``vta_alu``, which reads the GEMM's
result, ACC and RES in place and writes OUT, in one launch a layer.  Its
plain version, the vectorised torch epilogue below (the CPU path), mirrors
``gemm_compiler``'s reference semantics op for op (wraparound included).

Every row of a stack shares one program's constants (:class:`LayerConsts`:
the kernel's weights and fused bias, decoded once, the image the epilogue
reads the ACC preload from, and whether the layer fuses), so the stack
needs only what varies by image (INP, RES, OUT).  ``NetworkProgram`` reads
them off the compiled image; the simulator engines off their stack, one
row at a time where the rows' WGT or ACC differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import DeviceLike, device_of, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import vta_alu
from repro_torch.kernels.ref import truncate_int8, wrap_int32

from . import isa
from .errors import CompileError
from .gemm_compiler import (AluImmOp, AluIndexedImmOp, AluPairOp,
                            AluResidualOp)
from .hwconfig import VTAConfig
from .simulator import SimReport


# ---------------------------------------------------------------------------
# Program lowering (cached on the program)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CudaPlan:
    """Geometry + epilogue lowering for one compiled program.

    Field for field the reference's ``PallasPlan``: ``fused`` marks ALU
    programs of the exact kernel-epilogue form (``[relu?][shr?]``), which
    run entirely inside the kernel.  Region offsets are relative to the
    allocator-local DRAM image, byte sizes derived from the §3.2 block grid
    (α×λ×β, ``row_height``)."""

    alpha: int
    lam: int
    beta: int
    row_height: int
    block_size: int
    valid_shape: Tuple[int, int]
    alu_ops: Tuple
    fused: bool
    relu: bool
    shift: int
    # (byte offset, byte size) per region; None when the program has none
    inp: Tuple[int, int]
    wgt: Tuple[int, int]
    out: Tuple[int, int]
    acc: Optional[Tuple[int, int]]
    res: Optional[Tuple[int, int]]

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return (self.alpha * self.row_height, self.beta * self.block_size)


def _fused_form(alu_ops) -> Optional[Tuple[bool, int]]:
    """``(relu, shift)`` when the epilogue is the kernel-fusable subset."""
    relu, shift = False, 0
    stage = 0                       # 0 = expect relu or shr, 1 = expect shr
    for spec in alu_ops:
        if not isinstance(spec, AluImmOp):
            return None
        if spec.op == isa.AluOp.MAX and spec.imm == 0 and stage == 0:
            relu, stage = True, 1
        elif spec.op == isa.AluOp.SHR and spec.imm >= 0:
            if shift:               # two SHRs do not fuse into one
                return None
            shift, stage = spec.imm, 2
        else:
            return None
    return relu, shift


def plan_cuda(prog) -> CudaPlan:
    """Lower ``prog`` for the cuda backend; cached on the program (the
    compile-once/serve-many contract).  The plan is stored only once
    complete, so threads that race here build it twice, never half."""
    plan = getattr(prog, "_cuda_plan", None)
    if plan is not None:
        return plan
    if prog.chunk_plan is None or prog.output_meta is None \
            or prog.alu_ops is None:
        raise CompileError(
            f"program {prog.name!r} was not produced by compile_matmul; "
            f"the cuda backend lowers compiler metadata (chunk plan, "
            f"output meta, ALU spec), not raw instruction streams",
            constraint="cuda-program-metadata")
    cfg: VTAConfig = prog.config
    cp = prog.chunk_plan
    bs = cfg.block_size
    alpha, lam, beta, rh = cp.alpha, cp.lam, cp.beta, cp.row_height

    def _span(key: str, nbytes: int) -> Tuple[int, int]:
        region = prog.regions[key]
        return region.phys_addr - prog.allocator.offset, nbytes

    fused = _fused_form(prog.alu_ops)
    plan = CudaPlan(
        alpha=alpha, lam=lam, beta=beta, row_height=rh, block_size=bs,
        valid_shape=tuple(prog.output_meta.valid_shape),
        alu_ops=tuple(prog.alu_ops),
        fused=fused is not None,
        relu=fused[0] if fused else False,
        shift=fused[1] if fused else 0,
        inp=_span("inp", alpha * lam * rh * bs),
        wgt=_span("wgt", lam * beta * bs * bs),
        out=_span("out", alpha * beta * rh * bs),
        acc=(_span("acc", alpha * beta * rh * bs * 4)
             if "acc" in prog.regions else None),
        res=(_span("res", alpha * beta * rh * bs * 4)
             if "res" in prog.regions else None))
    prog._cuda_plan = plan
    return plan


# ---------------------------------------------------------------------------
# §3.2 layout codecs over a (B, nbytes) uint8 DRAM stack on the device
# ---------------------------------------------------------------------------

def _region(stack: torch.Tensor, span: Tuple[int, int],
            dtype: torch.dtype) -> torch.Tensor:
    """``(B, size)`` bytes of one region as a ``dtype`` view (no copy).
    A view wider than a byte needs a 4-aligned start and row stride —
    region starts are page-aligned and images page-sized, so it holds."""
    start, size = span
    if dtype != torch.int8 and (start % 4 or stack.shape[1] % 4 or size % 4):
        raise ValueError(
            f"region [{start}, {start + size}) of a {stack.shape[1]}-byte "
            f"image is not 4-byte aligned; cannot view it as {dtype}")
    return stack[:, start:start + size].view(dtype)


def _decode_inp(stack: torch.Tensor, p: CudaPlan) -> torch.Tensor:
    """INP bytes → (B, α·rh, λ·bs) int8 padded A."""
    b = stack.shape[0]
    blocks = _region(stack, p.inp, torch.int8).reshape(
        b, p.alpha, p.lam, p.row_height, p.block_size)
    return blocks.permute(0, 1, 3, 2, 4).reshape(
        b, p.alpha * p.row_height, p.lam * p.block_size)


def _decode_wgt(stack: torch.Tensor, p: CudaPlan) -> torch.Tensor:
    """WGT bytes (blocks stored transposed, §3.2) → (B, λ·bs, β·bs) int8."""
    b, bs = stack.shape[0], p.block_size
    blocks = _region(stack, p.wgt, torch.int8).reshape(
        b, p.lam, p.beta, bs, bs)                    # each block is Bᵀ
    return blocks.permute(0, 1, 4, 2, 3).reshape(b, p.lam * bs, p.beta * bs)


def _decode_acc32(stack: torch.Tensor, p: CudaPlan,
                  span: Tuple[int, int]) -> torch.Tensor:
    """ACC/RES bytes → (B, α·rh, β·bs) int32 (X preload / residual)."""
    b = stack.shape[0]
    blocks = _region(stack, span, torch.int32).reshape(
        b, p.alpha, p.beta, p.row_height, p.block_size)
    return blocks.permute(0, 1, 3, 2, 4).reshape(
        b, p.alpha * p.row_height, p.beta * p.block_size)


def _encode_out(stack: torch.Tensor, p: CudaPlan, out: torch.Tensor) -> None:
    """(B, α·rh, β·bs) int8 result → OUT bytes, committed in place."""
    start, size = p.out
    b = stack.shape[0]
    blocks = out.reshape(b, p.alpha, p.row_height, p.beta, p.block_size)
    raw = blocks.permute(0, 1, 3, 2, 4).reshape(b, size)
    stack[:, start:start + size] = raw.view(torch.uint8)


def _to_vectors(mat: torch.Tensor, p: CudaPlan) -> torch.Tensor:
    """(B, H, W) → (B, n_vec, bs) block-major result vectors."""
    b = mat.shape[0]
    blocks = mat.reshape(b, p.alpha, p.row_height, p.beta, p.block_size)
    return blocks.permute(0, 1, 3, 2, 4).reshape(
        b, p.alpha * p.beta * p.row_height, p.block_size)


def _to_matrix(vec: torch.Tensor, p: CudaPlan) -> torch.Tensor:
    b = vec.shape[0]
    blocks = vec.reshape(b, p.alpha, p.beta, p.row_height, p.block_size)
    return blocks.permute(0, 1, 3, 2, 4).reshape(
        b, p.alpha * p.row_height, p.beta * p.block_size)


# ---------------------------------------------------------------------------
# The TensorAlu epilogue, vectorised over the batch (oracle semantics)
# ---------------------------------------------------------------------------

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with the two's-complement wrap."""
    return wrap_int32(x).to(torch.int32)


def _imm_apply(sel64: torch.Tensor, op: isa.AluOp, imm: int) -> torch.Tensor:
    if op == isa.AluOp.MIN:
        return torch.clamp(sel64, max=imm)
    if op == isa.AluOp.MAX:
        return torch.clamp(sel64, min=imm)
    if op == isa.AluOp.ADD:
        return sel64 + imm
    if op == isa.AluOp.SHR:
        return sel64 >> imm
    raise CompileError(f"unsupported ALU immediate op {op!r}",
                       constraint="cuda-alu-op")


def _binary_apply(a: torch.Tensor, b: torch.Tensor,
                  op: isa.AluOp) -> torch.Tensor:
    """Vector-vector ALU op on int64 operands (pair and residual forms)."""
    if op == isa.AluOp.MIN:
        return torch.minimum(a, b)
    if op == isa.AluOp.MAX:
        return torch.maximum(a, b)
    if op == isa.AluOp.ADD:
        return a + b
    if op == isa.AluOp.SHR:
        return a >> (b & 31)
    raise CompileError(f"unsupported ALU vector op {op!r}",
                       constraint="cuda-alu-op")


@dataclasses.dataclass(frozen=True)
class _PairLattice:
    """A pair op's index lattice, lowered once per device."""

    dst: torch.Tensor               # (P,) int64
    src: torch.Tensor               # (P,) int64
    touched: torch.Tensor           # unique dst
    sequential: bool


def _pair_arrays(pairs: Tuple[Tuple[int, int], ...], op: isa.AluOp
                 ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """``(dst, src, sequential)`` of a pair op, classified on the host (as
    the reference's ``_pair_apply``): disjoint dst/src lattices vectorise
    with duplicate-merging scatters — exact for ADD (mod-2³² congruence)
    and MIN/MAX (idempotent merges); anything order-dependent runs the
    pairs in order."""
    dst = np.fromiter((d for d, _ in pairs), dtype=np.int64, count=len(pairs))
    src = np.fromiter((s for _, s in pairs), dtype=np.int64, count=len(pairs))
    sequential = (np.intersect1d(dst, src).size > 0
                  or (op not in (isa.AluOp.ADD, isa.AluOp.MIN, isa.AluOp.MAX)
                      and len(np.unique(dst)) != len(dst)))
    return dst, src, sequential


def _pair_lattice(pairs: Tuple[Tuple[int, int], ...], op: isa.AluOp,
                  device: torch.device) -> _PairLattice:
    """:func:`_pair_arrays` as device tensors, for the torch epilogue."""
    dst, src, sequential = _pair_arrays(pairs, op)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int64, device=device)
    return _PairLattice(dst=as_t(dst), src=as_t(src),
                        touched=as_t(np.unique(dst)), sequential=sequential)


def _pair_apply(vec: torch.Tensor, op: isa.AluOp,
                pairs: Tuple[Tuple[int, int], ...],
                lattice: _PairLattice) -> torch.Tensor:
    """``vec[:, dst] = op(vec[:, dst], vec[:, src])`` per pair, in order."""
    if lattice.sequential:
        out = vec.clone()
        for d, s in pairs:
            out[:, d] = _wrap32(_binary_apply(out[:, d].to(torch.int64),
                                              out[:, s].to(torch.int64), op))
        return out
    dst, src = lattice.dst, lattice.src
    gathered = vec[:, src].to(torch.int64)          # (B, P, bs)
    acc = vec.to(torch.int64)
    if op == isa.AluOp.ADD:
        acc.index_add_(1, dst, gathered)
    elif op in (isa.AluOp.MAX, isa.AluOp.MIN):
        index = dst.view(1, -1, 1).expand_as(gathered)
        acc.scatter_reduce_(1, index, gathered,
                            reduce="amax" if op == isa.AluOp.MAX else "amin",
                            include_self=True)
    else:                                           # SHR with unique dst
        acc[:, dst] = acc[:, dst] >> (gathered & 31)
    out = vec.clone()
    out[:, lattice.touched] = _wrap32(acc[:, lattice.touched])
    return out


def lower_alu(alu_ops, device: torch.device) -> List[object]:
    """Per-op device data of an ALU program: index tensors for indexed
    ops, lattices for pair ops, None for the rest."""
    lowered: List[object] = []
    for spec in alu_ops:
        if isinstance(spec, AluIndexedImmOp):
            lowered.append(torch.as_tensor(spec.indices, dtype=torch.int64,
                                           device=device))
        elif isinstance(spec, AluPairOp):
            lowered.append(_pair_lattice(spec.pairs, spec.op, device))
        else:
            lowered.append(None)
    return lowered


def _per_device(prog, attr: str, device: torch.device, build):
    """``build()`` once per program and device, kept on ``prog`` under
    ``attr``, so a served batch copies nothing to the device for it.
    Racing threads may both build it; each stores it whole, so the race
    only duplicates work."""
    cache: Dict[str, object] = prog.__dict__.setdefault(attr, {})
    key = device_of(device)
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _lowered_alu(prog, p: CudaPlan, device: torch.device) -> List[object]:
    """:func:`lower_alu` of ``prog``, once per program and device."""
    return _per_device(prog, "_cuda_alu", device,
                       lambda: lower_alu(p.alu_ops, device))


def lower_alu_table(alu_ops, n_vec: int,
                    device: torch.device) -> vta_alu.AluTable:
    """An ALU program as the ``vta_alu`` kernel's table on ``device``: one
    row of ``vta_alu.ROW`` int64 words an op (kind, ALU op, immediate or
    RES pre-shift, offsets into the data after the rows), then the data.
    An indexed op keeps its indices once each (the plain version's
    ``vec[:, idx] = f(vec[:, idx])`` applies ``f`` once to a repeated
    index); a pair op whose lattice :func:`_pair_arrays` vectorises keeps
    its dsts, each dst's offsets into the srcs, and the srcs grouped by dst
    in the program's order; any other pair op keeps its (dst, src) pairs
    in order.  Every index must name one of the ``n_vec`` vectors."""
    kinds, rows, data = [], [], []
    base = len(alu_ops) * vta_alu.ROW

    def put(values) -> int:
        """Append ``values`` to the data; their first word's offset."""
        bad = [int(v) for v in values if not 0 <= v < n_vec]
        if bad:
            raise CompileError(
                f"ALU indices {bad[:4]} outside the program's {n_vec} result "
                f"vectors", constraint="cuda-alu-index")
        start = base + len(data)
        data.extend(int(v) for v in values)
        return start

    for spec in alu_ops:
        op = isa.AluOp(spec.op)
        if isinstance(spec, AluImmOp):
            kind, row = "imm", [spec.imm]
        elif isinstance(spec, AluResidualOp):
            kind, row = "res", [spec.pre_shift]
        elif isinstance(spec, AluIndexedImmOp):
            idx = np.unique(np.asarray(spec.indices, dtype=np.int64))
            kind, row = "indexed", [spec.imm, put(idx), len(idx)]
        elif isinstance(spec, AluPairOp):
            dst, src, sequential = _pair_arrays(spec.pairs, op)
            if sequential:
                kind = "pair_seq"
                row = [0, put(np.stack([dst, src], 1).reshape(-1)), len(dst)]
            else:
                order = np.argsort(dst, kind="stable")
                dsts, counts = np.unique(dst, return_counts=True)
                offsets = np.concatenate([[0], np.cumsum(counts)])
                kind = "pair"
                row = [0, put(dsts), len(dsts), base + len(data)]
                data.extend(int(o) for o in offsets)    # into the srcs
                row.append(put(src[order]))
        else:
            raise CompileError(f"unknown ALU spec {type(spec).__name__}",
                               constraint="cuda-alu-op")
        kinds.append(kind)
        rows.append([vta_alu.KINDS.index(kind), int(op), *row]
                    + [0] * (vta_alu.ROW - 2 - len(row)))
    structural = [i for i, k in enumerate(kinds)
                  if k not in vta_alu.ELEMENTWISE]
    lead = structural[0] if structural else len(kinds)
    tail = structural[-1] + 1 if structural else len(kinds)
    words = np.asarray([w for r in rows for w in r] + data, dtype=np.int64)
    return vta_alu.AluTable(
        words=torch.as_tensor(words, device=device), n_ops=len(kinds),
        lead=lead, tail=tail, residual="res" in kinds)


def _alu_table(prog, p: CudaPlan, device: torch.device) -> vta_alu.AluTable:
    """:func:`lower_alu_table` of ``prog``, once per program and device."""
    n_vec = p.alpha * p.beta * p.row_height
    return _per_device(prog, "_cuda_alu_table", device,
                       lambda: lower_alu_table(p.alu_ops, n_vec, device))


def apply_alu_epilogue(vec: torch.Tensor, alu_ops,
                       res_vec: Optional[torch.Tensor],
                       lowered: List[object]) -> torch.Tensor:
    """The full TensorAlu program over (B, n_vec, bs) int32 vectors —
    op-for-op the semantics of ``gemm_compiler.reference_result``.
    ``lowered`` is :func:`lower_alu` of ``alu_ops`` on ``vec``'s device."""
    for spec, aux in zip(alu_ops, lowered):
        if isinstance(spec, AluImmOp):
            vec = _wrap32(_imm_apply(vec.to(torch.int64), spec.op, spec.imm))
        elif isinstance(spec, AluIndexedImmOp):
            vec = vec.clone()
            vec[:, aux] = _wrap32(
                _imm_apply(vec[:, aux].to(torch.int64), spec.op, spec.imm))
        elif isinstance(spec, AluPairOp):
            vec = _pair_apply(vec, spec.op, spec.pairs, aux)
        elif isinstance(spec, AluResidualOp):
            if res_vec is None:
                raise CompileError(
                    "AluResidualOp requires a staged residual operand",
                    constraint="residual-operand-missing")
            r = res_vec.to(torch.int64)
            if spec.pre_shift:
                r = wrap_int32(r >> spec.pre_shift)
            vec = _wrap32(_binary_apply(vec.to(torch.int64), r, spec.op))
        else:
            raise CompileError(f"unknown ALU spec {type(spec).__name__}",
                               constraint="cuda-alu-op")
    return vec


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def _kernel_gemm(a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor], *, relu: bool, shift: int,
                 saturate: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """One fused-kernel call (the GEMM leg): the kernel on CUDA tensors,
    its plain version on CPU tensors."""
    return kernel_ops.vta_matmul(
        a.contiguous(), b.contiguous(),
        bias.contiguous() if bias is not None else None,
        relu=relu, shift=shift, saturate=saturate, out_dtype=out_dtype)


def _commit_int8(acc: torch.Tensor, saturate: bool) -> torch.Tensor:
    """ACC → OUT commit: §2.1 truncation, or the saturation upgrade."""
    if saturate:
        return torch.clamp(acc, -128, 127).to(torch.int8)
    return truncate_int8(acc)


def plain_alu_epilogue(acc: torch.Tensor, x: Optional[torch.Tensor],
                       res: Optional[torch.Tensor], p: CudaPlan,
                       lowered: List[object], saturate: bool) -> torch.Tensor:
    """The plain version of the ``vta_alu`` kernel: the GEMM's (B, Mp, Np)
    int32 result with the ACC preload ``x`` (one image's broadcasts over
    the batch), the TensorAlu program (``res`` the decoded RES) and the
    commit, as a (B, Mp, Np) int8 matrix."""
    if x is not None:                               # ACC preload (C = A·B+X)
        acc = _wrap32(acc.to(torch.int64) + x.to(torch.int64))
    vec = _to_vectors(acc, p)
    res_vec = _to_vectors(res, p) if res is not None else None
    vec = apply_alu_epilogue(vec, p.alu_ops, res_vec, lowered)
    return _commit_int8(_to_matrix(vec, p), saturate)


@dataclasses.dataclass(frozen=True)
class LayerConsts:
    """A program's constant operands and its fusion decision, read once
    from rows that share WGT and ACC (``NetworkProgram`` reads them off
    the compiled image, once per image and device): ``image``, the
    (1, nbytes) row the epilogue reads the ACC preload from; ``w``, the
    kernel's (Kp, Np) int8 weights, contiguous; ``bias``, the fused (Np,)
    int32 bias (None where the layer fuses none); ``fused``, whether the
    whole layer runs inside ``vta_gemm``."""

    image: torch.Tensor
    w: torch.Tensor
    bias: Optional[torch.Tensor]
    fused: bool


def layer_consts(prog, rows: torch.Tensor) -> LayerConsts:
    """:class:`LayerConsts` of ``prog`` from ``rows`` ((R, nbytes), or one
    1-D image), whose rows hold the same WGT and ACC bytes.

    A layer fuses where its ALU program has the kernel's form and its ACC
    preload, if it has one, is a row-broadcast bias (the bias form every
    compiled layer uses).  The kernel broadcasts the bias to *every* row
    including the §3.2 padding rows, where the oracle adds the stored X
    pad rows instead — fusing therefore also requires X's pad rows and
    A's pad rows in all R rows to be zero (true for every compiled image
    and every staged input), so the pad rows' oracle value is exactly 0
    and can be committed directly.  Pad *columns* need no special-casing
    in either form: the kernel computes them from the same decoded
    WGT/bias bytes the oracle reads.  Each check reads a device value
    back to the host (one synchronisation each)."""
    p = plan_cuda(prog)
    rows = rows.reshape(-1, rows.shape[-1])
    image = rows[:1]
    w = _decode_wgt(image, p)[0].contiguous()
    if p.acc is None or not p.fused:
        return LayerConsts(image, w, None, p.fused)
    m = p.valid_shape[0]
    x = _decode_acc32(image, p, p.acc)
    a = _decode_inp(rows, p)
    fused = (bool((x[:, :m] == x[:, :1]).all())
             and bool((x[:, m:] == 0).all())
             and bool((a[:, m:] == 0).all()))
    return LayerConsts(image, w, x[0, 0].contiguous() if fused else None,
                       fused)


def _execute_stack(prog, stack: torch.Tensor, a: torch.Tensor,
                   consts: LayerConsts, *, saturate: bool) -> SimReport:
    """Run ``prog`` over every DRAM row of ``stack``, whose WGT and ACC
    preload are ``consts`` and whose GEMM operands are ``a`` (the rows'
    (Mp, Kp) int8 operands stacked, contiguous), writing OUT bytes in
    place: one ``vta_gemm`` launch over the stacked rows and, on a layer
    that does not fuse, its TensorAlu epilogue (on a CUDA stack one
    ``vta_alu`` launch, which reads RES in place and ACC from
    ``consts.image``).  The stack's INP, WGT and ACC are not read."""
    p = plan_cuda(prog)
    b = stack.shape[0]
    mp, np_ = p.padded_shape
    m = p.valid_shape[0]
    with tracing.span("repro_torch.layer.gemm"):
        if consts.fused:                # the whole program inside the kernel
            out = _kernel_gemm(a, consts.w, consts.bias, relu=p.relu,
                               shift=p.shift, saturate=saturate,
                               out_dtype=torch.int8).reshape(b, mp, np_)
        else:
            acc = _kernel_gemm(a, consts.w, None, relu=False, shift=0,
                               saturate=False, out_dtype=torch.int32
                               ).reshape(b, mp, np_)
    if not consts.fused:
        with tracing.span("repro_torch.layer.epilogue",
                          alu=prog.alu_kind or "program"):
            if stack.device.type == "cuda":         # OUT written in place
                kernel_ops.vta_alu(
                    acc, stack, _alu_table(prog, p, stack.device),
                    blocks=(p.alpha, p.beta, p.row_height, p.block_size),
                    acc=p.acc, res=p.res, out=p.out, saturate=saturate,
                    acc_image=consts.image)
                out = None
            else:
                x = (_decode_acc32(consts.image, p, p.acc).expand(b, -1, -1)
                     if p.acc else None)
                res = _decode_acc32(stack, p, p.res) if p.res else None
                out = plain_alu_epilogue(
                    acc, x, res, p, _lowered_alu(prog, p, stack.device),
                    saturate)

    with tracing.span("repro_torch.layer.encode", bytes=b * p.out[1]):
        if out is not None:
            if consts.bias is not None:
                out[:, m:, :] = 0      # oracle pad rows: 0·B + 0 preload
            _encode_out(stack, p, out)
    report = SimReport()
    report.gemm_loops = b * prog.gemm_loops()
    report.alu_loops = b * prog.alu_loops()
    return report


# ---------------------------------------------------------------------------
# Simulator-shaped engines
# ---------------------------------------------------------------------------

def _refuse_fault_hook(fault_hook) -> None:
    if fault_hook is not None:
        raise ValueError(
            "fault_hook requires per-instruction execution; the cuda "
            "backend has no instruction stream to hook (fault injection "
            "runs on the reference package's interpreters)")


def _execute_rows(prog, stack: torch.Tensor, saturate: bool) -> SimReport:
    """:func:`_execute_stack` over rows that hold their own INP and share
    WGT and ACC: the operands decoded from INP, the constants read off
    the rows."""
    a = _decode_inp(stack, plan_cuda(prog)).flatten(0, 1).contiguous()
    return _execute_stack(prog, stack, a, layer_consts(prog, stack),
                          saturate=saturate)


class CudaSimulator:
    """Engine for one DRAM image: ``.run_program(prog)`` executes the
    compiled program on the kernel and commits OUT into ``self.dram`` (a
    uint8 tensor on ``device``) — the simulators' observable contract."""

    is_batch = False

    def __init__(self, cfg: VTAConfig, dram, *, device: DeviceLike = None,
                 saturate: bool = False, trace: bool = False,
                 count_overflows: bool = False):
        if trace or count_overflows:
            raise ValueError(
                "the cuda backend executes programs as fused kernel "
                "launches; per-instruction trace/overflow accounting needs "
                "a simulator backend of the reference package")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dram = torch.as_tensor(dram, dtype=torch.uint8).to(
            self.device, copy=True)
        self.saturate = saturate

    def run_program(self, prog, *, fault_hook=None) -> SimReport:
        _refuse_fault_hook(fault_hook)
        return _execute_rows(prog, self.dram.reshape(1, -1), self.saturate)

    def run(self, instructions, *, plan=None, fault_hook=None) -> SimReport:
        raise CompileError(
            "the cuda backend lowers compiled programs, not raw "
            "instruction streams; call run_program(prog)",
            constraint="cuda-program-metadata")


class BatchCudaSimulator(CudaSimulator):
    """The batch-axis variant over a ``(batch, nbytes)`` DRAM stack: a
    stack whose rows hold row 0's WGT and ACC bytes executes as one
    stacked kernel launch; any other, one row at a time, each with its
    own constants."""

    is_batch = True

    def __init__(self, cfg: VTAConfig, dram_stack, **kw):
        stack = torch.as_tensor(dram_stack, dtype=torch.uint8)
        super().__init__(cfg, torch.atleast_2d(stack), **kw)

    def run_program(self, prog, *, fault_hook=None) -> SimReport:
        _refuse_fault_hook(fault_hook)
        p, stack = plan_cuda(prog), self.dram
        if all(bool((stack[:, lo:lo + n] == stack[:1, lo:lo + n]).all())
               for lo, n in filter(None, (p.wgt, p.acc))):
            return _execute_rows(prog, stack, self.saturate)
        report = SimReport()
        for i in range(stack.shape[0]):
            r = _execute_rows(prog, stack[i:i + 1], self.saturate)
            report.gemm_loops += r.gemm_loops
            report.alu_loops += r.alu_loops
        return report


def run_program_cuda(prog, *, device: DeviceLike = None,
                     saturate: bool = False
                     ) -> Tuple[np.ndarray, SimReport]:
    """Execute one compiled program on the cuda backend; returns the
    decoded unpadded (M, N) result (on the host) + report."""
    from .simulator import decode_out_region
    sim = CudaSimulator(prog.config, prog.dram_image(), device=device,
                        saturate=saturate)
    report = sim.run_program(prog)
    return decode_out_region(prog, sim.dram.cpu().numpy()), report
