"""Vectorised VTA interpreters in torch: compiled instruction plans.

The port's counterpart of the reference's ``core/fast_simulator.py``.  The
oracle interpreter (:mod:`repro_torch.core.simulator`) executes
LOAD/STORE, GEMM and ALU element by element in Python loops.  This module
runs the same instruction stream bit-exactly with whole-instruction tensor
operations, in two stages:

1. **Plan compilation** (:func:`compile_plan`), copied from the reference
   and host numpy: the instruction stream is decoded *once* into an
   :class:`InstructionPlan` — the ``iter_out × iter_in × uop`` loop lattice
   of each GEMM/ALU instruction becomes precomputed index-offset arrays,
   each LOAD/STORE a strided byte-gather/scatter geometry.  Plans depend
   only on instruction fields, so they are cached per program
   (:func:`plan_for`).

2. **Execution** (:class:`FastSimulator`, :class:`BatchFastSimulator`):
   the DRAM image (or ``(batch, nbytes)`` stack) and the INP/WGT/ACC/OUT
   scratchpads are tensors on an explicit ``device`` — the card unless the
   caller names another — and only data moves there.  Index arithmetic
   (lattices, grouping, bounds checks) stays on the host in numpy exactly
   as the reference writes it, and the UOP scratchpad stays on the host
   because the GEMM/ALU lattices are built from its contents.  Every bounds
   check therefore runs on the host *before* any device gather: a CUDA
   gather out of range is a device-side assert that kills the process's
   CUDA context, so the typed :class:`VTABoundsError` must come first,
   without help from the device.

Bit-exactness against the oracle holds as in the reference:

* int32 wrap-around — sums are formed in int64 and wrapped once
  (:func:`~repro_torch.kernels.ref.wrap_int32`); torch's int32 overflow is
  never relied on;
* GEMM products run as float32 matmuls while a dot has at most
  ``_F32_EXACT_MAX_TERMS`` terms (exact: every partial sum is an integer
  below 2**24), under :func:`~repro_torch.device.strict_float32`; longer
  dots take an int64 product-sum;
* the reference's ``reduceat`` merges over host-computed groups become
  ``index_add_`` / ``scatter_reduce_`` (``amin``/``amax``) on group ids,
  exact in integers whatever the order;
* ALU lattices that read their own writes (``_alu_sequential``) copy the
  touched ACC rows to the host, run the reference's per-point loop there
  and copy them back.

No Pallas kernel stands behind the reference's interpreters, so none
stands behind these: they launch torch operations only, never
``vta_gemm``.  Reading a device value back to the host (a UOP load, a
batch-uniformity flag, an overflow count, a sequential ALU lattice) adds
one to :data:`syncs`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, device_of, resolve_device, \
    strict_float32
from repro_torch.kernels.ref import truncate_int8, wrap_int32

from . import isa
from .hwconfig import VTAConfig
from .simulator import (SimReport, TokenQueues, VTABoundsError,  # noqa: F401
                        VTAHazardError)

# Bound the per-chunk gather footprint of the GEMM products (the WGT gather
# materialises block_size² values per lattice point).
_GEMM_CHUNK_BYTES = 64 << 20

# A float32 mantissa holds integers up to 2**24 exactly, and a per-lane dot
# of ``n`` int8×int8 products is bounded by n·2¹⁴ (the extreme product is
# (-128)·(-128) = 16384), so for dots up to this many terms the float path
# is bit-exact; longer contractions take the int64 product-sum.
_F32_EXACT_MAX_TERMS = (1 << 24) // (128 * 128)       # 1024

#: device-to-host reads the interpreters made (see the module docstring)
syncs = 0
_syncs_lock = threading.Lock()


def _count_sync() -> None:
    global syncs
    with _syncs_lock:
        syncs += 1


def reset_syncs() -> None:
    global syncs
    with _syncs_lock:
        syncs = 0


# ---------------------------------------------------------------------------
# Plan steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _LoadStep:
    kind: str                   # uop | inp | wgt | acc | out
    mem: isa.MemId
    nbytes: int                 # bytes per structure
    zero_base: int              # SRAM span to clear (padding), len 0 = none
    zero_len: int
    sram_idx: np.ndarray        # (n,) destination structure indices
    byte_idx: np.ndarray        # (n, nbytes) DRAM byte gather lattice
    end_byte: int               # max byte index + 1, for the bounds check
    sram_end: int = 0           # max SRAM struct touched + 1 (pads included)
    contig: bool = False        # SRAM span and DRAM bytes both contiguous
    byte_start: int = 0         # first DRAM byte (contig fast path)


@dataclasses.dataclass
class _StoreStep:
    kind: str
    nbytes: int
    n: int                      # structures moved (sram_base..sram_base+n)
    sram_base: int
    byte_idx: Optional[np.ndarray]   # (n, nbytes) scatter, None -> row loop
    row_dram_starts: np.ndarray      # (y_size,) byte offsets (row-loop path)
    row_bytes: int
    end_byte: int


@dataclasses.dataclass
class _GemmStep:
    reset: bool
    u_idx: np.ndarray           # (nu,) uop buffer indices
    off_acc: np.ndarray         # (P,) iter_out×iter_in lattice offsets
    off_inp: np.ndarray
    off_wgt: np.ndarray
    loop_count: int


@dataclasses.dataclass
class _AluStep:
    op: isa.AluOp
    use_imm: bool
    imm: int
    u_idx: np.ndarray
    off_dst: np.ndarray         # (P,)
    off_src: np.ndarray
    loop_count: int


@dataclasses.dataclass
class _FinishStep:
    pass


@dataclasses.dataclass
class InstructionPlan:
    """A compiled instruction stream: one executable step per instruction.

    Dependency flags are read live from the instruction objects at
    execution time, so token-hazard behaviour tracks ``dep`` mutations;
    the precomputed index lattices assume the *geometry* fields are
    frozen after compilation.
    """

    steps: List[Tuple[object, object]]   # (insn, step payload)

    @property
    def n_insns(self) -> int:
        return len(self.steps)


# ---------------------------------------------------------------------------
# Plan compilation (host numpy, as the reference)
# ---------------------------------------------------------------------------

_MEM_KIND = {
    isa.MemId.UOP: "uop", isa.MemId.INP: "inp", isa.MemId.WGT: "wgt",
    isa.MemId.ACC: "acc", isa.MemId.OUT: "out",
}


def _outer_offsets(iter_out: int, iter_in: int, f_out: int, f_in: int
                   ) -> np.ndarray:
    """Ravelled ``i_out*f_out + i_in*f_in`` lattice, loop order (out, in)."""
    io = np.arange(iter_out, dtype=np.int64) * f_out
    ii = np.arange(iter_in, dtype=np.int64) * f_in
    return (io[:, None] + ii[None, :]).reshape(-1)


def _compile_load(cfg: VTAConfig, m: isa.MemInsn) -> _LoadStep:
    kind = _MEM_KIND[m.memory_type]
    nbytes = cfg.elem_bytes(kind)
    row_w = m.x_pad_0 + m.x_size + m.x_pad_1
    total_rows = m.y_pad_0 + m.y_size + m.y_pad_1
    has_pad = (m.y_pad_0 or m.y_pad_1 or m.x_pad_0 or m.x_pad_1)
    zero_len = total_rows * row_w if has_pad else 0

    y = np.arange(m.y_size, dtype=np.int64)
    x = np.arange(m.x_size, dtype=np.int64)
    sram_idx = (m.sram_base + (m.y_pad_0 + y)[:, None] * row_w
                + m.x_pad_0 + x[None, :]).reshape(-1)
    log_addr = (m.dram_base + y[:, None] * m.x_stride + x[None, :]).reshape(-1)
    byte_idx = (log_addr[:, None] * nbytes
                + np.arange(nbytes, dtype=np.int64)[None, :])
    end_byte = int(byte_idx.max(initial=-1)) + 1
    n = sram_idx.size
    contig = bool(
        n and not has_pad
        and np.array_equal(sram_idx,
                           np.arange(sram_idx[0], sram_idx[0] + n))
        and np.array_equal(byte_idx.reshape(-1),
                           np.arange(byte_idx[0, 0],
                                     byte_idx[0, 0] + n * nbytes)))
    sram_end = max(m.sram_base + zero_len,
                   int(sram_idx.max(initial=m.sram_base - 1)) + 1)
    return _LoadStep(kind=kind, mem=m.memory_type, nbytes=nbytes,
                     zero_base=m.sram_base, zero_len=zero_len,
                     sram_idx=sram_idx, byte_idx=byte_idx, end_byte=end_byte,
                     sram_end=sram_end, contig=contig,
                     byte_start=int(byte_idx[0, 0]) if n else 0)


def _compile_store(cfg: VTAConfig, m: isa.MemInsn) -> _StoreStep:
    kind = _MEM_KIND[m.memory_type]
    if kind == "uop":
        raise ValueError("STORE UOP is not a valid VTA instruction")
    nbytes = cfg.elem_bytes(kind)
    n = m.y_size * m.x_size
    row_bytes = m.x_size * nbytes
    y = np.arange(m.y_size, dtype=np.int64)
    row_dram_starts = (m.dram_base + y * m.x_stride) * nbytes
    end_byte = int((row_dram_starts.max(initial=-nbytes) + row_bytes))
    # Overlapping rows (stride < x_size) must be written in order; the
    # single-scatter path requires disjoint rows.
    overlap = m.y_size > 1 and m.x_stride < m.x_size
    byte_idx = None
    if not overlap:
        if n:
            byte_idx = (row_dram_starts[:, None]
                        + np.arange(row_bytes, dtype=np.int64)[None, :]
                        ).reshape(n, nbytes)
        else:
            byte_idx = np.zeros((0, nbytes), dtype=np.int64)
    return _StoreStep(kind=kind, nbytes=nbytes, n=n, sram_base=m.sram_base,
                      byte_idx=byte_idx, row_dram_starts=row_dram_starts,
                      row_bytes=row_bytes, end_byte=end_byte)


def _compile_gemm(g: isa.GemInsn) -> _GemmStep:
    n_uop = max(0, g.uop_end - g.uop_bgn)
    u_idx = np.arange(g.uop_bgn, g.uop_bgn + n_uop, dtype=np.int64)
    return _GemmStep(
        reset=bool(g.reset), u_idx=u_idx,
        off_acc=_outer_offsets(g.iter_out, g.iter_in,
                               g.acc_factor_out, g.acc_factor_in),
        off_inp=_outer_offsets(g.iter_out, g.iter_in,
                               g.inp_factor_out, g.inp_factor_in),
        off_wgt=_outer_offsets(g.iter_out, g.iter_in,
                               g.wgt_factor_out, g.wgt_factor_in),
        loop_count=g.iter_out * g.iter_in * n_uop)


def _compile_alu(a: isa.AluInsn) -> _AluStep:
    n_uop = max(0, a.uop_end - a.uop_bgn)
    u_idx = np.arange(a.uop_bgn, a.uop_bgn + n_uop, dtype=np.int64)
    return _AluStep(
        op=a.alu_opcode, use_imm=bool(a.use_imm), imm=a.imm, u_idx=u_idx,
        off_dst=_outer_offsets(a.iter_out, a.iter_in,
                               a.dst_factor_out, a.dst_factor_in),
        off_src=_outer_offsets(a.iter_out, a.iter_in,
                               a.src_factor_out, a.src_factor_in),
        loop_count=a.iter_out * a.iter_in * n_uop)


def compile_plan(cfg: VTAConfig, instructions) -> InstructionPlan:
    """Decode an instruction stream into its array-form execution plan."""
    steps: List[Tuple[object, object]] = []
    for insn in instructions:
        if isinstance(insn, isa.MemInsn):
            step = (_compile_load(cfg, insn)
                    if insn.opcode == isa.Opcode.LOAD
                    else _compile_store(cfg, insn))
        elif isinstance(insn, isa.GemInsn):
            step = _compile_gemm(insn)
        elif isinstance(insn, isa.AluInsn):
            step = _compile_alu(insn)
        elif isinstance(insn, isa.FinishInsn):
            step = _FinishStep()
        else:
            raise TypeError(insn)
        steps.append((insn, step))
    return InstructionPlan(steps=steps)


def plan_for(prog) -> InstructionPlan:
    """Cached plan for a :class:`~repro_torch.core.program.VTAProgram`.

    Recompiled when the instruction list changes (count or object
    identity).  Dependency flags are read live, so dep mutations need no
    invalidation; editing *geometry* fields of an existing instruction in
    place is not detected — call :func:`invalidate_plan` afterwards.
    """
    plan = getattr(prog, "_fast_plan", None)
    if (plan is None or plan.n_insns != len(prog.instructions)
            or any(step_insn is not insn for (step_insn, _), insn
                   in zip(plan.steps, prog.instructions))):
        plan = compile_plan(prog.config, prog.instructions)
        prog._fast_plan = plan
    return plan


def invalidate_plan(prog) -> None:
    if hasattr(prog, "_fast_plan"):
        del prog._fast_plan


# ---------------------------------------------------------------------------
# Grouping (host) and order-independent merges (device)
# ---------------------------------------------------------------------------

def _group(idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort ``idx``; return (order, sorted idx, group-start positions)."""
    order = np.argsort(idx, kind="stable")
    sidx = idx[order]
    starts = np.flatnonzero(np.r_[True, sidx[1:] != sidx[:-1]])
    return order, sidx, starts


def _group_ids(idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(unique destinations, group id of every element of ``idx``) — the
    destinations the reference's ``reduceat`` merges write, and the index
    an ``index_add_``/``scatter_reduce_`` merges by."""
    ud, gid = np.unique(idx, return_inverse=True)
    return ud, gid.reshape(-1)


def _step_tensor(step, name: str, arr: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """``arr`` (a plan field of ``step``) as an int64 tensor on ``device``,
    uploaded once per step and device.  Racing threads may both upload;
    each stores a whole tensor."""
    cache = step.__dict__.setdefault("_on_device", {})
    key = (name, device_of(device))
    t = cache.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)
                             ).to(device)
        cache[key] = t
    return t


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host (one counted synchronisation)."""
    _count_sync()
    return t.cpu().numpy()


def _count(mask: torch.Tensor) -> int:
    _count_sync()
    return int(mask.sum().item())


def _dots(W: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Exact per-lane dots ``out[..., i] = Σ_j W[..., i, j] · A[..., j]``
    (W stored transposed, §2.3) as int64."""
    if W.shape[-1] <= _F32_EXACT_MAX_TERMS:
        return torch.matmul(W.float(), A.float().unsqueeze(-1)
                            ).squeeze(-1).to(torch.int64)
    return (W.to(torch.int64) * A.to(torch.int64).unsqueeze(-2)).sum(-1)


def _dots_shared(W: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """:func:`_dots` with one weight operand ``W`` (l, bs, bs) shared by
    the batch ``A`` (B, l, bs) → (B, l, bs): one ``(l, bs, bs) @ (l, bs, B)``
    stack, the weights read once."""
    if W.shape[-1] <= _F32_EXACT_MAX_TERMS:
        return torch.matmul(W.float(), A.permute(1, 2, 0).float()
                            ).permute(2, 0, 1).to(torch.int64)
    return (W.to(torch.int64).unsqueeze(0)
            * A.to(torch.int64).unsqueeze(-2)).sum(-1)


def _alu_elementwise(op: isa.AluOp, x: torch.Tensor, y) -> torch.Tensor:
    """One ALU op on int64 operands; ``y`` an int immediate or a tensor."""
    scalar = isinstance(y, int)
    if op == isa.AluOp.MIN:
        return torch.clamp(x, max=y) if scalar else torch.minimum(x, y)
    if op == isa.AluOp.MAX:
        return torch.clamp(x, min=y) if scalar else torch.maximum(x, y)
    if op == isa.AluOp.ADD:
        return x + y
    if op == isa.AluOp.SHR:
        return x >> (y & 31)
    raise ValueError(op)


def _alu_elementwise_np(op: isa.AluOp, x: np.ndarray, y) -> np.ndarray:
    """The reference's host version (the sequential loop's step)."""
    if op == isa.AluOp.MIN:
        return np.minimum(x, y)
    if op == isa.AluOp.MAX:
        return np.maximum(x, y)
    if op == isa.AluOp.ADD:
        return x + y
    if op == isa.AluOp.SHR:
        return x >> (y & 31)
    raise ValueError(op)


def _alu_sequential(acc: torch.Tensor, op: isa.AluOp, d_idx: np.ndarray,
                    s_idx: np.ndarray) -> None:
    """Oracle loop order for lattices with cross-point dependencies, on
    the rows of the 2-D ``acc`` (any integer dtype) the lattice touches.

    On the device that loop would cost launches per point, so the touched
    rows come to the host, the reference's loop runs there — each step
    wraps to int32 before the next reads it, as the hardware and the oracle
    do — and the rows go back."""
    rows = np.unique(np.concatenate([d_idx, s_idx]))
    rows_t = torch.from_numpy(rows).to(acc.device)
    sub = _host(acc[rows_t]).astype(np.int64)
    for d, s in zip(np.searchsorted(rows, d_idx),
                    np.searchsorted(rows, s_idx)):
        sub[d] = _alu_elementwise_np(op, sub[d], sub[s]).astype(
            np.int32).astype(np.int64)
    acc[rows_t] = torch.from_numpy(sub).to(acc.device, acc.dtype)


def _as_dram(dram, device: torch.device, what: str,
             copy: bool = True) -> torch.Tensor:
    """A DRAM image or stack as a uint8 tensor on ``device``."""
    if isinstance(dram, torch.Tensor):
        if dram.dtype != torch.uint8:
            raise TypeError(f"dram {what} must be uint8")
        return dram.to(device, copy=copy)
    arr = np.asarray(dram)
    if arr.dtype != np.uint8:
        raise TypeError(f"dram {what} must be uint8")
    return torch.from_numpy(np.array(arr)).to(device)


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------

class FastSimulator:
    """Vectorised VTA functional simulator on ``device`` — bit-exact vs
    the oracle."""

    def __init__(self, cfg: VTAConfig, dram, *, trace: bool = False,
                 count_overflows: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dram = _as_dram(dram, self.device, "image")
        self.cfg = cfg
        self.trace = trace
        self.count_overflows = count_overflows
        bs = cfg.block_size
        dev = self.device
        self.uop_buf = np.zeros((cfg.uop_buff_entries, 3), dtype=np.int64)
        self.inp_buf = torch.zeros((cfg.inp_buff_vectors, bs),
                                   dtype=torch.int8, device=dev)
        self.wgt_buf = torch.zeros((cfg.wgt_buff_matrices, bs, bs),
                                   dtype=torch.int8, device=dev)
        self.acc_buf = torch.zeros((cfg.acc_buff_vectors, bs),
                                   dtype=torch.int32, device=dev)
        self.out_buf = torch.zeros((cfg.out_buff_vectors, bs),
                                   dtype=torch.int8, device=dev)
        self.tokens = TokenQueues()
        self.report = SimReport()

    # -------------------------------------------------------------- mem --
    def _buf_of(self, kind: str):
        return {"uop": self.uop_buf, "inp": self.inp_buf,
                "wgt": self.wgt_buf, "acc": self.acc_buf,
                "out": self.out_buf}[kind]

    def _t(self, arr: np.ndarray) -> torch.Tensor:
        """A host index array on the device."""
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)
                                ).to(self.device)

    def _decode_structs(self, kind: str, raw: torch.Tensor) -> torch.Tensor:
        """(n, nbytes) uint8 → n structures in SRAM form (INP/WGT/ACC; the
        UOP scratchpad decodes on the host, :func:`_decode_uops`)."""
        n = raw.shape[0]
        bs = self.cfg.block_size
        if kind == "inp":
            return raw.view(torch.int8).reshape(n, bs)
        if kind == "wgt":
            return raw.view(torch.int8).reshape(n, bs, bs)
        if kind == "acc":
            raw = raw.contiguous()
            if raw.storage_offset() % 4:
                raw = raw.clone()
            return raw.view(torch.int32).reshape(n, bs)
        raise ValueError(kind)

    @staticmethod
    def _decode_uops(raw: np.ndarray) -> np.ndarray:
        n = raw.shape[0]
        words = np.ascontiguousarray(raw).view("<u4").reshape(n).astype(
            np.int64)
        return np.stack([words & 0x7FF, (words >> 11) & 0x7FF,
                         (words >> 22) & 0x3FF], axis=1)

    def _encode_structs(self, kind: str, data: torch.Tensor) -> torch.Tensor:
        """n structures → (n, nbytes) uint8 (little-endian)."""
        n = data.shape[0]
        if kind in ("inp", "out", "wgt", "acc"):
            return data.contiguous().view(torch.uint8).reshape(n, -1)
        raise ValueError(kind)

    def _check_load(self, p: _LoadStep, cap: int, dram_len: int) -> None:
        """Shared LOAD bounds validation (single-image and batched).

        The SRAM check covers the *padding* span too — zero-fill through a
        slice would clip silently past the buffer end while the oracle
        raises."""
        if p.end_byte > dram_len:
            raise VTABoundsError(
                f"LOAD {p.kind.upper()} DRAM span ends at byte {p.end_byte} "
                f"> image size {dram_len}")
        if (p.zero_len or p.sram_idx.size) and p.sram_end > cap:
            raise VTABoundsError(
                f"LOAD {p.kind.upper()} SRAM span [{p.zero_base}, "
                f"{p.sram_end}) exceeds buffer capacity {cap} "
                f"(padding included)")

    def _gather_load(self, p: _LoadStep, dram: torch.Tensor) -> torch.Tensor:
        """The LOAD's bytes, ``(..., n, nbytes)`` over ``dram``'s leading
        axes."""
        n = p.sram_idx.size
        if p.contig:                              # one strided slice
            raw = dram[..., p.byte_start:p.byte_start + n * p.nbytes]
            return raw.reshape(dram.shape[:-1] + (n, p.nbytes))
        return dram[..., _step_tensor(p, "byte_idx", p.byte_idx,
                                      self.device)]

    def _exec_load(self, p: _LoadStep) -> None:
        buf = self._buf_of(p.kind)
        self._check_load(p, buf.shape[0], self.dram.shape[0])
        if p.zero_len:
            buf[p.zero_base:p.zero_base + p.zero_len] = 0
        if p.sram_idx.size:
            raw = self._gather_load(p, self.dram)
            if p.kind == "uop":
                buf[p.sram_idx] = self._decode_uops(_host(raw))
            elif p.contig:
                s0 = int(p.sram_idx[0])
                buf[s0:s0 + p.sram_idx.size] = self._decode_structs(p.kind,
                                                                    raw)
            else:
                buf[_step_tensor(p, "sram_idx", p.sram_idx, self.device)] = \
                    self._decode_structs(p.kind, raw)
        self.report.dram_bytes_read += p.byte_idx.size

    def _check_store(self, p: _StoreStep, cap: int, dram_len: int) -> None:
        if p.end_byte > dram_len:
            raise VTABoundsError(
                f"STORE {p.kind.upper()} DRAM span ends at byte "
                f"{p.end_byte} > image size {dram_len}")
        if p.sram_base + p.n > cap:
            raise VTABoundsError(
                f"STORE {p.kind.upper()} SRAM span [{p.sram_base}, "
                f"{p.sram_base + p.n}) exceeds buffer capacity {cap}")

    def _scatter_store(self, p: _StoreStep, dram: torch.Tensor,
                       raw: torch.Tensor) -> None:
        """Write ``raw`` (``(..., n, nbytes)``) to the STORE's bytes."""
        if p.byte_idx is not None:
            dram[..., _step_tensor(p, "byte_idx", p.byte_idx,
                                   self.device)] = raw
        else:                      # overlapping rows: write in order
            rows = raw.reshape(dram.shape[:-1] + (-1, p.row_bytes))
            for y, start in enumerate(p.row_dram_starts):
                start = int(start)
                dram[..., start:start + p.row_bytes] = rows[..., y, :]

    def _exec_store(self, p: _StoreStep) -> None:
        if p.n == 0:
            return            # degenerate geometry: the oracle's loop is empty
        buf = self._buf_of(p.kind)
        self._check_store(p, buf.shape[0], self.dram.shape[0])
        data = buf[p.sram_base:p.sram_base + p.n]
        raw = self._encode_structs(p.kind, data)
        self._scatter_store(p, self.dram, raw)
        self.report.dram_bytes_written += raw.numel()

    # ------------------------------------------------------------- gemm --
    def _lattice(self, off: np.ndarray, u_field: np.ndarray) -> np.ndarray:
        """(P,) outer offsets × (nu,) uop bases → (P·nu,) ravelled indices
        in the oracle's loop order (i_out, i_in, u)."""
        return (off[:, None] + u_field[None, :]).reshape(-1)

    def _check_uop_range(self, u_idx: np.ndarray, entries: int,
                         what: str) -> None:
        if u_idx.size and int(u_idx[-1]) >= entries:
            raise VTABoundsError(
                f"{what} uop range [{int(u_idx[0])}, {int(u_idx[-1]) + 1}) "
                f"exceeds UOP buffer capacity {entries}")

    @staticmethod
    def _check_lattice(idx: np.ndarray, cap: int, what: str) -> None:
        """Pre-mutation index-range check over a whole GEMM/ALU lattice."""
        if idx.size:
            hi = int(idx.max())
            if hi >= cap or int(idx.min()) < 0:
                raise VTABoundsError(
                    f"{what} index {hi if hi >= cap else int(idx.min())} "
                    f"out of range for buffer of {cap}")

    def _truncate_acc64(self, acc64: torch.Tensor, out: torch.Tensor) -> None:
        """int64 working copy → int32 buffer, counting wrapped lanes."""
        wrapped = wrap_int32(acc64)
        if self.count_overflows:
            self.report.acc_overflow_lanes += _count(acc64 != wrapped)
        out.copy_(wrapped)

    def _exec_gemm(self, p: _GemmStep) -> None:
        if p.loop_count == 0:
            return
        self._check_uop_range(p.u_idx, self.uop_buf.shape[0], "GEMM")
        uop = self.uop_buf[p.u_idx]                      # (nu, 3)
        x_idx = self._lattice(p.off_acc, uop[:, 0])
        self._check_lattice(x_idx, self.acc_buf.shape[0], "GEMM ACC")
        if p.reset:
            self.acc_buf[self._t(x_idx)] = 0
            self.report.gemm_reset_loops += p.loop_count
            return
        a_idx = self._lattice(p.off_inp, uop[:, 1])
        w_idx = self._lattice(p.off_wgt, uop[:, 2])
        self._check_lattice(a_idx, self.inp_buf.shape[0], "GEMM INP")
        self._check_lattice(w_idx, self.wgt_buf.shape[0], "GEMM WGT")
        bs = self.cfg.block_size
        chunk = max(1, _GEMM_CHUNK_BYTES // (bs * bs * 8))
        acc64 = self.acc_buf.to(torch.int64)
        x_t, a_t, w_t = self._t(x_idx), self._t(a_idx), self._t(w_idx)
        for lo in range(0, x_idx.size, chunk):
            sl = slice(lo, lo + chunk)
            # out[l, i] = Σ_j A[l, j] · W[l, i, j]  (W stored transposed)
            prod = _dots(self.wgt_buf[w_t[sl]], self.inp_buf[a_t[sl]])
            acc64.index_add_(0, x_t[sl], prod)       # duplicates merge exactly
        self._truncate_acc64(acc64, self.acc_buf)            # wrap-around
        self.report.gemm_loops += p.loop_count

    # -------------------------------------------------------------- alu --
    def _exec_alu(self, p: _AluStep) -> None:
        if p.loop_count == 0:
            return
        self._check_uop_range(p.u_idx, self.uop_buf.shape[0], "ALU")
        uop = self.uop_buf[p.u_idx]
        d_idx = self._lattice(p.off_dst, uop[:, 0])
        self._check_lattice(d_idx, self.acc_buf.shape[0], "ALU ACC dst")
        acc64 = self.acc_buf.to(torch.int64)
        if p.use_imm:
            self._alu_imm(acc64, p, d_idx)
        else:
            s_idx = self._lattice(p.off_src, uop[:, 1])
            self._check_lattice(s_idx, self.acc_buf.shape[0], "ALU ACC src")
            if np.intersect1d(d_idx, s_idx).size:
                # Read-after-write across lattice points: oracle order.
                _alu_sequential(acc64, p.op, d_idx, s_idx)
            else:
                self._alu_pair(acc64, p.op, d_idx, s_idx)
        self._truncate_acc64(acc64, self.acc_buf)
        self.report.alu_loops += p.loop_count

    def _imm_merge(self, sub: torch.Tensor, p: _AluStep,
                   counts: np.ndarray) -> torch.Tensor:
        """An immediate op applied ``counts[g]`` times to group ``g``'s
        rows, groups along axis -2 of ``sub`` (int64)."""
        imm = int(p.imm)
        if p.op in (isa.AluOp.MIN, isa.AluOp.MAX):
            return _alu_elementwise(p.op, sub, imm)   # idempotent
        counts = self._t(counts)[:, None]
        if p.op == isa.AluOp.ADD:
            return sub + imm * counts
        # SHR: k repeated c times on an int32-range value = shift c·k
        return sub >> torch.clamp((imm & 31) * counts, max=63)

    def _alu_imm(self, acc64: torch.Tensor, p: _AluStep,
                 d_idx: np.ndarray) -> None:
        _, sidx, starts = _group(d_idx)
        ud = self._t(sidx[starts])
        counts = np.diff(np.r_[starts, d_idx.size])
        acc64[ud] = self._imm_merge(acc64[ud], p, counts)

    def _pair_merge(self, sub: torch.Tensor, svals: torch.Tensor,
                    gid: torch.Tensor, op: isa.AluOp) -> torch.Tensor:
        """Merge the sources ``svals`` into their destination groups
        ``sub`` along axis -2 (``gid``: each source's group), as the
        reference's ``reduceat`` merges do."""
        axis = sub.dim() - 2
        if op in (isa.AluOp.MIN, isa.AluOp.MAX):
            index = gid.view((1,) * axis + (-1, 1)).expand_as(svals)
            return sub.scatter_reduce(
                axis, index, svals,
                "amin" if op == isa.AluOp.MIN else "amax",
                include_self=True)
        if op == isa.AluOp.ADD:
            return sub.index_add(axis, gid, svals)
        # SHR: per-lane shifts accumulate across duplicates
        shift = torch.zeros_like(sub).index_add_(axis, gid, svals & 31)
        return sub >> torch.clamp(shift, max=63)

    def _alu_pair(self, acc64: torch.Tensor, op: isa.AluOp,
                  d_idx: np.ndarray, s_idx: np.ndarray) -> None:
        """Sources disjoint from destinations: pre-state gather is exact."""
        svals = acc64[self._t(s_idx)]                     # (L, bs)
        ud, gid = _group_ids(d_idx)
        ud = self._t(ud)
        acc64[ud] = self._pair_merge(acc64[ud], svals, self._t(gid), op)

    # -------------------------------------------------------------- run --
    def _commit_out(self) -> None:
        """ACC → OUT truncation (§2.1: OUT vectors are truncated ACC)."""
        if self.count_overflows:
            self.report.acc_saturation_lanes += _count(
                (self.acc_buf < -128) | (self.acc_buf > 127))
        self.out_buf.copy_(truncate_int8(self.acc_buf))

    def run(self, instructions, plan: Optional[InstructionPlan] = None,
            *, fault_hook=None) -> SimReport:
        """Execute an instruction stream.  Pass a cached ``plan`` (from
        :func:`plan_for` / :func:`compile_plan`) to skip plan compilation;
        it must have been compiled from these instructions.
        ``fault_hook(sim, insn_idx)`` fires before each instruction — the
        harden subsystem's injection/watchdog point."""
        if plan is None:
            plan = compile_plan(self.cfg, instructions)
        elif plan.n_insns != len(instructions):
            raise ValueError("plan does not match instruction stream")
        with strict_float32():
            for i, (insn, step) in enumerate(plan.steps):
                if fault_hook is not None:
                    fault_hook(self, i)
                self.tokens.pre(insn)
                if isinstance(step, _LoadStep):
                    self._exec_load(step)
                    tag = f"{insn.opcode.name} {insn.memory_type.name}"
                elif isinstance(step, _StoreStep):
                    self._commit_out()
                    self._exec_store(step)
                    tag = f"{insn.opcode.name} {insn.memory_type.name}"
                elif isinstance(step, _GemmStep):
                    self._exec_gemm(step)
                    tag = f"GEMM{' reset' if step.reset else ''}"
                elif isinstance(step, _AluStep):
                    self._exec_alu(step)
                    tag = f"ALU {step.op.name}"
                else:
                    tag = "FINISH"
                self.report.insn_executed += 1
                if self.trace:
                    self.report.insn_trace.append(tag)
                self.tokens.post(insn)
                if isinstance(step, _FinishStep):
                    break
        self.tokens.account(self.report)
        return self.report


# ---------------------------------------------------------------------------
# Batched execution: one plan, N DRAM images
# ---------------------------------------------------------------------------

class BatchFastSimulator(FastSimulator):
    """One compiled :class:`InstructionPlan`, a ``(batch, nbytes)`` DRAM
    stack on ``device``: the batch axis is vectorised through every
    instruction.

    Every SRAM buffer grows a leading batch axis; LOAD/STORE run as batched
    strided gathers/scatters, GEMM as one contraction over the whole
    ``batch × lattice`` with per-image indices flattened into one global
    index space (row *b*'s indices offset by ``b · buffer_len``, so images
    never alias), and ALU reuses the single-image merges over the same
    flattened space.  The run is bit-identical to looping a single-image
    simulator over the stack's rows.

    The :class:`~repro_torch.core.simulator.SimReport` accumulates *batch
    totals*: loop counts and DRAM traffic equal the sum over the per-image
    oracle reports, while ``insn_executed``/``insn_trace`` count the
    instruction stream once.
    """

    def __init__(self, cfg: VTAConfig, dram, *, trace: bool = False,
                 copy_dram: bool = True, count_overflows: bool = False,
                 device: DeviceLike = None):
        if not isinstance(dram, torch.Tensor):
            dram = np.asarray(dram)
        if dram.dtype not in (np.dtype(np.uint8), torch.uint8):
            raise TypeError("dram stack must be uint8")
        if dram.ndim != 2 or dram.shape[0] < 1:
            raise ValueError(
                "batched dram image must be (batch, nbytes) with batch >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.count_overflows = count_overflows
        self.batch = int(dram.shape[0])
        # copy_dram=False hands a device stack over without the defensive
        # copy — the serve loop owns its stack and re-reads it from
        # ``sim.dram``, so the copy would be pure overhead there.
        self.dram = _as_dram(dram, self.device, "stack", copy=copy_dram)
        self.trace = trace
        bs = cfg.block_size
        b = self.batch
        dev = self.device
        self.uop_buf = np.zeros((b, cfg.uop_buff_entries, 3), dtype=np.int64)
        self.inp_buf = torch.zeros((b, cfg.inp_buff_vectors, bs),
                                   dtype=torch.int8, device=dev)
        self.wgt_buf = torch.zeros((b, cfg.wgt_buff_matrices, bs, bs),
                                   dtype=torch.int8, device=dev)
        self.acc_buf = torch.zeros((b, cfg.acc_buff_vectors, bs),
                                   dtype=torch.int32, device=dev)
        self.out_buf = torch.zeros((b, cfg.out_buff_vectors, bs),
                                   dtype=torch.int8, device=dev)
        self.tokens = TokenQueues()
        self.report = SimReport()
        # Batch-uniformity flags: True while every image in the batch holds
        # byte-identical UOP / WGT SRAM contents (the serving case — only
        # INP differs per request).  Uniform batches take the shared-lattice
        # paths.  The flags start True and latch False on the first
        # non-uniform LOAD; the general per-image paths stay bit-exact
        # either way.
        self._uniform = {"uop": True, "wgt": True}

    # -------------------------------------------------------------- mem --
    def _exec_load(self, p: _LoadStep) -> None:
        buf = self._buf_of(p.kind)
        self._check_load(p, buf.shape[1], self.dram.shape[1])
        if p.zero_len:
            buf[:, p.zero_base:p.zero_base + p.zero_len] = 0
        if p.sram_idx.size:
            n = p.sram_idx.size
            b = self.batch
            raw = self._gather_load(p, self.dram)            # (B, n, nbytes)
            if p.kind == "uop":
                host = _host(raw)
                if self._uniform["uop"]:
                    self._uniform["uop"] = bool(np.all(host == host[:1]))
                dec = self._decode_uops(host.reshape(b * n, p.nbytes)
                                        ).reshape(b, n, 3)
                buf[:, p.sram_idx] = dec
            else:
                if p.kind == "wgt" and self._uniform["wgt"] and b > 1:
                    _count_sync()
                    self._uniform["wgt"] = bool((raw == raw[:1]).all())
                dec = self._decode_structs(p.kind,
                                           raw.reshape(b * n, p.nbytes))
                dec = dec.reshape((b, n) + dec.shape[1:])
                if p.contig:
                    s0 = int(p.sram_idx[0])
                    buf[:, s0:s0 + n] = dec
                else:
                    buf[:, _step_tensor(p, "sram_idx", p.sram_idx,
                                        self.device)] = dec
        self.report.dram_bytes_read += p.byte_idx.size * self.batch

    def _exec_store(self, p: _StoreStep) -> None:
        if p.n == 0:
            return
        buf = self._buf_of(p.kind)
        self._check_store(p, buf.shape[1], self.dram.shape[1])
        data = buf[:, p.sram_base:p.sram_base + p.n]
        raw = self._encode_structs(
            p.kind, data.reshape((self.batch * p.n,) + data.shape[2:]))
        raw = raw.reshape(self.batch, p.n, p.nbytes)
        self._scatter_store(p, self.dram, raw)
        self.report.dram_bytes_written += raw.numel()

    # ------------------------------------------------------------ index --
    def _batch_lattice(self, off: np.ndarray, u_field: np.ndarray,
                       span: int, what: str) -> np.ndarray:
        """Per-image ``(P,)×(nu,)`` lattices → one flattened global index
        array, row *b* offset by ``b · span``.  Per-image indices are
        bounds-checked *before* the offset so an out-of-range program
        raises (as the oracle would) instead of aliasing into the next
        image's buffer."""
        lat = off[None, :, None] + u_field[:, None, :]        # (B, P, nu)
        if lat.size:
            hi = int(lat.max())
            if hi >= span or int(lat.min()) < 0:
                raise VTABoundsError(
                    f"{what} index {hi} out of range for buffer of {span}")
        lat = lat + (np.arange(self.batch, dtype=np.int64)
                     * span)[:, None, None]
        return lat.reshape(-1)

    # ------------------------------------------------------------- gemm --
    def _shared_lattice(self, off: np.ndarray, u_field: np.ndarray
                        ) -> np.ndarray:
        """Single-image lattice shared by the whole (uniform-UOP) batch."""
        return (off[:, None] + u_field[None, :]).reshape(-1)

    def _accum(self, acc: torch.Tensor, idx: torch.Tensor,
               red: torch.Tensor, axis: int) -> None:
        """``acc[idx] += red`` along ``axis`` with the int32 wrap,
        optionally counting wrapped lanes.  ``red`` is int64 holding
        int32-range values (the reference's int32 merges)."""
        wide = acc.index_select(axis, idx).to(torch.int64) + red
        wrapped = wrap_int32(wide)
        if self.count_overflows:
            self.report.acc_overflow_lanes += _count(wide != wrapped)
        acc.index_copy_(axis, idx, wrapped.to(torch.int32))

    def _exec_gemm(self, p: _GemmStep) -> None:
        if p.loop_count == 0:
            return
        self._check_uop_range(p.u_idx, self.uop_buf.shape[1], "GEMM")
        if self._uniform["uop"]:
            self._gemm_shared(p)
        else:
            self._gemm_general(p)
        field = ("gemm_reset_loops" if p.reset else "gemm_loops")
        setattr(self.report, field,
                getattr(self.report, field) + p.loop_count * self.batch)

    def _gemm_shared(self, p: _GemmStep) -> None:
        """Uniform UOP buffers: one lattice, one grouping — and, when the
        WGT buffers are uniform too (the serving case), one weight gather —
        for the whole batch."""
        uop = self.uop_buf[0, p.u_idx]                        # (nu, 3)
        x_idx = self._shared_lattice(p.off_acc, uop[:, 0])
        self._check_lattice(x_idx, self.acc_buf.shape[1], "GEMM ACC")
        if p.reset:
            self.acc_buf[:, self._t(x_idx)] = 0
            return
        a_idx = self._shared_lattice(p.off_inp, uop[:, 1])
        w_idx = self._shared_lattice(p.off_wgt, uop[:, 2])
        self._check_lattice(a_idx, self.inp_buf.shape[1], "GEMM INP")
        self._check_lattice(w_idx, self.wgt_buf.shape[1], "GEMM WGT")
        bs = self.cfg.block_size
        b = self.batch
        w_uniform = self._uniform["wgt"]
        # Fused-contraction form: when every destination vector receives
        # the same number ``c`` of lattice points (the compiled-matmul
        # k-loop shape), fold the duplicate-destination reduction into the
        # matmul itself — one (G, bs, c·bs) @ (G, c·bs, B) stack computes
        # GEMM *and* merge.  Exact while the c·bs-term dot stays within
        # float32's 2**24 integer range.
        if w_uniform:
            order, sidx, starts = _group(x_idx)
            counts = np.diff(np.r_[starts, x_idx.size])
            if (counts.size and int(counts.min()) == int(counts.max())
                    and int(counts[0]) * bs <= _F32_EXACT_MAX_TERMS):
                self._gemm_shared_fused(a_idx, w_idx, order,
                                        sidx[starts], int(counts[0]))
                return
        per_point = bs * bs * (1 if w_uniform else b) * 4 + 9 * b * bs
        chunk = max(1, _GEMM_CHUNK_BYTES // per_point)
        a_t, w_t = self._t(a_idx), self._t(w_idx)
        for lo in range(0, x_idx.size, chunk):
            sl = slice(lo, lo + chunk)
            A = self.inp_buf[:, a_t[sl]]                      # (B, l, bs)
            if w_uniform:
                # the weight operand is shared by the whole batch
                prod = _dots_shared(self.wgt_buf[0, w_t[sl]], A)
            else:
                prod = _dots(self.wgt_buf[:, w_t[sl]], A)     # (B, l, bs)
            # merge duplicate destinations, then one accumulate; chunks
            # compose because the int32 adds wrap exactly mod 2**32
            ud, gid = _group_ids(x_idx[sl])
            red = torch.zeros((b, ud.size, bs), dtype=torch.int64,
                              device=self.device).index_add_(
                1, self._t(gid), prod)
            self._accum(self.acc_buf, self._t(ud), wrap_int32(red), 1)

    def _gemm_shared_fused(self, a_idx: np.ndarray, w_idx: np.ndarray,
                           order: np.ndarray, ud: np.ndarray,
                           c: int) -> None:
        """Uniform-W regular-lattice GEMM: destination-grouped operands,
        reduction fused into the matmul contraction (addition is
        commutative and the float32 dots are exact, so any within-group
        order gives the oracle's mod-2**32 result)."""
        bs = self.cfg.block_size
        b = self.batch
        ncon = c * bs                                 # contraction length
        g = ud.size
        ao = self._t(a_idx[order].reshape(g, c))
        wo = self._t(w_idx[order].reshape(g, c))
        ud_t = self._t(ud)
        per_group = ncon * (bs + b) * 8               # f32 Wg + Ag + prod
        gchunk = max(1, _GEMM_CHUNK_BYTES // per_group)
        for lo in range(0, g, gchunk):
            sl = slice(lo, lo + gchunk)
            Wg = self.wgt_buf[0, wo[sl]]              # (g, c, bs, bs)
            Wg = Wg.permute(0, 2, 1, 3).reshape(-1, bs, ncon)
            Ag = self.inp_buf[:, ao[sl]]              # (B, g, c, bs)
            Ag = Ag.permute(1, 2, 3, 0).reshape(-1, ncon, b)
            prod = torch.matmul(Wg.float(), Ag.float())       # (g, bs, B)
            red = prod.permute(2, 0, 1).to(torch.int64)       # (B, g, bs)
            self._accum(self.acc_buf, ud_t[sl], red, 1)

    def _gemm_general(self, p: _GemmStep) -> None:
        """Per-image UOP buffers: flatten every image's lattice into one
        global index space (row *b* offset by ``b · buffer_len``) and run
        one contraction + merge over the whole batch."""
        uop = self.uop_buf[:, p.u_idx]                        # (B, nu, 3)
        n_acc = self.acc_buf.shape[1]
        x_idx = self._batch_lattice(p.off_acc, uop[:, :, 0], n_acc, "ACC")
        bs = self.cfg.block_size
        acc_flat = self.acc_buf.view(-1, bs)
        if p.reset:
            acc_flat[self._t(x_idx)] = 0
            return
        a_idx = self._batch_lattice(p.off_inp, uop[:, :, 1],
                                    self.inp_buf.shape[1], "INP")
        w_idx = self._batch_lattice(p.off_wgt, uop[:, :, 2],
                                    self.wgt_buf.shape[1], "WGT")
        inp_flat = self.inp_buf.view(-1, bs)
        wgt_flat = self.wgt_buf.view(-1, bs, bs)
        chunk = max(1, _GEMM_CHUNK_BYTES // (bs * bs * 4))
        a_t, w_t = self._t(a_idx), self._t(w_idx)
        for lo in range(0, x_idx.size, chunk):
            sl = slice(lo, lo + chunk)
            prod = _dots(wgt_flat[w_t[sl]], inp_flat[a_t[sl]])   # (l, bs)
            ud, gid = _group_ids(x_idx[sl])
            red = torch.zeros((ud.size, bs), dtype=torch.int64,
                              device=self.device).index_add_(
                0, self._t(gid), prod)
            self._accum(acc_flat, self._t(ud), wrap_int32(red), 0)

    # -------------------------------------------------------------- alu --
    def _exec_alu(self, p: _AluStep) -> None:
        if p.loop_count == 0:
            return
        bs = self.cfg.block_size
        n_acc = self.acc_buf.shape[1]
        self._check_uop_range(p.u_idx, self.uop_buf.shape[1], "ALU")
        if self._uniform["uop"]:
            uop = self.uop_buf[0, p.u_idx]
            d_idx = self._shared_lattice(p.off_dst, uop[:, 0])
            self._check_lattice(d_idx, n_acc, "ALU ACC dst")
            if p.use_imm:
                self._alu_imm_shared(p, d_idx)
            else:
                s_idx = self._shared_lattice(p.off_src, uop[:, 1])
                # pre-offset bounds check, as in _batch_lattice: an
                # out-of-range source must raise (as the oracle does),
                # never read a neighbouring image's ACC rows
                self._check_lattice(s_idx, n_acc, "ALU ACC src")
                if np.intersect1d(d_idx, s_idx).size:
                    # Same RAW pattern on every image: flatten globally and
                    # run the oracle-order loop once per (image, point).
                    base = (np.arange(self.batch, dtype=np.int64)
                            * n_acc)[:, None]
                    gd = (d_idx[None, :] + base).reshape(-1)
                    gs = (s_idx[None, :] + base).reshape(-1)
                    _alu_sequential(self.acc_buf.view(-1, bs), p.op, gd, gs)
                else:
                    self._alu_pair_shared(p.op, d_idx, s_idx)
        else:
            uop = self.uop_buf[:, p.u_idx]
            d_idx = self._batch_lattice(p.off_dst, uop[:, :, 0], n_acc,
                                        "ACC dst")
            acc_flat = self.acc_buf.view(-1, bs)
            acc64 = acc_flat.to(torch.int64)
            if p.use_imm:
                self._alu_imm(acc64, p, d_idx)
            else:
                s_idx = self._batch_lattice(p.off_src, uop[:, :, 1], n_acc,
                                            "ACC src")
                if np.intersect1d(d_idx, s_idx).size:
                    # Flattened order is batch-major and batches are
                    # disjoint in the global index space, so this equals
                    # the oracle's per-image loop order on every image.
                    _alu_sequential(acc64, p.op, d_idx, s_idx)
                else:
                    self._alu_pair(acc64, p.op, d_idx, s_idx)
            self._truncate_acc64(acc64, acc_flat)
        self.report.alu_loops += p.loop_count * self.batch

    def _write_rows(self, ud: torch.Tensor, sub: torch.Tensor) -> None:
        """Wrap the merged int64 rows to int32 (counting wrapped lanes)
        and write them back; untouched ACC rows never move."""
        wrapped = wrap_int32(sub)
        if self.count_overflows:
            self.report.acc_overflow_lanes += _count(sub != wrapped)
        self.acc_buf.index_copy_(1, ud, wrapped.to(torch.int32))

    def _alu_imm_shared(self, p: _AluStep, d_idx: np.ndarray) -> None:
        """Immediate-form ALU over a shared lattice: group once, apply the
        merged op across the batch axis (the single-image merges)."""
        _, sidx, starts = _group(d_idx)
        ud = self._t(sidx[starts])
        counts = np.diff(np.r_[starts, d_idx.size])
        sub = self.acc_buf.index_select(1, ud).to(torch.int64)   # (B, G, bs)
        self._write_rows(ud, self._imm_merge(sub, p, counts))

    def _alu_pair_shared(self, op: isa.AluOp, d_idx: np.ndarray,
                         s_idx: np.ndarray) -> None:
        """Vector-pair ALU over a shared lattice (sources disjoint from
        destinations on every image); touched rows only, as above."""
        svals = self.acc_buf.index_select(1, self._t(s_idx)).to(torch.int64)
        ud, gid = _group_ids(d_idx)
        ud = self._t(ud)
        sub = self.acc_buf.index_select(1, ud).to(torch.int64)   # (B, G, bs)
        self._write_rows(ud, self._pair_merge(sub, svals, self._t(gid), op))


def run_batch(cfg: VTAConfig, dram_stack, instructions, *,
              plan: Optional[InstructionPlan] = None, trace: bool = False,
              fault_hook=None, count_overflows: bool = False,
              device: DeviceLike = None) -> Tuple[torch.Tensor, SimReport]:
    """Execute one instruction stream over a ``(batch, nbytes)`` DRAM stack
    on ``device``.

    Returns ``(dram_stack_after, report)``, the stack a uint8 tensor on
    ``device``.  Bit-identical to running the single-image simulator over
    each row of the stack independently; pass a cached ``plan``
    (:func:`plan_for`) to amortise plan compilation across calls.
    """
    sim = BatchFastSimulator(cfg, dram_stack, trace=trace,
                             count_overflows=count_overflows, device=device)
    report = sim.run(instructions, plan=plan, fault_hook=fault_hook)
    return sim.dram, report
