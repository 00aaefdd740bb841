"""Functional VTA simulator (paper §5.1) — bit-accurate instruction interpreter.

Replaces the paper's extracted C++ functional simulator with a pure-numpy
interpreter that consumes exactly the artefacts the compiler emits: a DRAM
image (or the per-region segments) plus the instruction stream.  It is the
*oracle* every other execution path is validated against — in the port,
the CUDA backend (:mod:`repro_torch.core.cuda_backend`, ``backend="cuda"``)
that executes compiled programs on the hand-written ``vta_gemm`` kernel.
The reference's vectorised numpy interpreters (``"fast"``, ``"batched"``)
are not ported yet; asking for them raises.

Semantics implemented:

* LOAD/STORE — 2-D strided DRAM<->SRAM moves with x/y zero-padding
  (``MemInsn``), per buffer (UOP/WGT/INP/ACC/OUT); mid-stream LOAD UOP
  re-fills (the §3.3 uop waves of multi-chunk programs, DESIGN.md §3) are
  ordinary compute-module loads;
* GEMM — Algorithm 1 verbatim, including ``reset``; int8×int8 products
  accumulated into int32 with wrap-around;
* ALU — MIN/MAX/ADD/SHR over ACC vectors, immediate or vector-pair form;
* FINISH — terminates execution;
* dependency flags — the 4 producer/consumer token queues of §2.3 are
  modelled as counters; a pop on an empty queue means the compiler emitted a
  hazard (the real hardware would deadlock), so the simulator raises.

Observability (§5.1): the simulator reports DRAM traffic, GeMM/ALU loop
counts and per-instruction execution order — the metrics the paper uses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import isa
from .hwconfig import VTAConfig
from .layout import truncate_int8
from .program import VTAProgram


class VTAHazardError(RuntimeError):
    """A dependency-token pop on an empty queue: the instruction stream
    would deadlock the Load/Compute/Store modules on real hardware."""


class VTABoundsError(VTAHazardError, IndexError):
    """An SRAM or DRAM access outside the configured address space.

    Every simulator backend raises this *before* mutating any state, with
    the offending instruction fields in the message (DESIGN.md
    §Hardening).  Historically these paths surfaced as bare numpy
    ``IndexError``/``ValueError`` deep inside a gather — or, for
    padding that ran past an SRAM buffer, as a silent clip on the
    vectorised backends; the subclassing keeps ``IndexError`` callers
    working while making the fault typed and attributable."""


def module_of(insn) -> str:
    """Which VTA module executes ``insn`` (mirrors the VTA runtime):
    LOAD INP/WGT run on Load; LOAD UOP/ACC, GEMM and ALU on Compute;
    STORE OUT on Store."""
    if isinstance(insn, isa.MemInsn):
        if insn.opcode == isa.Opcode.STORE:
            return "store"
        if insn.memory_type in (isa.MemId.INP, isa.MemId.WGT):
            return "load"
        return "compute"
    return "compute"           # GEMM / ALU / FINISH


class TokenQueues:
    """The 4 producer/consumer dependency-token queues of §2.3, modelled as
    counters.  Shared by every simulator backend: a pop on an empty queue
    means the compiler emitted a hazard (real hardware would deadlock)."""

    _PREV = {"load": None, "compute": "load", "store": "compute"}
    _NEXT = {"load": "compute", "compute": "store", "store": None}

    def __init__(self) -> None:
        self.counters: Dict[Tuple[str, str], int] = {
            ("load", "compute"): 0, ("compute", "load"): 0,
            ("compute", "store"): 0, ("store", "compute"): 0,
        }
        # Accounting for SimReport (DESIGN.md §Pipeline): total token
        # traffic and the deepest any queue ever got — the pipelined
        # schedule shows up as high_water 2 on the producer queues.
        self.pops = 0
        self.pushes = 0
        self.high_water = 0

    def _pop(self, src: Optional[str], dst: str) -> None:
        if src is None:
            raise VTAHazardError(f"{dst}: pop from nonexistent neighbour")
        if self.counters[(src, dst)] <= 0:
            raise VTAHazardError(
                f"dependency hazard: {dst} pops empty queue from {src}")
        self.counters[(src, dst)] -= 1
        self.pops += 1

    def _push(self, src: str, dst: Optional[str]) -> None:
        if dst is None:
            raise VTAHazardError(f"{src}: push to nonexistent neighbour")
        self.counters[(src, dst)] += 1
        self.pushes += 1
        if self.counters[(src, dst)] > self.high_water:
            self.high_water = self.counters[(src, dst)]

    def pre(self, insn) -> None:
        mod = module_of(insn)
        if insn.dep.pop_prev:
            self._pop(self._PREV[mod], mod)
        if insn.dep.pop_next:
            self._pop(self._NEXT[mod], mod)

    def post(self, insn) -> None:
        mod = module_of(insn)
        if insn.dep.push_prev:
            self._push(mod, self._PREV[mod])
        if insn.dep.push_next:
            self._push(mod, self._NEXT[mod])

    def account(self, report: "SimReport") -> None:
        """Fold the token traffic into a :class:`SimReport` (additive, so
        multi-layer/network runs accumulate across streams)."""
        report.dep_pops += self.pops
        report.dep_pushes += self.pushes
        report.dep_queue_high_water = max(report.dep_queue_high_water,
                                          self.high_water)
        self.pops = 0
        self.pushes = 0


@dataclasses.dataclass
class SimReport:
    """What the functional simulator can observe (§5.1)."""

    gemm_loops: int = 0            # non-reset GeMM loops (the 2942 metric)
    gemm_reset_loops: int = 0
    alu_loops: int = 0
    dram_bytes_read: int = 0
    dram_bytes_written: int = 0
    insn_executed: int = 0
    insn_trace: List[str] = dataclasses.field(default_factory=list)
    # Integrity counters (DESIGN.md §Hardening) — populated only when the
    # simulator is built with ``count_overflows=True``; the conformance
    # suites compare loop/traffic fields, so these ride along freely.
    acc_overflow_lanes: int = 0    # int32 lanes that wrapped in GEMM/ALU
    acc_saturation_lanes: int = 0  # ACC lanes outside int8 at OUT commit
    # §2.3 dependency-token traffic (DESIGN.md §Pipeline): pops/pushes
    # processed and the deepest any of the four queues ever got —
    # serialized streams stay at 1; the double-buffered schedule reaches 2.
    dep_pops: int = 0
    dep_pushes: int = 0
    dep_queue_high_water: int = 0

    @property
    def dram_bytes_total(self) -> int:
        return self.dram_bytes_read + self.dram_bytes_written


def _wrap32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int64).astype(np.int32)


class FunctionalSimulator:
    """Bit-accurate VTA functional simulator."""

    def __init__(self, cfg: VTAConfig, dram: np.ndarray, *, trace: bool = False,
                 count_overflows: bool = False):
        if dram.dtype != np.uint8:
            raise TypeError("dram image must be uint8")
        self.cfg = cfg
        self.dram = dram.copy()
        self.trace = trace
        self.count_overflows = count_overflows
        bs = cfg.block_size
        # SRAM buffers, in structure units.
        self.uop_buf = np.zeros((cfg.uop_buff_entries, 3), dtype=np.int64)
        self.inp_buf = np.zeros((cfg.inp_buff_vectors, bs), dtype=np.int8)
        self.wgt_buf = np.zeros((cfg.wgt_buff_matrices, bs, bs), dtype=np.int8)
        self.acc_buf = np.zeros((cfg.acc_buff_vectors, bs), dtype=np.int32)
        self.out_buf = np.zeros((cfg.out_buff_vectors, bs), dtype=np.int8)
        # Dependency-token queues between modules (§2.3).
        self.tokens = TokenQueues()
        self.report = SimReport()

    # ------------------------------------------------------------------
    # Memory instructions
    # ------------------------------------------------------------------
    def _mem_view(self, mem: isa.MemId):
        return {
            isa.MemId.UOP: self.uop_buf,
            isa.MemId.INP: self.inp_buf,
            isa.MemId.WGT: self.wgt_buf,
            isa.MemId.ACC: self.acc_buf,
            isa.MemId.OUT: self.out_buf,
        }[mem]

    _MEM_KIND = {
        isa.MemId.UOP: "uop", isa.MemId.INP: "inp", isa.MemId.WGT: "wgt",
        isa.MemId.ACC: "acc", isa.MemId.OUT: "out",
    }

    def _struct_from_dram(self, kind: str, log_addr: int) -> np.ndarray:
        cfg = self.cfg
        nbytes = cfg.elem_bytes(kind)
        start = log_addr * nbytes
        raw = self.dram[start:start + nbytes]
        if len(raw) < nbytes:
            raise IndexError(
                f"DRAM read out of range: {kind} logical @{log_addr:#x}")
        self.report.dram_bytes_read += nbytes
        bs = cfg.block_size
        if kind == "uop":
            word = int.from_bytes(raw.tobytes(), "little")
            acc, inp, wgt = isa._unpack(word, isa.Uop.W)
            return np.array([acc, inp, wgt], dtype=np.int64)
        if kind == "inp":
            return raw.view(np.int8).reshape(bs)
        if kind == "wgt":
            return raw.view(np.int8).reshape(bs, bs)
        if kind == "acc":
            return raw.view("<i4").reshape(bs).astype(np.int32)
        raise ValueError(kind)

    def _struct_to_dram(self, kind: str, log_addr: int, data: np.ndarray) -> None:
        cfg = self.cfg
        nbytes = cfg.elem_bytes(kind)
        start = log_addr * nbytes
        if start + nbytes > len(self.dram):
            raise IndexError(
                f"DRAM write out of range: {kind} logical @{log_addr:#x}")
        self.dram[start:start + nbytes] = np.frombuffer(
            np.ascontiguousarray(data).tobytes(), dtype=np.uint8)
        self.report.dram_bytes_written += nbytes

    def _check_mem_bounds(self, insn: isa.MemInsn) -> None:
        """Reject out-of-range SRAM/DRAM spans *before* any state mutates.

        Shared bounds model for every backend (DESIGN.md §Hardening):
        LOAD touches ``(pads+y_size) × (pads+x_size)`` consecutive SRAM
        structs from ``sram_base`` (padding writes zeros, so it counts);
        STORE consumes ``y_size × x_size``.  DRAM addresses grow
        monotonically with y, so the last element of the last row bounds
        the transfer."""
        kind = self._MEM_KIND[insn.memory_type]
        cap = self._mem_view(insn.memory_type).shape[0]
        is_load = insn.opcode == isa.Opcode.LOAD
        if is_load:
            row_w = insn.x_pad_0 + insn.x_size + insn.x_pad_1
            span = (insn.y_pad_0 + insn.y_size + insn.y_pad_1) * row_w
        else:
            span = insn.y_size * insn.x_size
        if span and insn.sram_base + span > cap:
            raise VTABoundsError(
                f"{insn.opcode.name} {kind.upper()} SRAM span "
                f"[{insn.sram_base}, {insn.sram_base + span}) exceeds "
                f"buffer capacity {cap} (x_size={insn.x_size} "
                f"y_size={insn.y_size} pads=({insn.x_pad_0},{insn.x_pad_1},"
                f"{insn.y_pad_0},{insn.y_pad_1}))")
        if insn.y_size and insn.x_size:
            nbytes = self.cfg.elem_bytes(kind)
            last = (insn.dram_base + (insn.y_size - 1) * insn.x_stride
                    + insn.x_size - 1)
            end = (last + 1) * nbytes
            if end > self.dram_nbytes():
                raise VTABoundsError(
                    f"{insn.opcode.name} {kind.upper()} DRAM span ends at "
                    f"byte {end} > image size {self.dram_nbytes()} "
                    f"(dram_base={insn.dram_base:#x} x_size={insn.x_size} "
                    f"y_size={insn.y_size} x_stride={insn.x_stride})")

    def dram_nbytes(self) -> int:
        return len(self.dram)

    def _exec_mem(self, insn: isa.MemInsn) -> None:
        kind = self._MEM_KIND[insn.memory_type]
        if (insn.opcode == isa.Opcode.STORE
                and insn.memory_type == isa.MemId.UOP):
            raise ValueError("STORE UOP is not a valid VTA instruction")
        self._check_mem_bounds(insn)
        buf = self._mem_view(insn.memory_type)
        if insn.opcode == isa.Opcode.LOAD:
            sram = insn.sram_base
            for y in range(insn.y_pad_0):
                for _ in range(insn.x_pad_0 + insn.x_size + insn.x_pad_1):
                    buf[sram] = 0
                    sram += 1
            for y in range(insn.y_size):
                for _ in range(insn.x_pad_0):
                    buf[sram] = 0
                    sram += 1
                dram = insn.dram_base + y * insn.x_stride
                for x in range(insn.x_size):
                    buf[sram] = self._struct_from_dram(kind, dram + x)
                    sram += 1
                for _ in range(insn.x_pad_1):
                    buf[sram] = 0
                    sram += 1
            for y in range(insn.y_pad_1):
                for _ in range(insn.x_pad_0 + insn.x_size + insn.x_pad_1):
                    buf[sram] = 0
                    sram += 1
        else:  # STORE (OUT only on real VTA)
            sram = insn.sram_base
            for y in range(insn.y_size):
                dram = insn.dram_base + y * insn.x_stride
                for x in range(insn.x_size):
                    self._struct_to_dram(kind, dram + x, buf[sram])
                    sram += 1

    # ------------------------------------------------------------------
    # GEMM — Algorithm 1, verbatim loop structure.
    # ------------------------------------------------------------------
    def _check_tensor_bounds(self, t, *, is_alu: bool) -> None:
        """Static pre-check of every index a GEMM/ALU lattice will touch.

        The maximum index per operand is ``max_outer_offset + max(uop
        field)`` because iteration offsets and uop entries are both
        non-negative; checking the maximum before the loop keeps the
        per-element body unguarded (and un-mutated on failure)."""
        what = "ALU" if is_alu else "GEMM"
        if t.uop_end > self.uop_buf.shape[0]:
            raise VTABoundsError(
                f"{what} uop range [{t.uop_bgn}, {t.uop_end}) exceeds UOP "
                f"buffer capacity {self.uop_buf.shape[0]}")
        n_uop = max(0, t.uop_end - t.uop_bgn)
        if n_uop == 0 or t.iter_out <= 0 or t.iter_in <= 0:
            return
        uops = self.uop_buf[t.uop_bgn:t.uop_end]
        acc_cap = self.acc_buf.shape[0]
        if is_alu:
            d_off = ((t.iter_out - 1) * t.dst_factor_out
                     + (t.iter_in - 1) * t.dst_factor_in)
            hi = d_off + int(uops[:, 0].max())
            if hi >= acc_cap:
                raise VTABoundsError(
                    f"ALU ACC dst index {hi} >= capacity {acc_cap} "
                    f"(uop range [{t.uop_bgn}, {t.uop_end}))")
            if not t.use_imm:
                s_off = ((t.iter_out - 1) * t.src_factor_out
                         + (t.iter_in - 1) * t.src_factor_in)
                hi = s_off + int(uops[:, 1].max())
                if hi >= acc_cap:
                    raise VTABoundsError(
                        f"ALU ACC src index {hi} >= capacity {acc_cap} "
                        f"(uop range [{t.uop_bgn}, {t.uop_end}))")
            return
        x_off = ((t.iter_out - 1) * t.acc_factor_out
                 + (t.iter_in - 1) * t.acc_factor_in)
        hi = x_off + int(uops[:, 0].max())
        if hi >= acc_cap:
            raise VTABoundsError(
                f"GEMM ACC index {hi} >= capacity {acc_cap} "
                f"(uop range [{t.uop_bgn}, {t.uop_end}))")
        if not t.reset:
            a_off = ((t.iter_out - 1) * t.inp_factor_out
                     + (t.iter_in - 1) * t.inp_factor_in)
            hi = a_off + int(uops[:, 1].max())
            if hi >= self.inp_buf.shape[0]:
                raise VTABoundsError(
                    f"GEMM INP index {hi} >= capacity "
                    f"{self.inp_buf.shape[0]} "
                    f"(uop range [{t.uop_bgn}, {t.uop_end}))")
            w_off = ((t.iter_out - 1) * t.wgt_factor_out
                     + (t.iter_in - 1) * t.wgt_factor_in)
            hi = w_off + int(uops[:, 2].max())
            if hi >= self.wgt_buf.shape[0]:
                raise VTABoundsError(
                    f"GEMM WGT index {hi} >= capacity "
                    f"{self.wgt_buf.shape[0]} "
                    f"(uop range [{t.uop_bgn}, {t.uop_end}))")

    def _exec_gemm(self, g: isa.GemInsn) -> None:
        self._check_tensor_bounds(g, is_alu=False)
        n_uop = max(0, g.uop_end - g.uop_bgn)
        if g.reset:
            for i_out in range(g.iter_out):
                for i_in in range(g.iter_in):
                    for u in range(g.uop_bgn, g.uop_end):
                        acc0, _, _ = self.uop_buf[u]
                        x = (i_out * g.acc_factor_out + i_in * g.acc_factor_in
                             + int(acc0))
                        self.acc_buf[x] = 0
            self.report.gemm_reset_loops += g.iter_out * g.iter_in * n_uop
            return
        for i_out in range(g.iter_out):
            for i_in in range(g.iter_in):
                for u in range(g.uop_bgn, g.uop_end):
                    acc0, inp0, wgt0 = (int(v) for v in self.uop_buf[u])
                    x = i_out * g.acc_factor_out + i_in * g.acc_factor_in + acc0
                    a = i_out * g.inp_factor_out + i_in * g.inp_factor_in + inp0
                    w = i_out * g.wgt_factor_out + i_in * g.wgt_factor_in + wgt0
                    A = self.inp_buf[a].astype(np.int32)
                    W = self.wgt_buf[w].astype(np.int32)
                    # acc[x] += A · Wᵀ  (W stored transposed ⇒ A·B, §2.3)
                    prod = (A[None, :] * W).sum(axis=1, dtype=np.int64)
                    wide = self.acc_buf[x].astype(np.int64) + prod
                    wrapped = _wrap32(wide)
                    if self.count_overflows:
                        self.report.acc_overflow_lanes += int(
                            np.count_nonzero(wide != wrapped))
                    self.acc_buf[x] = wrapped
        self.report.gemm_loops += g.iter_out * g.iter_in * n_uop

    # ------------------------------------------------------------------
    def _exec_alu(self, a: isa.AluInsn) -> None:
        self._check_tensor_bounds(a, is_alu=True)
        n_uop = max(0, a.uop_end - a.uop_bgn)
        for i_out in range(a.iter_out):
            for i_in in range(a.iter_in):
                for u in range(a.uop_bgn, a.uop_end):
                    dst0, src0, _ = (int(v) for v in self.uop_buf[u])
                    d = i_out * a.dst_factor_out + i_in * a.dst_factor_in + dst0
                    s = i_out * a.src_factor_out + i_in * a.src_factor_in + src0
                    x = self.acc_buf[d].astype(np.int64)
                    y = (np.int64(a.imm) if a.use_imm
                         else self.acc_buf[s].astype(np.int64))
                    if a.alu_opcode == isa.AluOp.MIN:
                        r = np.minimum(x, y)
                    elif a.alu_opcode == isa.AluOp.MAX:
                        r = np.maximum(x, y)
                    elif a.alu_opcode == isa.AluOp.ADD:
                        r = x + y
                    elif a.alu_opcode == isa.AluOp.SHR:
                        # y is the immediate or the acc[s] vector; either
                        # way the shift amount is the low 5 bits.
                        r = x >> (y & 31)
                    else:
                        raise ValueError(a.alu_opcode)
                    wrapped = _wrap32(r)
                    if self.count_overflows:
                        self.report.acc_overflow_lanes += int(
                            np.count_nonzero(r != wrapped))
                    self.acc_buf[d] = wrapped
        self.report.alu_loops += a.iter_out * a.iter_in * n_uop

    # ------------------------------------------------------------------
    def _commit_out(self) -> None:
        """ACC → OUT truncation (§2.1: OUT vectors are truncated ACC)."""
        if self.count_overflows:
            self.report.acc_saturation_lanes += int(np.count_nonzero(
                (self.acc_buf < -128) | (self.acc_buf > 127)))
        self.out_buf[:] = truncate_int8(self.acc_buf)

    def run(self, instructions, *, fault_hook=None) -> SimReport:
        """Execute the stream.  ``fault_hook(sim, insn_idx)`` fires before
        each instruction (dependency pops included) — the injection point
        the harden subsystem uses for SRAM/transient faults and watchdog
        deadline checks (DESIGN.md §Hardening)."""
        for i, insn in enumerate(instructions):
            if fault_hook is not None:
                fault_hook(self, i)
            self.tokens.pre(insn)
            if isinstance(insn, isa.MemInsn):
                if insn.opcode == isa.Opcode.STORE:
                    self._commit_out()
                self._exec_mem(insn)
                tag = f"{insn.opcode.name} {insn.memory_type.name}"
            elif isinstance(insn, isa.GemInsn):
                self._exec_gemm(insn)
                tag = f"GEMM{' reset' if insn.reset else ''}"
            elif isinstance(insn, isa.AluInsn):
                self._exec_alu(insn)
                tag = f"ALU {insn.alu_opcode.name}"
            elif isinstance(insn, isa.FinishInsn):
                tag = "FINISH"
            else:
                raise TypeError(insn)
            self.report.insn_executed += 1
            if self.trace:
                self.report.insn_trace.append(tag)
            self.tokens.post(insn)
            if isinstance(insn, isa.FinishInsn):
                break
        self.tokens.account(self.report)
        return self.report


# ---------------------------------------------------------------------------
# Backend selection + program-level drivers
# ---------------------------------------------------------------------------

BACKENDS = ("oracle", "cuda")


def make_simulator(cfg: VTAConfig, dram, *, backend: str = "oracle",
                   trace: bool = False, count_overflows: bool = False,
                   device=None):
    """Instantiate a simulator backend over a DRAM image.

    ``"oracle"`` is the per-struct Python interpreter above — the
    correctness anchor.  ``"cuda"`` executes compiled programs as
    ``vta_gemm`` kernel launches on ``device`` (the card unless the caller
    names another; :mod:`repro_torch.core.cuda_backend`) — bit-identical
    to the oracle on its default truncation path; a ``(batch, nbytes)``
    DRAM stack selects its batch engine.
    """
    if backend == "oracle":
        return FunctionalSimulator(cfg, np.asarray(dram), trace=trace,
                                   count_overflows=count_overflows)
    if backend == "cuda":
        from .cuda_backend import BatchCudaSimulator, CudaSimulator
        cls = BatchCudaSimulator if dram.ndim == 2 else CudaSimulator
        return cls(cfg, dram, device=device, trace=trace,
                   count_overflows=count_overflows)
    raise ValueError(f"unknown simulator backend {backend!r}; "
                     f"expected one of {BACKENDS}")


def run_instructions(sim, instructions, *, program: Optional[VTAProgram] = None,
                     fault_hook=None) -> SimReport:
    """Run an instruction stream on either backend.

    The cuda backend executes compiled programs, so ``program`` is
    required there (raw instruction streams need the oracle).
    ``fault_hook(sim, insn_idx)`` is forwarded to the oracle's run loop;
    the cuda backend refuses it.
    """
    from .cuda_backend import CudaSimulator
    if isinstance(sim, CudaSimulator):
        if program is None:
            raise ValueError(
                "the cuda backend executes compiled programs; pass "
                "program= to run_instructions (raw instruction streams "
                "need the oracle)")
        return sim.run_program(program, fault_hook=fault_hook)
    return sim.run(instructions, fault_hook=fault_hook)


def _host_dram(sim) -> np.ndarray:
    """The simulator's DRAM on the host (the cuda backend keeps it as a
    torch tensor on its device)."""
    dram = sim.dram
    return dram if isinstance(dram, np.ndarray) else dram.cpu().numpy()


def run_program(prog: VTAProgram, *, trace: bool = False,
                backend: str = "oracle", fault_hook=None,
                count_overflows: bool = False, device=None
                ) -> Tuple[np.ndarray, SimReport]:
    """Execute a compiled program; return (decoded result matrix, report).

    The decoded matrix is the *unpadded* (M, N) int8 result, reconstructed
    from the OUT region exactly as the §4.2 host-side reshaping does.
    ``backend="cuda"`` executes the program as a ``vta_gemm`` kernel
    launch on ``device`` (truncation path — bit-identical to the oracle;
    see :mod:`repro_torch.core.cuda_backend`).
    """
    sim = make_simulator(prog.config, prog.dram_image(),
                         backend=backend, trace=trace,
                         count_overflows=count_overflows, device=device)
    report = run_instructions(sim, prog.instructions, program=prog,
                              fault_hook=fault_hook)
    out = decode_out_region(prog, _host_dram(sim))
    return out, report


def run_program_batch(prog: VTAProgram, *, batch: Optional[int] = None,
                      dram_stack: Optional[np.ndarray] = None,
                      backend: str = "cuda",
                      trace: bool = False, fault_hook=None,
                      count_overflows: bool = False, device=None
                      ) -> Tuple[np.ndarray, SimReport]:
    """Execute one compiled program over a batch of DRAM images.

    Either pass ``dram_stack`` — a ``(batch, nbytes)`` uint8 stack whose
    rows are per-image DRAM images (typically the program's own image with
    per-request INP regions staged in) — or just ``batch`` to replicate
    ``prog.dram_image()``.  The stack executes on the cuda backend's batch
    engine on ``device`` (one stacked kernel launch when the batch shares
    weights).  Returns the stacked decoded ``(batch, M, N)`` results and
    the batch-total report.
    """
    if backend != "cuda":
        raise ValueError(
            f"run_program_batch supports backend='cuda' (the reference's "
            f"numpy batch engine is not ported), got {backend!r}")
    if dram_stack is None:
        if batch is None:
            raise ValueError("pass either dram_stack or batch")
        image = prog.dram_image()
        dram_stack = np.broadcast_to(image, (batch, image.size)).copy()
    elif batch is not None and batch != dram_stack.shape[0]:
        raise ValueError(
            f"batch={batch} does not match dram_stack rows "
            f"{dram_stack.shape[0]}")
    sim = make_simulator(prog.config, dram_stack, backend=backend,
                         trace=trace, count_overflows=count_overflows,
                         device=device)
    report = run_instructions(sim, prog.instructions, program=prog,
                              fault_hook=fault_hook)
    return decode_out_region_batch(prog, _host_dram(sim)), report


def decode_out_region(prog: VTAProgram, dram: np.ndarray) -> np.ndarray:
    """§4.2 stage (i): binary-decode OUT, unsplit blocks, remove padding."""
    cfg = prog.config
    meta = prog.output_meta
    if meta is None:
        raise ValueError("program has no output metadata")
    region = prog.regions["out"]
    start = region.phys_addr - prog.allocator.offset
    raw = dram[start:start + region.nbytes].view(np.int8)
    bs = cfg.block_size
    rh = meta.row_height
    vecs = raw.reshape(meta.block_rows * meta.block_cols * rh, bs)
    blocks = vecs.reshape(meta.block_rows, meta.block_cols, rh, bs)
    full = blocks.transpose(0, 2, 1, 3).reshape(meta.block_rows * rh,
                                                meta.block_cols * bs)
    m, n = meta.valid_shape
    return np.ascontiguousarray(full[:m, :n])


def decode_out_region_batch(prog: VTAProgram,
                            dram_stack: np.ndarray) -> np.ndarray:
    """§4.2 stage (i) over a ``(batch, nbytes)`` DRAM stack → (batch, M, N).

    The per-image decode is pure reshape/transpose, so the batch axis rides
    along for free — one call replaces ``batch`` :func:`decode_out_region`
    calls on the serve path."""
    cfg = prog.config
    meta = prog.output_meta
    if meta is None:
        raise ValueError("program has no output metadata")
    region = prog.regions["out"]
    start = region.phys_addr - prog.allocator.offset
    raw = dram_stack[:, start:start + region.nbytes].view(np.int8)
    bs = cfg.block_size
    rh = meta.row_height
    b = dram_stack.shape[0]
    blocks = raw.reshape(b, meta.block_rows, meta.block_cols, rh, bs)
    full = blocks.transpose(0, 1, 3, 2, 4).reshape(
        b, meta.block_rows * rh, meta.block_cols * bs)
    m, n = meta.valid_shape
    return np.ascontiguousarray(full[:, :m, :n])


def verify_program(prog: VTAProgram, *, trace: bool = False,
                   backend: str = "oracle") -> SimReport:
    """Run + assert the simulator output equals the compiler's oracle."""
    out, report = run_program(prog, trace=trace, backend=backend)
    m, n = prog.output_meta.valid_shape
    expected = prog.expected_out[:m, :n]
    np.testing.assert_array_equal(out, expected,
                                  err_msg=f"program {prog.name!r} mismatch")
    return report
