"""The simulator's shared vocabulary, trimmed to what the compiler needs.

The numpy reference package's ``core/simulator.py`` holds the bit-accurate
instruction interpreter (the oracle).  The port executes compiled programs
on its CUDA backend (:mod:`repro_torch.core.cuda_backend`) and keeps here
only what the compiler copies import: the hazard/bounds error types, the
module classifier and the dependency-token queues the scheduler checks
streams with, the :class:`SimReport` counters, and the §4.2 OUT-region
decoders.  The interpreter itself, ``make_simulator`` and ``run_program``
are not part of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import isa
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

