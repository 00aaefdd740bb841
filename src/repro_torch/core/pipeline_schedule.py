"""Task-level pipeline scheduler (DESIGN.md §Pipeline).

The VTA's throughput comes from its decoupled access-execute pipeline:
the Load, Compute and Store modules run concurrently, synchronised only
by the four §2.3 dependency-token queues.  The compiler's *serialized*
schedule is conservative — every load group waits for the GEMM that
consumed the previous one, and every chunk waits for the previous
chunk's store — so the three modules effectively take turns.

This module implements the opt-in ``schedule="pipelined"`` emission
policy (threaded through ``compile_matmul`` / ``compile_layer`` /
``compile_network``):

* **Double-buffered loads** — the INP and WGT SRAMs are split into two
  halves and load groups alternate between them (phase ``g % 2``), so
  the Load module may run up to *two* groups ahead of the GEMM stream:
  load group *g* pops the buffer-release token of GEMM *g−2* instead of
  *g−1*, and the GEMM for group *g* reads UOPs whose INP/WGT indices are
  offset into the group's half.
* **Overlapped stores** — the ACC (and OUT) windows likewise alternate
  between two halves per *chunk* (phase ``ci % 2``), so the Store module
  can drain chunk *c* while Compute already accumulates chunk *c+1*:
  the chunk's first Compute-module instruction pops the store-release
  token of chunk *c−2* instead of *c−1*.
* **Makespan-driven chunk planning** — candidate :class:`ChunkPlan`
  tilings (maximal, λ split, α split) are each emitted and timed on the
  three-module concurrent timeline (``cycle_model.simulate_pipeline``);
  the plan with the smallest modeled makespan wins, instead of the
  SRAM-fit-only greedy choice.

Safety is not asserted, it is *checked*: :func:`check_program_hazards`
builds the happens-before relation implied by module program order plus
token matching (pop *k* of a queue happens-after push *k*) and verifies
that every pair of concurrent SRAM accesses that conflict (same buffer,
overlapping ranges, at least one write) is ordered.  ``validate_program``
(DESIGN.md §Hardening) runs this check after its dep-token dry run and
rejects races under the stable ``dep-token-hazard`` constraint id —
a token-relaxation bug is a silent-corruption bug and must never reach
the simulators.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import isa
from .hwconfig import VTAConfig
from .simulator import TokenQueues, VTAHazardError, module_of

SERIALIZED = "serialized"
PIPELINED = "pipelined"
SCHEDULES = (SERIALIZED, PIPELINED)


# ---------------------------------------------------------------------------
# Schedule policy queried by the emitter (gemm_compiler)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Emission policy for one program: buffer phase bases + token rules.

    ``depth`` is the pipelining degree: 1 keeps the serialized scheme
    (every phase base is 0, consumers wait for the immediately preceding
    producer), 2 is the double-buffered scheme (producers run one phase
    ahead).  ``*_half`` are the phase-1 SRAM bases."""

    name: str
    depth: int
    inp_half: int = 0
    wgt_half: int = 0
    acc_half: int = 0

    # -- buffer phases --
    def load_phase(self, group: int) -> int:
        return group % self.depth

    def chunk_phase(self, chunk: int) -> int:
        return chunk % self.depth

    def inp_base(self, group: int) -> int:
        return self.load_phase(group) * self.inp_half

    def wgt_base(self, group: int) -> int:
        return self.load_phase(group) * self.wgt_half

    def acc_base(self, chunk: int) -> int:
        return self.chunk_phase(chunk) * self.acc_half

    def base_uop_slot(self, chunk: int) -> int:
        """UOP slot driving reset / whole-window immediate-ALU lattices:
        slot 0 holds (0, 0, 0), slot 1 (pipelined only) holds
        (acc_half, acc_half, 0) for odd chunks."""
        return self.chunk_phase(chunk)

    def pinned_uops(self) -> List[isa.Uop]:
        pinned = [isa.Uop(0, 0, 0)]
        if self.depth > 1:
            pinned.append(isa.Uop(self.acc_half, self.acc_half, 0))
        return pinned

    # -- token rules --
    def load_pops_release(self, group: int) -> bool:
        """LOAD INP of ``group`` waits for the GEMM that last read this
        phase's buffer half (group − depth) to release it."""
        return group >= self.depth

    def chunk_pops_store(self, chunk: int) -> bool:
        """The chunk's first Compute-module instruction waits for the
        store that last read this phase's ACC/OUT half (chunk − depth)."""
        return chunk >= self.depth


def make_schedule(cfg: VTAConfig, schedule: str) -> ScheduleSpec:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"expected one of {SCHEDULES}")
    if schedule == SERIALIZED:
        return ScheduleSpec(name=SERIALIZED, depth=1)
    return ScheduleSpec(name=PIPELINED, depth=2,
                        inp_half=cfg.inp_buff_vectors // 2,
                        wgt_half=cfg.wgt_buff_matrices // 2,
                        acc_half=cfg.acc_buff_vectors // 2)


def pipelinable(cfg: VTAConfig, row_height: int, acc_copies: int) -> bool:
    """Can this config double-buffer at all?  Each half must hold at
    least one row-height of INP, one WGT matrix, one ACC result window
    (× ``acc_copies``), and the odd-phase OUT window must stay inside the
    OUT buffer (the store reads OUT at the chunk's ACC base).  Phase-1
    UOP indices reach into the upper buffer halves, so the whole buffer
    must stay addressable by the §2.3 UOP fields (acc/inp 11 bits, wgt
    10 bits) — configs beyond that fall back to serialized."""
    return (cfg.inp_buff_vectors // 2 >= row_height
            and cfg.wgt_buff_matrices // 2 >= 1
            and cfg.acc_buff_vectors // 2 >= row_height * acc_copies
            and cfg.out_buff_vectors >= cfg.acc_buff_vectors // 2
            + row_height
            and cfg.uop_buff_entries >= 3
            and cfg.acc_buff_vectors <= 1 << 11
            and cfg.inp_buff_vectors <= 1 << 11
            and cfg.wgt_buff_matrices <= 1 << 10)


# ---------------------------------------------------------------------------
# Makespan-driven chunk-plan selection
# ---------------------------------------------------------------------------

def choose_plan(candidates, emit, simulate) -> Tuple[object, object]:
    """Pick the candidate plan with the smallest modeled makespan.

    ``emit(plan)`` builds the candidate's instruction stream (DRAM
    addresses irrelevant to timing may be stubbed); ``simulate(insns)``
    returns an object with ``makespan_cycles``.  Deterministic: ties keep
    the earliest candidate, so the maximal-tile plan wins when splitting
    buys nothing."""
    best = None
    for plan in candidates:
        report = simulate(emit(plan))
        if best is None or report.makespan_cycles < best[2].makespan_cycles:
            best = (plan, None, report)
    return best[0], best[2]


# ---------------------------------------------------------------------------
# Concurrent-hazard checker (the proof obligation of any token relaxation)
# ---------------------------------------------------------------------------

#: Access record: (buffer, lo, hi, is_write) with ``[lo, hi)`` in
#: structure units of that SRAM buffer.
_Access = Tuple[str, int, int, bool]


def _lattice_range(t, f_out: int, f_in: int, col: int,
                   uops: np.ndarray) -> Tuple[int, int]:
    lo = int(uops[:, col].min())
    hi = ((t.iter_out - 1) * f_out + (t.iter_in - 1) * f_in
          + int(uops[:, col].max()))
    return lo, hi + 1


def _insn_accesses(insn, cfg: VTAConfig,
                   uop_model: Optional[np.ndarray]) -> List[_Access]:
    """SRAM ranges ``insn`` touches.  ``uop_model`` is the symbolic UOP
    buffer at this point of the stream; ``None`` means unknown — GEMM/ALU
    then claim their whole operand buffers (conservative)."""
    if isinstance(insn, isa.MemInsn):
        kind = {isa.MemId.UOP: "uop", isa.MemId.INP: "inp",
                isa.MemId.WGT: "wgt", isa.MemId.ACC: "acc",
                isa.MemId.OUT: "out"}[insn.memory_type]
        if insn.opcode == isa.Opcode.LOAD:
            row_w = insn.x_pad_0 + insn.x_size + insn.x_pad_1
            span = (insn.y_pad_0 + insn.y_size + insn.y_pad_1) * row_w
            return [(kind, insn.sram_base, insn.sram_base + span, True)]
        # STORE OUT serializes the window to DRAM; the OUT bytes are the
        # truncation of the same ACC window (§2.1), so the store's result
        # depends on both ranges being quiescent.
        span = insn.y_size * insn.x_size
        return [("out", insn.sram_base, insn.sram_base + span, False),
                ("acc", insn.sram_base, insn.sram_base + span, False)]
    if isinstance(insn, isa.GemInsn):
        n_uop = max(0, insn.uop_end - insn.uop_bgn)
        if n_uop == 0 or insn.iter_out <= 0 or insn.iter_in <= 0:
            return []
        if uop_model is None:
            acc = [("acc", 0, cfg.acc_buff_vectors, True)]
            if insn.reset:
                return acc
            return acc + [("inp", 0, cfg.inp_buff_vectors, False),
                          ("wgt", 0, cfg.wgt_buff_matrices, False)]
        uops = uop_model[insn.uop_bgn:insn.uop_end]
        out: List[_Access] = []
        lo, hi = _lattice_range(insn, insn.acc_factor_out,
                                insn.acc_factor_in, 0, uops)
        out.append(("acc", lo, hi, True))
        if not insn.reset:
            lo, hi = _lattice_range(insn, insn.inp_factor_out,
                                    insn.inp_factor_in, 1, uops)
            out.append(("inp", lo, hi, False))
            lo, hi = _lattice_range(insn, insn.wgt_factor_out,
                                    insn.wgt_factor_in, 2, uops)
            out.append(("wgt", lo, hi, False))
        return out
    if isinstance(insn, isa.AluInsn):
        n_uop = max(0, insn.uop_end - insn.uop_bgn)
        if n_uop == 0 or insn.iter_out <= 0 or insn.iter_in <= 0:
            return []
        if uop_model is None:
            return [("acc", 0, cfg.acc_buff_vectors, True)]
        uops = uop_model[insn.uop_bgn:insn.uop_end]
        lo, hi = _lattice_range(insn, insn.dst_factor_out,
                                insn.dst_factor_in, 0, uops)
        out = [("acc", lo, hi, True)]
        if not insn.use_imm:
            lo, hi = _lattice_range(insn, insn.src_factor_out,
                                    insn.src_factor_in, 1, uops)
            out.append(("acc", lo, hi, False))
        return out
    return []                                   # FINISH


def _replay_uop_load(m: isa.MemInsn, uop_model: np.ndarray,
                     uop_raw: bytes, uop_base: int) -> None:
    """Advance the symbolic UOP model from the program's uop segment
    bytes, mirroring the LOAD UOP semantics (pads write zeros)."""
    nbytes = 4
    row_w = m.x_pad_0 + m.x_size + m.x_pad_1
    for y in range(m.y_size):
        lo = (m.dram_base + y * m.x_stride - uop_base) * nbytes
        raw = uop_raw[lo:lo + m.x_size * nbytes]
        words = np.frombuffer(raw, dtype="<u4").astype(np.int64)
        rows = np.stack([words & 0x7FF, (words >> 11) & 0x7FF,
                         (words >> 22) & 0x3FF], axis=1)
        dst = m.sram_base + (m.y_pad_0 + y) * row_w + m.x_pad_0
        uop_model[dst:dst + len(rows)] = rows


def check_concurrent_hazards(cfg: VTAConfig, instructions,
                             uop_raw: Optional[bytes] = None,
                             uop_base: int = 0) -> None:
    """Prove the token stream orders every conflicting SRAM access.

    Builds the happens-before DAG — module program order plus token edges
    (pop *k* of a queue happens-after push *k*, the ordering the §2.3
    counters guarantee) — then checks every pair of instructions on
    *different* modules whose SRAM ranges conflict (same buffer, overlap,
    at least one write) for an ordering path.  Raises
    :class:`VTAHazardError` naming the racing pair; also raises on a pop
    with no earlier matching push (the dry-run deadlock).

    ``uop_raw``/``uop_base`` give the program's uop segment bytes and its
    logical base address so GEMM/ALU ranges are exact; without them the
    lattices conservatively claim their whole operand buffers.
    """
    insns = list(instructions)
    uop_model = (np.zeros((cfg.uop_buff_entries, 3), dtype=np.int64)
                 if uop_raw is not None else None)

    accesses: List[List[_Access]] = []
    modules: List[str] = []
    reach: List[int] = []                # happens-before bitsets
    pushers: Dict[Tuple[str, str], List[int]] = {}
    pops_taken: Dict[Tuple[str, str], int] = {}
    last_of_module: Dict[str, int] = {}

    for i, insn in enumerate(insns):
        mod = module_of(insn)
        preds: List[int] = []
        if mod in last_of_module:
            preds.append(last_of_module[mod])
        pops = []
        if insn.dep.pop_prev:
            pops.append((TokenQueues._PREV[mod], mod))
        if insn.dep.pop_next:
            pops.append((TokenQueues._NEXT[mod], mod))
        for src, dst in pops:
            if src is None:
                raise VTAHazardError(f"{dst}: pop from nonexistent neighbour")
            q = (src, dst)
            k = pops_taken.get(q, 0)
            plist = pushers.get(q, ())
            if k >= len(plist):
                raise VTAHazardError(
                    f"dependency deadlock: insn {i} ({dst}) pop #{k + 1} "
                    f"from {src} has no matching push in the stream")
            preds.append(plist[k])
            pops_taken[q] = k + 1
        r = 0
        for p in preds:
            r |= reach[p] | (1 << p)
        reach.append(r)
        last_of_module[mod] = i
        if insn.dep.push_prev:
            pushers.setdefault((mod, TokenQueues._PREV[mod]), []).append(i)
        if insn.dep.push_next:
            pushers.setdefault((mod, TokenQueues._NEXT[mod]), []).append(i)

        accesses.append(_insn_accesses(insn, cfg, uop_model))
        modules.append(mod)
        if (uop_model is not None and isinstance(insn, isa.MemInsn)
                and insn.opcode == isa.Opcode.LOAD
                and insn.memory_type == isa.MemId.UOP):
            _replay_uop_load(insn, uop_model, uop_raw, uop_base)

    # conflict scan, grouped by buffer (program order is a topological
    # order, so i < j only ever needs "i happens-before j")
    by_buf: Dict[str, List[Tuple[int, int, int, bool]]] = {}
    for i, acc in enumerate(accesses):
        for buf, lo, hi, wr in acc:
            if hi > lo:
                by_buf.setdefault(buf, []).append((i, lo, hi, wr))
    for buf, lst in by_buf.items():
        for a in range(len(lst)):
            i, lo_i, hi_i, wr_i = lst[a]
            for b in range(a + 1, len(lst)):
                j, lo_j, hi_j, wr_j = lst[b]
                if i == j or modules[i] == modules[j]:
                    continue
                if not (wr_i or wr_j):
                    continue
                if lo_i >= hi_j or lo_j >= hi_i:
                    continue
                if not (reach[j] >> i) & 1:
                    raise VTAHazardError(
                        f"concurrent hazard: insn {i} ({modules[i]}, "
                        f"{'write' if wr_i else 'read'} {buf.upper()}"
                        f"[{lo_i}, {hi_i})) races insn {j} ({modules[j]}, "
                        f"{'write' if wr_j else 'read'} {buf.upper()}"
                        f"[{lo_j}, {hi_j})) — no dependency-token path "
                        f"orders them")


def check_program_hazards(prog) -> None:
    """:func:`check_concurrent_hazards` over a compiled
    :class:`~repro_torch.core.program.VTAProgram`, with exact GEMM/ALU ranges
    from its uop segment when available."""
    uop_raw = prog.segments.get("uop") if prog.segments else None
    uop_base = 0
    if uop_raw is not None and "uop" in prog.regions:
        region = prog.regions["uop"]
        uop_base = ((region.phys_addr - prog.allocator.offset)
                    // prog.config.uop_elem_bytes)
    check_concurrent_hazards(prog.config, prog.instructions,
                             uop_raw=uop_raw, uop_base=uop_base)
