"""Analytical Compute-module cycle model (paper §5.2).

The paper's cycle-accurate CHISEL simulation of LeNet-5 reports:

* 2972 cycles for the TensorGemm operations — i.e. 2942 GeMM loops plus
  instruction decode / buffer-availability checking overhead ("the VTA is
  able to almost complete an entire GeMM loop in each cycle");
* 6358 total Compute-module cycles (GEMM + ALU, without Load/Store);
* 9.8 µs at 650 MHz.

We model the Compute module as: 1 cycle per GeMM/ALU loop iteration +
``DECODE_CYCLES`` fixed cycles per compute instruction (decode + dependency
check + buffer availability).  ``DECODE_CYCLES`` is the single calibration
constant; the paper's own numbers pin it:

    2972 = 2942 loops + overhead; our compiler emits exactly 5 non-reset
    GeMM instructions for LeNet-5 (one per layer — every layer fits the
    SRAM in a single chunk)  →  30 / 5  →  DECODE_CYCLES = 6.

The 6358-cycle total additionally depends on the TVM-generated ALU
instruction stream, which the paper does not publish.  Our ALU schedule is
*leaner* (pool ÷4 and requant fuse into a single SHR on the surviving rows
only), so our total comes out below 6358 — the delta is reported as a
beyond-paper instruction-schedule optimisation in EXPERIMENTS.md §Paper.

The SIMD-CPU comparison (§5.2) follows the paper's own arithmetic: one GeMM
loop is ``block_size² = 256`` MACs, a 16-MAC/cycle CPU therefore needs 16×
the cycles per loop — 2972 × 16 = 47552 ("at least 47552 total cycles"),
and matching the VTA wall-time needs a ≈ 16 × 650 MHz ≈ 10 GHz clock.

Beyond the single-module §5.2 counter, :func:`simulate_pipeline` runs the
*three-module concurrent timeline* of the VTA's task-level pipeline
(DESIGN.md §Pipeline): the Load / Compute / Store modules each advance
through their own instruction sub-stream at the per-instruction costs
above, synchronised only by the §2.3 dependency tokens.  The makespan of
that timeline — slowest module plus its token-wait stalls — is the
hardware-honest figure the pipeline scheduler optimises for; the
serialized token scheme reproduces the §5.2 numbers on the Compute
module by construction (same per-instruction costs, same stream).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

from . import isa
from .hwconfig import VTAConfig
from .program import VTAProgram

# Calibrated on the paper's published LeNet-5 measurement (see module doc).
DECODE_CYCLES = 6

# §5.2 hardware constants.
FPGA_CLOCK_HZ = 650e6
SIMD_MACS_PER_CYCLE = 16


@dataclasses.dataclass(frozen=True)
class CycleReport:
    gemm_loops: int
    gemm_insns: int
    alu_loops: int
    alu_insns: int
    reset_loops: int
    reset_insns: int
    # Compute-module LOADs (UOP waves + ACC preloads).  Multi-chunk and
    # uop-streaming programs (DESIGN.md §3) execute these on the Compute
    # module; they are reported separately so the paper-calibrated
    # ``total_compute_cycles`` stays comparable with §5.2.
    compute_load_insns: int = 0
    compute_load_structs: int = 0

    @property
    def tensor_gemm_cycles(self) -> int:
        """Cycles to execute the (non-reset) TensorGemm instructions,
        including decode + buffer checks (paper: 2972 for LeNet-5)."""
        return self.gemm_loops + DECODE_CYCLES * self.gemm_insns

    @property
    def tensor_alu_cycles(self) -> int:
        return self.alu_loops + DECODE_CYCLES * self.alu_insns

    @property
    def reset_cycles(self) -> int:
        return self.reset_loops + DECODE_CYCLES * self.reset_insns

    @property
    def compute_load_cycles(self) -> int:
        """Cycles the Compute module spends on LOAD UOP/ACC (1 cycle per
        structure + decode) — the §3.3 uop-wave / ACC-preload overhead of
        multi-chunk programs."""
        return (self.compute_load_structs
                + DECODE_CYCLES * self.compute_load_insns)

    @property
    def total_compute_cycles(self) -> int:
        """Total Compute-module cycles (paper: 6358 for LeNet-5; excludes
        Load/Store as in §5.2, and the compute-module LOADs which the
        paper's number does not break out — see
        ``total_compute_cycles_with_loads``)."""
        return (self.tensor_gemm_cycles + self.tensor_alu_cycles
                + self.reset_cycles)

    @property
    def total_compute_cycles_with_loads(self) -> int:
        """§5.2 total plus the compute-module LOAD UOP/ACC cycles — the
        honest multi-chunk figure (EXPERIMENTS.md §Paper)."""
        return self.total_compute_cycles + self.compute_load_cycles

    def execution_time_s(self, clock_hz: float = FPGA_CLOCK_HZ, *,
                         include_loads: bool = False) -> float:
        """Wall time at ``clock_hz``.  ``include_loads=True`` adds the
        compute-module LOAD UOP/ACC cycles — the honest figure for
        multi-chunk programs (EXPERIMENTS.md §Paper)."""
        cycles = (self.total_compute_cycles_with_loads if include_loads
                  else self.total_compute_cycles)
        return cycles / clock_hz

    def simd_cpu_cycles(self, block_size: int,
                        macs_per_cycle: int = SIMD_MACS_PER_CYCLE) -> int:
        """§5.2 comparison, the paper's arithmetic: a SIMD CPU needs
        ``block_size²/macs_per_cycle`` × the VTA's TensorGemm cycles
        (2972 × 16 = 47552 for LeNet-5)."""
        per_loop = block_size * block_size // macs_per_cycle
        return self.tensor_gemm_cycles * per_loop

    def equivalent_cpu_clock_hz(self, clock_hz: float = FPGA_CLOCK_HZ,
                                block_size: int = 16,
                                macs_per_cycle: int = SIMD_MACS_PER_CYCLE
                                ) -> float:
        """Clock a 16-MAC SIMD CPU would need to match the VTA wall-time
        (paper: ≈10 GHz — 16× the 650 MHz FPGA clock)."""
        per_loop = block_size * block_size // macs_per_cycle
        cpu_total = self.total_compute_cycles * per_loop
        return cpu_total / self.execution_time_s(clock_hz)


def analyze(instructions: Iterable[object]) -> CycleReport:
    gemm_loops = gemm_insns = alu_loops = alu_insns = 0
    reset_loops = reset_insns = 0
    compute_load_insns = compute_load_structs = 0
    for i in instructions:
        if isinstance(i, isa.GemInsn):
            if i.reset:
                reset_loops += i.loop_count
                reset_insns += 1
            else:
                gemm_loops += i.loop_count
                gemm_insns += 1
        elif isinstance(i, isa.AluInsn):
            alu_loops += i.loop_count
            alu_insns += 1
        elif (isinstance(i, isa.MemInsn) and i.opcode == isa.Opcode.LOAD
              and i.memory_type in (isa.MemId.UOP, isa.MemId.ACC)):
            compute_load_insns += 1
            compute_load_structs += i.y_size * i.x_size
    return CycleReport(gemm_loops=gemm_loops, gemm_insns=gemm_insns,
                       alu_loops=alu_loops, alu_insns=alu_insns,
                       reset_loops=reset_loops, reset_insns=reset_insns,
                       compute_load_insns=compute_load_insns,
                       compute_load_structs=compute_load_structs)


def analyze_program(prog: VTAProgram) -> CycleReport:
    return analyze(prog.instructions)


def analyze_programs(progs: List[VTAProgram]) -> CycleReport:
    insns: List[object] = []
    for p in progs:
        insns.extend(p.instructions)
    return analyze(insns)


# ---------------------------------------------------------------------------
# Three-module concurrent timeline (DESIGN.md §Pipeline)
# ---------------------------------------------------------------------------

MODULES = ("load", "compute", "store")


def insn_cycles(insn) -> int:
    """Modeled cycles one instruction occupies its module: 1 per GEMM/ALU
    loop iteration or per DMA'd structure, plus ``DECODE_CYCLES`` decode —
    the same costs that calibrate :class:`CycleReport` to §5.2, now
    applied uniformly to the Load and Store modules too."""
    if isinstance(insn, (isa.GemInsn, isa.AluInsn)):
        return insn.loop_count + DECODE_CYCLES
    if isinstance(insn, isa.MemInsn):
        return insn.y_size * insn.x_size + DECODE_CYCLES
    return DECODE_CYCLES            # FINISH: decode + final token pop


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    """Result of the three-module concurrent timeline simulation.

    ``busy_cycles[m]``  — cycles module *m* spends executing instructions;
    ``wait_cycles[m]``  — cycles *m* sits blocked on a dependency-token
    pop (§2.3) before an instruction may start;
    ``finish_cycles[m]`` — the timeline instant *m* retires its last
    instruction;
    ``makespan_cycles`` — max over modules, i.e. slowest module + its
    stalls — the wall-clock figure of the whole program.
    """

    busy_cycles: Dict[str, int]
    wait_cycles: Dict[str, int]
    finish_cycles: Dict[str, int]
    insns: Dict[str, int]
    makespan_cycles: int

    @property
    def total_busy_cycles(self) -> int:
        """Sum of per-module busy cycles — the fully-serial floor a
        token-serialized schedule degenerates to."""
        return sum(self.busy_cycles.values())

    def idle_cycles(self, module: str) -> int:
        """Cycles ``module`` is not executing over the whole makespan
        (token waits + tail idle after its last instruction)."""
        return self.makespan_cycles - self.busy_cycles[module]

    def execution_time_s(self, clock_hz: float = FPGA_CLOCK_HZ) -> float:
        return self.makespan_cycles / clock_hz

    def merged(self, other: "PipelineReport") -> "PipelineReport":
        """Sequential composition: program boundaries are full barriers
        (FINISH drains the pipeline), so busy/wait/makespan all add."""
        add = lambda a, b: {m: a[m] + b[m] for m in MODULES}
        return PipelineReport(
            busy_cycles=add(self.busy_cycles, other.busy_cycles),
            wait_cycles=add(self.wait_cycles, other.wait_cycles),
            finish_cycles=add(self.finish_cycles, other.finish_cycles),
            insns=add(self.insns, other.insns),
            makespan_cycles=self.makespan_cycles + other.makespan_cycles)


def simulate_pipeline(instructions: Iterable[object]) -> PipelineReport:
    """Simulate the Load/Compute/Store modules running concurrently.

    Each module consumes its sub-stream in order; an instruction starts at
    ``max(module clock, arrival of every token it pops)``.  Token *k*
    popped from a queue becomes available when the *k*-th push to that
    queue retires (the §2.3 counters admit exactly that matching: a pop
    can only proceed once the count has been raised *k* times).  Program
    order is a topological order of the resulting dependency DAG, so a
    single in-order sweep yields the exact concurrent schedule.

    Raises :class:`~repro_torch.core.simulator.VTAHazardError` when a pop has no
    matching push anywhere earlier in the stream — the token stream would
    deadlock real hardware.
    """
    from .simulator import TokenQueues, VTAHazardError, module_of

    clock = {m: 0 for m in MODULES}
    busy = {m: 0 for m in MODULES}
    wait = {m: 0 for m in MODULES}
    ninsn = {m: 0 for m in MODULES}
    push_times: Dict[tuple, List[int]] = {}
    pops_taken: Dict[tuple, int] = {}

    for insn in instructions:
        mod = module_of(insn)
        ready = clock[mod]
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
            times = push_times.get(q, ())
            if k >= len(times):
                raise VTAHazardError(
                    f"dependency deadlock: {dst} pop #{k + 1} from {src} "
                    f"has no matching push in the stream")
            ready = max(ready, times[k])
            pops_taken[q] = k + 1
        wait[mod] += ready - clock[mod]
        cycles = insn_cycles(insn)
        finish = ready + cycles
        clock[mod] = finish
        busy[mod] += cycles
        ninsn[mod] += 1
        if insn.dep.push_prev:
            push_times.setdefault((mod, TokenQueues._PREV[mod]), []).append(
                finish)
        if insn.dep.push_next:
            push_times.setdefault((mod, TokenQueues._NEXT[mod]), []).append(
                finish)

    return PipelineReport(busy_cycles=busy, wait_cycles=wait,
                          finish_cycles=dict(clock), insns=ninsn,
                          makespan_cycles=max(clock.values()))


def simulate_program(prog: VTAProgram) -> PipelineReport:
    return simulate_pipeline(prog.instructions)


def simulate_programs(progs: List[VTAProgram]) -> PipelineReport:
    """Network timeline: layer programs execute back-to-back, each ending
    in a FINISH barrier, so the per-layer timelines compose by addition."""
    reports = [simulate_program(p) for p in progs]
    merged = reports[0]
    for r in reports[1:]:
        merged = merged.merged(r)
    return merged
