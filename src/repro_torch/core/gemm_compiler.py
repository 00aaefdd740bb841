"""Operations definition: matrix op → VTA instructions + UOPs (paper §3.3).

``compile_matmul`` lowers ``C = A × B + X`` followed by element-wise ALU
post-ops down to a :class:`~repro_torch.core.program.VTAProgram`:

* data definition (pad → split → binarise) per §3.2;
* DRAM allocation in the TVM reference order (INP, WGT, [ACC], OUT, UOP,
  INSN), each region on a fresh 4 KiB page (§2.2);
* the blocked-GEMM schedule of Fig. 7/8: ``LP_OUT = λ``,
  ``LP_IN = row_height``, one UOP per output block
  ``(ACC_IDX, INP_IDX, WGT_IDX) = ((i·β+j)·rh, (i·λ)·rh, j)``;
* buffer-capacity chunking (§3.3: "If the data do not fit into the buffers,
  steps 2 to 5 must be repeated");
* multi-chunk ALU re-indexing (DESIGN.md §3): indexed-imm and vector-pair
  ALU programs carry *global* result-vector indices; for every SRAM chunk
  the compiler rewrites them against the chunk's local ACC window, and the
  chunk boundaries are aligned so that no (dst, src) pair ever straddles
  two chunks;
* on-VTA residual adds (DESIGN.md §Graph): an :class:`AluResidualOp` in the
  post-op list merges a second int32 operand — ACC-loaded per chunk beside
  the result window, its own ``res`` DRAM region — with one factor-form
  vector-vector ALU ADD (plus an optional scale-equalising SHR), the chunk
  planner halving the ACC budget so both windows fit;
* UOP wave streaming (DESIGN.md §3): when a program needs more micro-ops
  than the UOP buffer holds, the uop stream is split into *waves* — each
  wave is a contiguous DRAM run loaded with a compute-module LOAD_UOP right
  before the first instruction that consumes it (SRAM slot 0 permanently
  holds the reset uop, so resets and simple-immediate ALU ops survive every
  wave switch);
* dependency flags wiring the Load/Compute/Store queues (§2.3), validated by
  the simulator's token checker.

The §5.1 "GeMM loop" metric falls out of the generated ``iter_out × iter_in
× n_uop`` products — LeNet-5 totals 2942 by construction (see
``tests/test_lenet_e2e.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import cycle_model, isa, pipeline_schedule
from .dram import DramAllocator
from .errors import CompileError
from .hwconfig import VTAConfig, vta_default
from .layout import (matrix_padding, matrix_splitting, binarize_blocks,
                     exact_matmul, should_pad_height, pad_to_multiple)
from .program import OutputMeta, VTAProgram


# ---------------------------------------------------------------------------
# ALU post-op specification
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AluImmOp:
    """Element-wise op with an immediate, applied to every result vector.

    ``relu``  → MAX(x, 0); ``shr`` → arithmetic shift right (requant);
    ``add``/``min``/``max`` with an immediate.
    """

    op: isa.AluOp
    imm: int = 0

    @staticmethod
    def relu() -> "AluImmOp":
        return AluImmOp(isa.AluOp.MAX, 0)

    @staticmethod
    def shr(shift: int) -> "AluImmOp":
        return AluImmOp(isa.AluOp.SHR, shift)


@dataclasses.dataclass(frozen=True)
class AluPairOp:
    """Vector-pair op ``acc[dst] = op(acc[dst], acc[src])`` over an explicit
    (dst, src) list — used for region ops such as average pooling (ADD
    pairs followed by an ``AluIndexedImmOp`` SHR) or max pooling (MAX
    pairs).  Indices are global result-vector indices (block-major); on
    multi-chunk results each pair is re-indexed against the ACC window of
    the chunk that holds it, and the chunk plan keeps both ends of a pair
    inside the same chunk."""

    op: isa.AluOp
    pairs: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class AluIndexedImmOp:
    """Immediate op applied to an explicit list of result-vector indices.
    Indices are global (block-major) and are re-indexed per chunk."""

    op: isa.AluOp
    imm: int
    indices: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class AluResidualOp:
    """Vector-vector op against a *second ACC-resident operand* — the
    on-device residual add of DESIGN.md §Graph.

    The compiler loads the program's ``residual`` matrix (a second int32
    (M, N) operand, e.g. the skip activation of a ResNet block) into the
    ACC SRAM *beside* the chunk's result window (sram offset = chunk
    result size), then emits one factor-form ``AluInsn`` per chunk:
    ``acc[v] = op(acc[v], acc[res_base + v])`` for every result vector
    ``v`` — a true two-operand TensorAlu instruction, not a host-side
    merge.  ``pre_shift > 0`` first applies an SHR immediate to the loaded
    residual window (scale equalisation across a branch join, planned by
    the graph requant pass).  Chunk planning halves the ACC budget when a
    residual operand is present so both windows always fit.
    """

    op: isa.AluOp = isa.AluOp.ADD
    pre_shift: int = 0


AluSpec = (AluImmOp, AluPairOp, AluIndexedImmOp, AluResidualOp)


# ---------------------------------------------------------------------------
# Chunk geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """How the α×λ×β block grid is tiled to fit the SRAM buffers.

    ``alpha_segs``/``beta_segs`` are the actual ``(start, size)`` tilings
    of the α/β axes.  Segments are at most ``alpha_c``/``beta_c`` wide but
    may be smaller: when pair ALU programs are present the boundaries are
    aligned so that no (dst, src) pair straddles two chunks (the
    pool-window alignment of DESIGN.md §3)."""

    alpha: int
    lam: int
    beta: int
    alpha_c: int
    lam_c: int
    beta_c: int
    row_height: int
    alpha_segs: Tuple[Tuple[int, int], ...] = ()
    beta_segs: Tuple[Tuple[int, int], ...] = ()
    # ACC windows resident per chunk: 1 normally, 2 when the program holds
    # a residual operand beside the result (AluResidualOp).
    acc_copies: int = 1
    # Planned against halved buffer budgets so loads/stores can ping-pong
    # between buffer halves (schedule="pipelined", DESIGN.md §Pipeline).
    double_buffer: bool = False

    @property
    def n_chunks(self) -> int:
        if self.alpha_segs and self.beta_segs:
            return len(self.alpha_segs) * len(self.beta_segs)
        ceil = lambda a, b: -(-a // b)
        return ceil(self.alpha, self.alpha_c) * ceil(self.beta, self.beta_c)

    @property
    def single_chunk(self) -> bool:
        return (self.alpha_c, self.lam_c, self.beta_c) == (
            self.alpha, self.lam, self.beta)


def _segment(total: int, chunk: int, groups: Sequence[Tuple[int, int]] = ()
             ) -> Tuple[Tuple[int, int], ...]:
    """Tile ``[0, total)`` into ``(start, size)`` runs of at most ``chunk``.

    ``groups`` are inclusive ``(lo, hi)`` index intervals that must stay
    within one run (pair ALU programs read both ends of a pair from the
    same ACC window).  Boundaries are chosen greedily at the largest
    admissible cut; a group wider than ``chunk`` is a hard error.
    """
    if not groups:
        return tuple((s, min(chunk, total - s))
                     for s in range(0, total, chunk))
    ok = np.ones(total + 1, dtype=bool)
    for lo, hi in groups:
        ok[lo + 1:hi + 1] = False     # a cut at b splits (lo,hi) iff lo<b<=hi
    segs: List[Tuple[int, int]] = []
    cur = 0
    while cur < total:
        nxt = -1
        for b in range(min(total, cur + chunk), cur, -1):
            if ok[b]:
                nxt = b
                break
        if nxt <= cur:
            raise CompileError(
                f"ALU pair group spans more than one SRAM chunk (chunk "
                f"capacity {chunk} at offset {cur} of {total}); shrink the "
                f"pair groups or use a larger accumulator buffer",
                constraint="alu-pair-group-chunk")
        segs.append((cur, nxt - cur))
        cur = nxt
    return tuple(segs)


def plan_chunks(cfg: VTAConfig, alpha: int, lam: int, beta: int,
                row_height: int, *,
                row_groups: Sequence[Tuple[int, int]] = (),
                col_groups: Sequence[Tuple[int, int]] = (),
                acc_copies: int = 1,
                double_buffer: bool = False,
                max_lam_c: Optional[int] = None,
                max_alpha_c: Optional[int] = None) -> ChunkPlan:
    """Greedy deterministic tiling honouring every buffer capacity.

    ``row_groups``/``col_groups`` are inclusive block-row/block-col
    intervals that must not straddle a chunk boundary — derived from pair
    ALU programs (both ends of a pair must share one ACC window).
    ``acc_copies=2`` halves the per-chunk ACC budget so a residual operand
    window (:class:`AluResidualOp`) fits beside the result window.

    ``double_buffer`` halves every buffer budget again (INP/WGT per load
    group, ACC per chunk) and reserves a second pinned UOP slot so the
    pipelined schedule can ping-pong producers and consumers between
    buffer halves (DESIGN.md §Pipeline); the odd-phase store window sits
    at ``acc_buff/2``, shrinking the OUT budget accordingly.
    ``max_lam_c``/``max_alpha_c`` cap the tile sizes below the buffer
    limits — the makespan-driven planner uses them to generate split
    candidates (more load groups / more chunks = more overlap)."""
    # a row group must fit one chunk: where the widest would not, the
    # chunks take fewer block columns so that they take more block rows
    span = _widest_run(row_groups)
    lam_c, beta_c, alpha_c = chunk_dims(
        cfg, alpha, lam, beta, row_height, acc_copies=acc_copies,
        double_buffer=double_buffer, max_lam_c=max_lam_c,
        max_alpha_c=max_alpha_c, min_alpha_c=min(span, alpha))
    plan = ChunkPlan(alpha, lam, beta, alpha_c, lam_c, beta_c, row_height,
                     alpha_segs=_segment(alpha, alpha_c, row_groups),
                     beta_segs=_segment(beta, beta_c, col_groups),
                     acc_copies=acc_copies, double_buffer=double_buffer)
    _validate_plan(cfg, plan)
    return plan


def _widest_run(groups: Sequence[Tuple[int, int]]) -> int:
    """The most blocks one run of :func:`_segment` must hold: groups that
    share a block must share a run, so they chain."""
    widest, run = 1, None
    for lo, hi in sorted(groups):
        if run is not None and lo <= run[1]:
            run = (run[0], max(run[1], hi))
        else:
            run = (lo, hi)
        widest = max(widest, run[1] - run[0] + 1)
    return widest


def chunk_dims(cfg: VTAConfig, alpha: int, lam: int, beta: int,
               row_height: int, *, acc_copies: int = 1,
               double_buffer: bool = False,
               max_lam_c: Optional[int] = None,
               max_alpha_c: Optional[int] = None,
               min_alpha_c: int = 1) -> Tuple[int, int, int]:
    """The largest chunk ``(lam_c, beta_c, alpha_c)`` every buffer holds
    (see :func:`plan_chunks`): λ first, then β, then α.  Where that leaves
    ``alpha_c`` under ``min_alpha_c`` (a row group's span), ``beta_c`` is
    cut until ``min_alpha_c`` block rows fit, if any ``beta_c`` lets them."""
    div = 2 if double_buffer else 1
    uop_reserve = div
    inp_budget = cfg.inp_buff_vectors // div
    wgt_budget = cfg.wgt_buff_matrices // div
    acc_budget = (cfg.acc_buff_vectors // div) // acc_copies
    out_budget = cfg.out_buff_vectors - (
        cfg.acc_buff_vectors // 2 if double_buffer else 0)
    lam_c = max(1, min(lam, wgt_budget, inp_budget // row_height))
    if max_lam_c is not None:
        lam_c = max(1, min(lam_c, max_lam_c))
    beta_c = max(1, min(beta, wgt_budget // lam_c,
                        acc_budget // row_height,
                        out_budget // row_height,
                        cfg.uop_buff_entries - uop_reserve))

    def alpha_for(b_c: int) -> int:
        return max(1, min(alpha,
                          inp_budget // (row_height * lam_c),
                          acc_budget // (row_height * b_c),
                          out_budget // (row_height * b_c),
                          (cfg.uop_buff_entries - uop_reserve) // b_c))

    alpha_c = alpha_for(beta_c)
    if alpha_c < min_alpha_c:
        fit = max(1, min(acc_budget, out_budget) // (row_height * min_alpha_c))
        if fit < beta_c:
            beta_c = fit
            alpha_c = alpha_for(beta_c)
    if max_alpha_c is not None:
        alpha_c = max(1, min(alpha_c, max_alpha_c))
    return lam_c, beta_c, alpha_c


def _validate_plan(cfg: VTAConfig, p: ChunkPlan) -> None:
    div = 2 if p.double_buffer else 1
    odd_out_base = cfg.acc_buff_vectors // 2 if p.double_buffer else 0
    assert p.alpha_c * p.row_height * p.lam_c <= cfg.inp_buff_vectors // div
    assert p.lam_c * p.beta_c <= cfg.wgt_buff_matrices // div
    assert (p.alpha_c * p.row_height * p.beta_c * p.acc_copies
            <= cfg.acc_buff_vectors // div)
    assert (odd_out_base + p.alpha_c * p.row_height * p.beta_c
            <= cfg.out_buff_vectors)
    assert p.alpha_c * p.beta_c + div <= cfg.uop_buff_entries
    assert all(a <= p.alpha_c for _, a in p.alpha_segs)
    assert all(b <= p.beta_c for _, b in p.beta_segs)


def _ranges(total: int, chunk: int):
    for start in range(0, total, chunk):
        yield start, min(chunk, total - start)


def _chunk_local_indices(v: np.ndarray, i0: int, a_c: int, j0: int,
                         b_c: int, beta: int, row_height: int) -> np.ndarray:
    """Global result-vector indices → indices into this chunk's ACC window,
    -1 where a vector lives in another chunk (block-major, §3.2)."""
    br, rem = np.divmod(v, beta * row_height)
    bc, within = np.divmod(rem, row_height)
    inside = (br >= i0) & (br < i0 + a_c) & (bc >= j0) & (bc < j0 + b_c)
    local = ((br - i0) * b_c + (bc - j0)) * row_height + within
    return np.where(inside, local, -1)


def _spec_arrays(spec) -> Tuple[np.ndarray, ...]:
    """An indexed op's indices, or a pair op's dsts and srcs, as int64
    arrays."""
    if isinstance(spec, AluIndexedImmOp):
        return (np.asarray(spec.indices, dtype=np.int64),)
    pairs = np.asarray(spec.pairs, dtype=np.int64).reshape(-1, 2)
    return pairs[:, 0], pairs[:, 1]


def _alu_chunk_groups(alu_ops: Sequence, beta: int, row_height: int
                      ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """Block-row / block-col intervals each pair op must keep in one chunk."""
    row_groups: List[Tuple[int, int]] = []
    col_groups: List[Tuple[int, int]] = []
    stride = beta * row_height
    for spec in alu_ops:
        if isinstance(spec, AluPairOp):
            dst, src = _spec_arrays(spec)
            br_d, br_s = dst // stride, src // stride
            bc_d = (dst // row_height) % beta
            bc_s = (src // row_height) % beta
            for groups, a, b in ((row_groups, br_d, br_s),
                                 (col_groups, bc_d, bc_s)):
                apart = a != b
                groups.extend(zip(np.minimum(a, b)[apart].tolist(),
                                  np.maximum(a, b)[apart].tolist()))
    return row_groups, col_groups


# ---------------------------------------------------------------------------
# Reference semantics (the pure-numpy oracle for expected_out.bin)
# ---------------------------------------------------------------------------

def reference_result(A: np.ndarray, B: np.ndarray, X: Optional[np.ndarray],
                     alu_ops: Sequence, cfg: VTAConfig,
                     row_height: Optional[int] = None,
                     residual: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Bit-accurate reference: returns ``(acc_int32, out_int8)`` on the
    *padded* geometry (block-major semantics are layout-only)."""
    bs = cfg.block_size
    if row_height is None:
        row_height = bs if should_pad_height(A) else 1
    Ap = matrix_padding(A, bs, pad_height=row_height > 1)
    Bp = matrix_padding(B, bs, pad_height=True)
    # exact, then wrapped below: congruent modulo 2**32 to int32 arithmetic
    acc = exact_matmul(Ap, Bp)
    if X is not None:
        Xp = np.zeros(acc.shape, dtype=np.int64)
        Xp[:X.shape[0], :X.shape[1]] = X.astype(np.int64)
        acc = acc + Xp
    acc = _wrap_int32(acc)

    beta = Bp.shape[1] // bs
    vec = _matrix_to_vectors(acc, bs, row_height)   # (n_vec, bs) block-major
    res_vec = None
    if residual is not None:
        Rp = np.zeros(acc.shape, dtype=np.int32)
        Rp[:residual.shape[0], :residual.shape[1]] = \
            residual.astype(np.int32)
        res_vec = _matrix_to_vectors(Rp, bs, row_height)
    for spec in alu_ops:
        if isinstance(spec, AluImmOp):
            vec = _alu_apply(vec, spec.op, spec.imm, np.arange(len(vec)))
        elif isinstance(spec, AluIndexedImmOp):
            vec = _alu_apply(vec, spec.op, spec.imm, np.asarray(spec.indices))
        elif isinstance(spec, AluPairOp):
            vec = _alu_pairs(vec, spec)
        elif isinstance(spec, AluResidualOp):
            if res_vec is None:
                raise CompileError(
                    "AluResidualOp requires a residual operand",
                    constraint="residual-operand-missing")
            # Mirror the device: the residual window is ACC-loaded, an
            # optional SHR immediate equalises its scale, then the
            # vector-vector op merges it into every result vector.
            r = res_vec.astype(np.int64)
            if spec.pre_shift:
                r = _wrap_int32(r >> spec.pre_shift).astype(np.int64)
            vec = _alu_residual(vec, spec.op, r)
        else:
            raise TypeError(spec)
    acc = _vectors_to_matrix(vec, acc.shape, bs, row_height)
    out = (acc.astype(np.int64) & 0xFF).astype(np.uint8).view(np.int8) \
        .astype(np.int8)   # truncation (§2.1: OUT = truncated ACC)
    return acc.astype(np.int32), out


def _wrap_int32(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def _alu_apply(vec, op, imm, idx):
    vec = vec.copy()
    sel = vec[idx].astype(np.int64)
    if op == isa.AluOp.MIN:
        sel = np.minimum(sel, imm)
    elif op == isa.AluOp.MAX:
        sel = np.maximum(sel, imm)
    elif op == isa.AluOp.ADD:
        sel = sel + imm
    elif op == isa.AluOp.SHR:
        sel = sel >> imm
    vec[idx] = _wrap_int32(sel)
    return vec


def _alu_residual(vec, op, res64):
    """Whole-result vector-vector op against the residual window."""
    a = vec.astype(np.int64)
    if op == isa.AluOp.MIN:
        r = np.minimum(a, res64)
    elif op == isa.AluOp.MAX:
        r = np.maximum(a, res64)
    elif op == isa.AluOp.ADD:
        r = a + res64
    elif op == isa.AluOp.SHR:
        r = a >> (res64 & 31)
    else:
        raise ValueError(op)
    return _wrap_int32(r)


def _alu_pairs(vec, spec):
    """A pair op's pairs applied in order.  Where no src is a dst, every
    pair reads the state before the op, so the pairs merge at once: MIN
    and MAX are order-free, and ADD wrapped once at the end equals ADD
    wrapped at every step (both are exact modulo 2**32)."""
    dst, src = _spec_arrays(spec)
    ordered = (np.intersect1d(dst, src).size > 0
               or spec.op not in (isa.AluOp.MIN, isa.AluOp.MAX,
                                  isa.AluOp.ADD))
    if ordered:
        for d, s in spec.pairs:
            vec = _alu_pair(vec, spec.op, d, s)
        return vec
    acc = vec.astype(np.int64)
    merge = {isa.AluOp.MIN: np.minimum, isa.AluOp.MAX: np.maximum,
             isa.AluOp.ADD: np.add}[spec.op]
    merge.at(acc, dst, vec[src].astype(np.int64))
    out = vec.copy()
    touched = np.unique(dst)
    out[touched] = _wrap_int32(acc[touched])
    return out


def _alu_pair(vec, op, dst, src):
    vec = vec.copy()
    a = vec[dst].astype(np.int64)
    b = vec[src].astype(np.int64)
    if op == isa.AluOp.MIN:
        r = np.minimum(a, b)
    elif op == isa.AluOp.MAX:
        r = np.maximum(a, b)
    elif op == isa.AluOp.ADD:
        r = a + b
    elif op == isa.AluOp.SHR:
        r = a >> (b & 31)
    vec[dst] = _wrap_int32(r)
    return vec


def _matrix_to_vectors(mat: np.ndarray, bs: int, row_height: int) -> np.ndarray:
    """(H, W) → (n_vec, bs) in block-major vector order (DRAM/SRAM order)."""
    h, w = mat.shape
    br, bc = h // row_height, w // bs
    blocks = mat.reshape(br, row_height, bc, bs).transpose(0, 2, 1, 3)
    return blocks.reshape(br * bc * row_height, bs)


def _vectors_to_matrix(vec: np.ndarray, shape, bs: int, row_height: int) -> np.ndarray:
    h, w = shape
    br, bc = h // row_height, w // bs
    blocks = vec.reshape(br, bc, row_height, bs).transpose(0, 2, 1, 3)
    return blocks.reshape(h, w)


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------

def compile_matmul(A: np.ndarray, B: np.ndarray, *,
                   X: Optional[np.ndarray] = None,
                   bias: Optional[np.ndarray] = None,
                   alu_ops: Sequence = (),
                   residual: Optional[np.ndarray] = None,
                   cfg: Optional[VTAConfig] = None,
                   name: str = "matmul",
                   dram_offset: int = 0,
                   allocator: Optional[DramAllocator] = None,
                   schedule: str = pipeline_schedule.SERIALIZED
                   ) -> VTAProgram:
    """Compile ``C = A·B (+X|+bias)`` + element-wise post-ops to a VTA program.

    ``A`` int8 (M,K); ``B`` int8 (K,N); ``X`` int32 (M,N) accumulator preload
    or ``bias`` int32 (N,) broadcast over rows (the paper's C = A×B + X form,
    §2.3).  ``alu_ops`` is an ordered list of AluImmOp / AluPairOp /
    AluIndexedImmOp / AluResidualOp; indexed/pair programs work on
    multi-chunk results (the uops are rewritten against each chunk's local
    ACC window) and may exceed the UOP buffer (the compiler streams them in
    LOAD_UOP waves).

    ``residual`` — a second int32 (M, N) operand merged *on the VTA* by an
    :class:`AluResidualOp` in ``alu_ops`` (the residual-add lowering,
    DESIGN.md §Graph): it is placed in its own ``res`` DRAM region and
    ACC-loaded beside each chunk's result window.

    ``allocator`` — pass a shared :class:`DramAllocator` to place several
    programs (network layers, §4.2) in one DRAM region; region names are
    then prefixed with ``name``.

    ``schedule`` — ``"serialized"`` (default) emits the conservative
    token stream; ``"pipelined"`` double-buffers load groups against GEMM
    execution and overlaps each chunk's store with the next chunk's
    compute, picking among candidate chunk plans by modeled three-module
    makespan (DESIGN.md §Pipeline).  When the buffers are too small to
    double-buffer the compile falls back to the serialized scheme
    (``prog.schedule`` records what was actually emitted).
    """
    cfg = cfg or vta_default()
    bs = cfg.block_size
    if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[0]:
        raise CompileError(
            f"incompatible GEMM shapes {A.shape} @ {B.shape}",
            layer=name, constraint="gemm-shape")
    A = np.asarray(A, dtype=np.int8)
    B = np.asarray(B, dtype=np.int8)
    if bias is not None and X is not None:
        raise CompileError("pass either X or bias, not both", layer=name,
                           constraint="bias-xor-preload")
    M, K = A.shape
    N = B.shape[1]
    if bias is not None:
        X = np.broadcast_to(np.asarray(bias, dtype=np.int32), (M, N)).copy()

    n_residual_ops = sum(isinstance(s, AluResidualOp) for s in alu_ops)
    if n_residual_ops > 1:
        raise CompileError("at most one AluResidualOp per program",
                           layer=name, constraint="residual-single-op")
    if (residual is not None) != (n_residual_ops == 1):
        raise CompileError(
            "a residual operand and an AluResidualOp must come together",
            layer=name, constraint="residual-operand-op-pairing")
    if residual is not None:
        residual = np.asarray(residual, dtype=np.int32)
        if residual.shape != (M, N):
            raise CompileError(
                f"residual operand shape {residual.shape} != result "
                f"shape {(M, N)}", layer=name, constraint="residual-shape")

    # ---------------- data definition (§3.2) ----------------
    pad_h = should_pad_height(A)
    row_height = bs if pad_h else A.shape[0]
    Ap = matrix_padding(A, bs, pad_height=pad_h)
    Bp = matrix_padding(B, bs, pad_height=True)
    a_split = matrix_splitting(Ap, bs)
    b_split = matrix_splitting(Bp, bs)
    alpha, lam = a_split.block_rows, a_split.block_cols
    beta = b_split.block_cols
    assert b_split.block_rows == lam, "K-padding mismatch"

    inp_bin = binarize_blocks(a_split, cfg.inp_dtype)
    wgt_bin = binarize_blocks(b_split, cfg.wgt_dtype, transpose=True)

    has_x = X is not None
    if has_x:
        Xp = np.zeros((alpha * row_height, beta * bs), dtype=np.int32)
        Xp[:M, :N] = X.astype(np.int32)
        x_split = matrix_splitting(Xp, bs)
        acc_bin = binarize_blocks(x_split, cfg.acc_dtype)

    has_res = residual is not None
    if has_res:
        Rp = np.zeros((alpha * row_height, beta * bs), dtype=np.int32)
        Rp[:M, :N] = residual
        r_split = matrix_splitting(Rp, bs)
        res_bin = binarize_blocks(r_split, cfg.acc_dtype)

    # ---------------- chunk plan ----------------
    n_result_vec = alpha * beta * row_height
    for spec in alu_ops:
        if isinstance(spec, AluIndexedImmOp):
            idxs = spec.indices
        elif isinstance(spec, AluPairOp):
            idxs = tuple(i for p in spec.pairs for i in p)
        else:
            idxs = ()
        for v in idxs:
            if not 0 <= v < n_result_vec:
                raise CompileError(
                    f"ALU index {v} outside the {n_result_vec}-vector result",
                    layer=name, constraint="alu-index-range")

    row_groups, col_groups = _alu_chunk_groups(alu_ops, beta, row_height)
    acc_copies = 2 if residual is not None else 1

    # ---------------- schedule ----------------
    if schedule not in pipeline_schedule.SCHEDULES:
        raise CompileError(
            f"unknown schedule {schedule!r}; expected one of "
            f"{pipeline_schedule.SCHEDULES}", layer=name,
            constraint="schedule-unknown")
    if (schedule == pipeline_schedule.PIPELINED
            and not pipeline_schedule.pipelinable(cfg, row_height,
                                                  acc_copies)):
        # Buffers too small (or UOP fields too narrow) to ping-pong
        # halves: fall back to the conservative scheme rather than fail.
        schedule = pipeline_schedule.SERIALIZED
    sched = pipeline_schedule.make_schedule(cfg, schedule)

    def _plan(double_buffer: bool, **caps) -> ChunkPlan:
        return plan_chunks(cfg, alpha, lam, beta, row_height,
                           row_groups=row_groups, col_groups=col_groups,
                           acc_copies=acc_copies,
                           double_buffer=double_buffer, **caps)

    # ---------------- UOPs + emission (per candidate plan) ----------------
    capacity = cfg.uop_buff_entries
    spec_arrays = [_spec_arrays(spec)
                   if isinstance(spec, (AluIndexedImmOp, AluPairOp)) else ()
                   for spec in alu_ops]

    def _build(plan: ChunkPlan):
        """UOP DRAM layout + instruction emitter for ``plan`` under
        ``sched``.  Returns ``(uop_dram, emit)`` where ``emit(log)`` is
        re-callable — candidate plans are timed with stubbed DRAM bases
        (``log = lambda r: 0``) before any region exists."""
        lam_segs = list(_ranges(lam, plan.lam_c))
        chunk_list = [(i0, a_c, j0, b_c)
                      for i0, a_c in plan.alpha_segs
                      for j0, b_c in plan.beta_segs]
        gpc = len(lam_segs)                    # load groups per chunk

        def _gemm_uops(a_c: int, b_c: int, l_c: int, inp_off: int,
                       wgt_off: int, acc_off: int) -> List[isa.Uop]:
            return [isa.Uop(acc_idx=acc_off + (i * b_c + j) * row_height,
                            inp_idx=inp_off + i * l_c * row_height,
                            wgt_idx=wgt_off + j)
                    for i in range(a_c) for j in range(b_c)]

        def _alu_chunk_uops(spec, arrays, i0: int, a_c: int, j0: int,
                            b_c: int, acc_off: int) -> List[isa.Uop]:
            out: List[isa.Uop] = []
            if isinstance(spec, AluResidualOp):
                # The residual window sits right after the chunk's result
                # window in ACC SRAM.  One uop drives the whole factor-form
                # lattice: optionally a pre-shift SHR over the window
                # itself, then the vector-vector op (dst = result, src =
                # window).
                base = acc_off + a_c * b_c * row_height
                if spec.pre_shift:
                    out.append(isa.Uop(acc_idx=base, inp_idx=base,
                                       wgt_idx=0))
                out.append(isa.Uop(acc_idx=acc_off, inp_idx=base, wgt_idx=0))
                return out
            if isinstance(spec, AluIndexedImmOp):
                lv = _chunk_local_indices(arrays[0], i0, a_c, j0, b_c,
                                          beta, row_height)
                return [isa.Uop(acc_idx=acc_off + v, inp_idx=acc_off + v,
                                wgt_idx=0) for v in lv[lv >= 0].tolist()]
            dst, src = arrays
            ld = _chunk_local_indices(dst, i0, a_c, j0, b_c, beta,
                                      row_height)
            ls = _chunk_local_indices(src, i0, a_c, j0, b_c, beta,
                                      row_height)
            split = (ld < 0) != (ls < 0)
            if split.any():
                k = int(np.argmax(split))
                raise AssertionError(   # plan alignment guarantees
                    f"pair ({dst[k]}, {src[k]}) straddles a chunk "
                    f"boundary")
            here = ld >= 0
            return [isa.Uop(acc_idx=acc_off + d, inp_idx=acc_off + s_,
                            wgt_idx=0)
                    for d, s_ in zip(ld[here].tolist(), ls[here].tolist())]

        chunk_alu_uops = [
            [None if isinstance(spec, AluImmOp)
             else _alu_chunk_uops(spec, arrays, i0, a_c, j0, b_c,
                                  sched.acc_base(ci))
             for spec, arrays in zip(alu_ops, spec_arrays)]
            for ci, (i0, a_c, j0, b_c) in enumerate(chunk_list)]

        # GEMM uop sets are keyed by geometry *and* buffer phases: the
        # phase-p load half and phase-q ACC half shift every index.
        gemm_keys: List[Tuple[int, int, int, int, int]] = []
        for ci, (i0, a_c, j0, b_c) in enumerate(chunk_list):
            q = sched.chunk_phase(ci)
            for ki in range(gpc):
                key = (a_c, b_c, lam_segs[ki][1],
                       sched.load_phase(ci * gpc + ki), q)
                if key not in gemm_keys:
                    gemm_keys.append(key)

        def _uops_for(key) -> List[isa.Uop]:
            a_c, b_c, l_c, p, q = key
            return _gemm_uops(a_c, b_c, l_c, p * sched.inp_half,
                              p * sched.wgt_half, q * sched.acc_half)

        n_alu_uops = sum(len(lst) for lists in chunk_alu_uops
                         for lst in lists if lst is not None)
        pinned = sched.pinned_uops()
        n_pinned = len(pinned)
        resident_total = (n_pinned + sum(a * b for a, b, _, _, _ in gemm_keys)
                          + n_alu_uops)

        # Use-site records.  Each GEMM use is ``(wave, uop_bgn)``; each
        # indexed/pair ALU use is a list of ``(wave, uop_bgn, count)``
        # segments (one AluInsn per segment; chunks with no local entries
        # get none).  ``wave=None`` means "loaded by the preamble", i.e.
        # resident for the whole program.
        gemm_use: List[List[Tuple[Optional[int], int]]] = []
        alu_use: List[List[Optional[List[Tuple[Optional[int], int,
                                               int]]]]] = []
        waves: List[Tuple[int, int]] = []    # (dram_start, count) per wave
        uop_dram: List[isa.Uop] = list(pinned)

        if resident_total <= capacity:
            # Everything fits the buffer at once: one preamble LOAD_UOP,
            # SRAM slot = DRAM index (the original §3.3 layout).
            gemm_start: Dict[Tuple[int, int, int, int, int], int] = {}
            for key in gemm_keys:
                gemm_start[key] = len(uop_dram)
                uop_dram.extend(_uops_for(key))
            for ci, (i0, a_c, j0, b_c) in enumerate(chunk_list):
                q = sched.chunk_phase(ci)
                gemm_use.append([
                    (None, gemm_start[(a_c, b_c, lam_segs[ki][1],
                                       sched.load_phase(ci * gpc + ki), q)])
                    for ki in range(gpc)])
                uses: List[Optional[List[Tuple[Optional[int], int,
                                               int]]]] = []
                for lst in chunk_alu_uops[ci]:
                    if lst is None:
                        uses.append(None)
                    elif not lst:
                        uses.append([])  # no local entries in this chunk
                    else:
                        start = len(uop_dram)
                        uop_dram.extend(lst)
                        uses.append([(None, start, len(lst))])
                alu_use.append(uses)
            preamble_count = len(uop_dram)
        else:
            # Wave streaming: the pinned slots keep the reset/base uops;
            # slots n_pinned..capacity-1 are reloaded per wave.  Waves are
            # built in execution order, so a single monotone LOAD_UOP
            # sequence covers every use.
            preamble_count = n_pinned
            cap_w = capacity - n_pinned
            wave_maps: List[Dict[Tuple[int, int, int, int, int],
                                 Tuple[int, int]]] = []

            def _begin_wave() -> None:
                waves.append((len(uop_dram), 0))
                wave_maps.append({})

            def _place(key, lst: List[isa.Uop]) -> Tuple[int, int]:
                if key is not None and key in wave_maps[-1]:
                    return wave_maps[-1][key]
                start, count = waves[-1]
                if count + len(lst) > cap_w:
                    _begin_wave()
                    start, count = waves[-1]
                uop_dram.extend(lst)
                waves[-1] = (start, count + len(lst))
                entry = (len(waves) - 1, n_pinned + count)
                if key is not None:
                    wave_maps[-1][key] = entry
                return entry

            _begin_wave()
            for ci, (i0, a_c, j0, b_c) in enumerate(chunk_list):
                assert a_c * b_c <= cap_w, "planner exceeded the uop buffer"
                q = sched.chunk_phase(ci)
                row: List[Tuple[Optional[int], int]] = []
                for ki in range(gpc):
                    key = (a_c, b_c, lam_segs[ki][1],
                           sched.load_phase(ci * gpc + ki), q)
                    row.append(_place(key, _uops_for(key)))
                gemm_use.append(row)
                uses = []
                for lst in chunk_alu_uops[ci]:
                    if lst is None:
                        uses.append(None)
                        continue
                    segs: List[Tuple[Optional[int], int, int]] = []
                    off = 0
                    while off < len(lst):
                        avail = cap_w - waves[-1][1]
                        if avail <= 0:
                            _begin_wave()
                            avail = cap_w
                        n = min(avail, len(lst) - off)
                        w, bgn = _place(None, lst[off:off + n])
                        segs.append((w, bgn, n))
                        off += n
                    uses.append(segs)
                alu_use.append(uses)

        def emit(log) -> List[object]:
            insns: List[object] = []

            # -- program preamble: load UOPs, reset pair (§3.3 step 1) --
            insns.append(isa.MemInsn(
                isa.Opcode.LOAD, isa.MemId.UOP, sram_base=0,
                dram_base=log("uop"), y_size=1,
                x_size=preamble_count, x_stride=preamble_count))
            insns.append(isa.GemInsn(reset=1, uop_bgn=0, uop_end=1,
                                     iter_out=1, iter_in=1))

            loaded_wave: List[Optional[int]] = [None]

            def _ensure_wave(w: Optional[int]) -> None:
                if w is None or w == loaded_wave[0]:
                    return
                start, count = waves[w]
                insns.append(isa.MemInsn(
                    isa.Opcode.LOAD, isa.MemId.UOP, sram_base=n_pinned,
                    dram_base=log("uop") + start, y_size=1,
                    x_size=count, x_stride=count))
                loaded_wave[0] = w

            # -- chunk loop (§3.3 steps 2–5) --
            n_chunks = len(chunk_list)
            group = 0
            for ci, (i0, a_c, j0, b_c) in enumerate(chunk_list):
                acc_off = sched.acc_base(ci)
                slot = sched.base_uop_slot(ci)
                # The chunk's *first* Compute-module instruction waits for
                # the store that released this phase's ACC/OUT half — it
                # must be the first one (the ACC preload / reset also
                # writes the window; a later pop would leave a WAR race
                # with the draining store).
                store_wait = sched.chunk_pops_store(ci)
                if has_x:
                    # ACC preload (compute-module LOAD): chunk rows are
                    # strided runs of b_c·rh vectors out of the β·rh-wide
                    # block rows.
                    pre = isa.MemInsn(
                        isa.Opcode.LOAD, isa.MemId.ACC, sram_base=acc_off,
                        dram_base=log("acc") + (i0 * beta + j0) * row_height,
                        y_size=a_c, x_size=b_c * row_height,
                        x_stride=beta * row_height)
                    if store_wait:
                        pre.dep.pop_next = 1
                        store_wait = False
                    insns.append(pre)
                for ki, (k0, l_c) in enumerate(lam_segs):
                    li = isa.MemInsn(
                        isa.Opcode.LOAD, isa.MemId.INP,
                        sram_base=sched.inp_base(group),
                        dram_base=log("inp") + (i0 * lam + k0) * row_height,
                        y_size=a_c, x_size=l_c * row_height,
                        x_stride=lam * row_height)
                    if sched.load_pops_release(group):
                        li.dep.pop_next = 1  # wait for buffer-half release
                    lw = isa.MemInsn(
                        isa.Opcode.LOAD, isa.MemId.WGT,
                        sram_base=sched.wgt_base(group),
                        dram_base=log("wgt") + k0 * beta + j0,
                        y_size=l_c, x_size=b_c, x_stride=beta)
                    lw.dep.push_next = 1     # load group complete
                    insns.extend([li, lw])
                    group += 1

                    if not has_x and k0 == 0:
                        # no X preload: zero the chunk accumulator
                        rg = isa.GemInsn(
                            reset=1, uop_bgn=slot, uop_end=slot + 1,
                            iter_out=a_c * b_c, iter_in=row_height,
                            acc_factor_out=row_height, acc_factor_in=1)
                        if store_wait:
                            rg.dep.pop_next = 1
                            store_wait = False
                        insns.append(rg)
                    wave, start = gemm_use[ci][ki]
                    _ensure_wave(wave)
                    g = isa.GemInsn(
                        uop_bgn=start, uop_end=start + a_c * b_c,
                        iter_out=l_c, iter_in=row_height,
                        acc_factor_out=0, acc_factor_in=1,
                        inp_factor_out=row_height, inp_factor_in=1,
                        wgt_factor_out=b_c, wgt_factor_in=0)
                    g.dep.pop_prev = 1       # consume load group
                    g.dep.push_prev = 1      # release INP/WGT half
                    insns.append(g)

                for spec, use in zip(alu_ops, alu_use[ci]):
                    if isinstance(spec, AluImmOp):
                        insns.append(isa.AluInsn(
                            alu_opcode=spec.op, uop_bgn=slot,
                            uop_end=slot + 1,
                            iter_out=a_c * b_c, iter_in=row_height,
                            dst_factor_out=row_height, dst_factor_in=1,
                            src_factor_out=row_height, src_factor_in=1,
                            use_imm=1, imm=spec.imm))
                        continue
                    if isinstance(spec, AluResidualOp):
                        # Load the chunk's residual window (compute-module
                        # LOAD, same strided geometry as the chunk result)
                        # beside the result window, then run the
                        # factor-form lattice over every result vector:
                        # pre-shift SHR first when the scales need
                        # equalising, then the vector-vector op.
                        res_base = acc_off + a_c * b_c * row_height
                        insns.append(isa.MemInsn(
                            isa.Opcode.LOAD, isa.MemId.ACC,
                            sram_base=res_base,
                            dram_base=log("res")
                            + (i0 * beta + j0) * row_height,
                            y_size=a_c, x_size=b_c * row_height,
                            x_stride=beta * row_height))
                        pos = 0
                        for (wave, start, count) in use:
                            _ensure_wave(wave)
                            for t in range(count):
                                is_pre = pos == 0 and spec.pre_shift > 0
                                insns.append(isa.AluInsn(
                                    alu_opcode=(isa.AluOp.SHR if is_pre
                                                else spec.op),
                                    uop_bgn=start + t,
                                    uop_end=start + t + 1,
                                    iter_out=a_c * b_c, iter_in=row_height,
                                    dst_factor_out=row_height,
                                    dst_factor_in=1,
                                    src_factor_out=row_height,
                                    src_factor_in=1,
                                    use_imm=1 if is_pre else 0,
                                    imm=spec.pre_shift if is_pre else 0))
                                pos += 1
                        continue
                    use_imm = 1 if isinstance(spec, AluIndexedImmOp) else 0
                    imm = spec.imm if use_imm else 0
                    for (wave, start, count) in use:
                        _ensure_wave(wave)
                        insns.append(isa.AluInsn(
                            alu_opcode=spec.op, uop_bgn=start,
                            uop_end=start + count,
                            iter_out=1, iter_in=1, use_imm=use_imm,
                            imm=imm))
                insns[-1].dep.push_next = 1  # result ready for store
                if (sched.depth > 1 and ci == n_chunks - 1
                        and n_chunks >= sched.depth):
                    # Tail drain: with depth-2 overlap the store tokens of
                    # the last depth-1 chunks are never popped by a later
                    # chunk; consume the stale one here so FINISH's pop
                    # matches the *final* store's push.
                    insns[-1].dep.pop_next = 1

                st = isa.MemInsn(
                    isa.Opcode.STORE, isa.MemId.OUT, sram_base=acc_off,
                    dram_base=log("out") + (i0 * beta + j0) * row_height,
                    y_size=a_c, x_size=b_c * row_height,
                    x_stride=beta * row_height)
                st.dep.pop_prev = 1
                st.dep.push_prev = 1
                insns.append(st)

            fin = isa.FinishInsn()
            fin.dep.pop_next = 1             # last store completed
            insns.append(fin)
            return insns

        return uop_dram, emit

    # ---------------- candidate plans, picked by modeled makespan ----------
    if sched.depth > 1:
        base = _plan(True)
        candidates = [base]
        seen = {(base.alpha_segs, base.beta_segs, base.lam_c)}

        def _try(**caps) -> None:
            try:
                p = _plan(True, **caps)
            except CompileError:
                return                        # split collides with groups
            k = (p.alpha_segs, p.beta_segs, p.lam_c)
            if k not in seen:
                seen.add(k)
                candidates.append(p)

        # λ split → ≥2 load groups per chunk (double-buffered loads can
        # overlap GEMMs even inside a single chunk); α split → ≥2 chunks
        # (stores overlap the next chunk's compute).
        if base.lam_c > 1:
            _try(max_lam_c=-(-base.lam_c // 2))
        if base.alpha_c > 1:
            _try(max_alpha_c=-(-base.alpha_c // 2))
        if base.lam_c > 1 and base.alpha_c > 1:
            _try(max_lam_c=-(-base.lam_c // 2),
                 max_alpha_c=-(-base.alpha_c // 2))
    else:
        candidates = [_plan(False)]

    built = {id(p): _build(p) for p in candidates}
    if len(candidates) > 1:
        plan, _ = pipeline_schedule.choose_plan(
            candidates,
            lambda p: built[id(p)][1](lambda r: 0),
            cycle_model.simulate_pipeline)
    else:
        plan = candidates[0]
    uop_dram, emit = built[id(plan)]

    # ---------------- DRAM allocation (§2.2, order per §3.4) ----------------
    alloc = allocator if allocator is not None else DramAllocator(
        offset=dram_offset, page_bytes=cfg.page_bytes)
    pfx = f"{name}:" if allocator is not None else ""
    n_inp_vec = alpha * lam * row_height
    n_wgt_mat = lam * beta
    n_res_vec = alpha * beta * row_height
    regions = {
        "inp": alloc.alloc(pfx + "inp", "inp", cfg.inp_elem_bytes, n_inp_vec),
        "wgt": alloc.alloc(pfx + "wgt", "wgt", cfg.wgt_elem_bytes, n_wgt_mat),
    }
    if has_x:
        regions["acc"] = alloc.alloc(pfx + "acc", "acc", cfg.acc_elem_bytes,
                                     n_res_vec)
    if has_res:
        regions["res"] = alloc.alloc(pfx + "res", "acc", cfg.acc_elem_bytes,
                                     n_res_vec)
    regions["out"] = alloc.alloc(pfx + "out", "out", cfg.out_elem_bytes,
                                 n_res_vec)
    regions["uop"] = alloc.alloc(pfx + "uop", "uop", cfg.uop_elem_bytes,
                                 len(uop_dram))

    prog = VTAProgram(config=cfg, allocator=alloc, uops=uop_dram, name=name,
                      regions=regions, chunk_plan=plan,
                      schedule=sched.name, alu_ops=tuple(alu_ops))
    prog.set_segment("inp", inp_bin)
    prog.set_segment("wgt", wgt_bin)
    if has_x:
        prog.set_segment("acc", acc_bin)
    if has_res:
        prog.set_segment("res", res_bin)

    log = lambda r: regions[r].logical_addr(alloc.offset)
    prog.instructions = emit(log)

    # ---------------- expected output (oracle) ----------------
    acc_ref, out_ref = reference_result(A, B, X, alu_ops, cfg,
                                        row_height=row_height,
                                        residual=residual)
    prog.expected_out = out_ref
    prog.output_meta = OutputMeta(block_rows=alpha, block_cols=beta,
                                  row_height=row_height,
                                  valid_shape=(M, N))
    prog.finalize()
    return prog
