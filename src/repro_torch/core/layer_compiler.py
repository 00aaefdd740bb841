"""One CNN layer → one VTA program (paper §4.2, Fig. 11).

A *layer* (paper §4.1) = one dense linear operation (convolution — valid or
zero-padded "same", stride 1 or 2 (DESIGN.md §Strided-lowering) — or fully
connected) + subsequent non-linear operations (ReLU on TensorAlu; average
pooling as an ALU ADD/SHR program; max pooling as an ALU MAX pair program;
global average pooling as an ALU ADD-pair tree reduction + one SHR; static
power-of-2 requantisation).  Layers
whose matrices exceed the SRAM compile to multi-chunk programs — the GEMM
compiler re-indexes the pool/requant uops against each chunk's local ACC
window (DESIGN.md §3), so nothing here is limited to single-chunk results.

The lowering is the extended pipeline of Fig. 11:

    tensor ──im2row/ker2col──▶ matrices ──pad/split/binarise──▶ data
    layer op ────────────────▶ GEMM + ALU instructions + UOPs

Requantisation discipline (hardware adaptation, DESIGN.md §2): the VTA OUT
path truncates ACC (int32) to int8, so every layer ends with an arithmetic
right shift that brings the live values into [-128, 127].  Shifts are
*static* — chosen at compile time from the reference activations — which is
precisely the predictable-execution property the paper targets.  For pooled
layers, the pool's ÷4 and the requant shift fuse into one SHR (2 + shift)
over the surviving rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .conv_lowering import (ConvGeometry, PoolPlan, avgpool2x2_plan,
                            expand_rows, flatten_tensor, global_avgpool_plan,
                            im2row, ker2col, mat2tensor, maxpool2x2_plan,
                            maxpool3x3s2_matrix, maxpool3x3s2_plan,
                            tensor2mat)
from .dram import DramAllocator
from .errors import CompileError
from .gemm_compiler import (AluImmOp, AluIndexedImmOp, AluPairOp,
                            AluResidualOp, chunk_dims, compile_matmul)
from .hwconfig import VTAConfig, vta_default
from .layout import (exact_matmul, pad_to_multiple, should_pad_height,
                     truncate_int8)
from .program import VTAProgram
from . import isa, pipeline_schedule


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Hardware-agnostic description of one layer.

    conv: ``weights`` is ``(F, C, kh, kw)`` int8; input is a ``(1, C, H, W)``
    int8 tensor.  fc: ``weights`` is ``(D, F)`` int8; input is a ``(1, D)``
    int8 matrix (or a tensor, flattened NCHW).
    """

    name: str
    kind: str                      # "conv" | "fc"
    weights: np.ndarray
    bias: Optional[np.ndarray] = None     # int32 (F,)
    stride: int = 1
    padding: int = 0               # symmetric zero-padding (conv only)
    relu: bool = False
    pool: Optional[str] = None     # None | "avg2x2" | "max2x2" |
                                   # "max3x3s2" | "gap"
    requant_shift: Optional[int] = None   # None = choose statically
    # Residual-add fusion (DESIGN.md §Graph): the layer closes a skip
    # connection — after the GEMM result is requantised (``requant_shift``)
    # the skip operand is ACC-loaded and merged on the VTA with an ALU
    # vector-vector ADD (``residual_pre_shift`` equalises its scale), then
    # ``relu`` applies *post-add* and ``residual_shift`` requantises the
    # sum.  ``compile_layer`` must then receive the skip activation via
    # its ``residual=`` argument.  Of the pools only the GAP fuses with a
    # residual, after the join's ReLU (``residual_shift`` then requantises
    # the GAP's sum: ResNet-50's head).
    residual_add: bool = False
    residual_pre_shift: int = 0
    residual_shift: Optional[int] = None  # None = choose statically

    def out_features(self) -> int:
        return (self.weights.shape[0] if self.kind == "conv"
                else self.weights.shape[1])


@dataclasses.dataclass
class CompiledLayer:
    """A compiled layer: the VTA program + the decode metadata the host
    needs for §4.2 reshaping."""

    spec: LayerSpec
    program: VTAProgram
    input_matrix: np.ndarray          # A (int8), pre-padding
    weight_matrix: np.ndarray         # B (int8), pre-padding
    requant_shift: int
    keep_rows: Optional[Tuple[int, ...]]   # pooled surviving rows, or None
    out_h: Optional[int] = None       # post-pool spatial dims (conv only)
    out_w: Optional[int] = None
    ref_output_matrix: Optional[np.ndarray] = None  # int8 (rows×F) post-reshape
    # Residual layers: the reference skip operand (int32 (M, N), add-time
    # scale) and the post-add requant shift actually compiled in.
    residual_matrix: Optional[np.ndarray] = None
    residual_shift: Optional[int] = None
    # The im2row row each row of ``input_matrix`` copies (-1: a zero row),
    # or None where A is the im2row itself (PoolPlan.input_rows)
    input_rows: Optional[Tuple[int, ...]] = None

    @property
    def gemm_loops(self) -> int:
        return self.program.gemm_loops()

    @property
    def n_chunks(self) -> int:
        """SRAM chunks the layer's GEMM was tiled into (§3.3 repetition)."""
        plan = self.program.chunk_plan
        return plan.n_chunks if plan is not None else 1


def _vec_index(row: int, col_block: int, beta: int, row_height: int) -> int:
    """ACC-vector index of matrix row ``row`` in block column ``col_block``
    (block-major SRAM layout, §3.2)."""
    block_row, within = divmod(row, row_height)
    return (block_row * beta + col_block) * row_height + within


def pool_plan_for(spec: LayerSpec, geo: Optional[ConvGeometry], *,
                  max_rows: Optional[int] = None,
                  block: int = 1) -> Optional[PoolPlan]:
    """The pooling plan a LayerSpec asks for (None = no pooling).  The
    single place pool kinds are interpreted — unknown kinds raise here for
    the compiler and the calibration path alike.  ``max_rows``/``block``
    tile the 3×3/s2 max pool's result into chunks of at most ``max_rows``
    rows (:func:`~repro_torch.core.conv_lowering.maxpool3x3s2_plan`; None:
    the conv's own rows)."""
    if spec.pool is None:
        return None
    if geo is None:
        raise CompileError("pooling requires a conv layer", layer=spec.name,
                           constraint="pool-needs-conv")
    if spec.pool in ("avg2x2", "max2x2"):
        if geo.out_h % 2 or geo.out_w % 2:
            raise CompileError(
                f"2x2 pooling needs even conv output dims, got "
                f"{geo.out_h}x{geo.out_w}", layer=spec.name,
                constraint="pool-even-dims")
        return (avgpool2x2_plan if spec.pool == "avg2x2"
                else maxpool2x2_plan)(geo.out_h, geo.out_w)
    if spec.pool == "max3x3s2":
        try:
            return maxpool3x3s2_plan(geo.out_h, geo.out_w,
                                     max_rows=max_rows, block=block)
        except ValueError as exc:
            raise CompileError(str(exc), layer=spec.name,
                               constraint="pool-tile-chunk") from None
    if spec.pool == "gap":
        check_gap_geometry(geo.out_h, geo.out_w, layer=spec.name)
        return global_avgpool_plan(geo.out_h, geo.out_w)
    raise CompileError(f"unsupported pool kind {spec.pool!r} (expected "
                       f"'avg2x2', 'max2x2', 'max3x3s2' or 'gap')",
                       layer=spec.name, constraint="pool-kind")


def pool_divisor(pool_plan: Optional[PoolPlan]) -> int:
    """log2 of the pooling division folded into the requant shift
    (avg pool sums 4 members → ÷4; GAP sums H·W → ÷(H·W); max pool
    divides by nothing)."""
    return pool_plan.div_shift if pool_plan is not None else 0


def choose_requant_shift(acc: np.ndarray, *, already_shifted: int = 0) -> int:
    """Smallest shift s with ``max|acc >> (already_shifted + s)| <= 127``."""
    m = int(np.abs(acc.astype(np.int64) >> already_shifted).max(initial=0))
    shift = 0
    while (m >> shift) > 127:
        shift += 1
    return shift


def check_stride_tiling(geo: ConvGeometry, *, layer: str = "") -> None:
    """Stride-2 grid-coverage constraint (DESIGN.md §Strided-lowering).

    The strided window grid must reach the last *real* input pixel: the
    uncovered tail of the padded input is ``(in + 2·pad - k) mod stride``
    columns/rows wide, and anything beyond the trailing ``pad`` of those
    is input data the conv would silently ignore — which the compiler
    refuses (never silent wrong bytes).  A kernel narrower than its stride
    (the 1×1/s2 projection shortcut of ResNet) reads every ``stride``-th
    pixel by definition, skipped pixels included, so that axis passes.
    Shared by the layer compiler and the graph shape-inference pass so the
    two front ends cannot drift.
    """
    if geo.stride == 1:
        return
    for axis, extent, k in (("height", geo.in_h, geo.kh),
                            ("width", geo.in_w, geo.kw)):
        if k < geo.stride:
            continue
        leftover = (extent + 2 * geo.pad - k) % geo.stride
        if leftover > geo.pad:
            raise CompileError(
                f"stride-{geo.stride} windows (kernel {k}, pad {geo.pad}) "
                f"leave the last {leftover} input {axis} position(s) "
                f"uncovered — pad the input or adjust the kernel so the "
                f"strided grid lands flush", layer=layer,
                constraint="conv-stride-tiling")


def check_gap_geometry(out_h: int, out_w: int, *, layer: str = "") -> None:
    """Global-avg-pool map constraint (DESIGN.md §Strided-lowering): the
    map must be square.  Any position count reduces exactly (the ADD tree
    of :func:`~repro_torch.core.conv_lowering.global_avgpool_plan`); the
    ÷(H·W) is one exact SHR on a power-of-two count and the requant's
    power-of-two scale on any other.  Shared by the layer compiler and the
    graph shape-inference pass so the two front ends cannot drift."""
    if out_h != out_w:
        raise CompileError(
            f"global avg pool needs a square map, got {out_h}x{out_w}",
            layer=layer, constraint="gap-square")


def layer_matrices(spec: LayerSpec, inp: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[ConvGeometry]]:
    """Hardware-agnostic stage: tensors → (A, B) matrices (Def. 3).

    Every unsupported shape/stride raises a typed :class:`CompileError`
    naming the layer and the violated constraint (certification-style
    traceability — never a bare assert)."""
    if spec.kind == "conv":
        if inp.ndim != 4:
            raise CompileError(
                f"conv input must be a (1, C, H, W) tensor, got shape "
                f"{inp.shape}", layer=spec.name, constraint="conv-input-rank")
        if inp.shape[0] != 1:
            raise CompileError(
                f"conv compiles per-image (batch axis must be 1), got "
                f"batch {inp.shape[0]}; batching happens at serve time",
                layer=spec.name, constraint="conv-batch-one")
        if spec.weights.ndim != 4:
            raise CompileError(
                f"conv weights must be (F, C, kh, kw), got shape "
                f"{spec.weights.shape}", layer=spec.name,
                constraint="conv-weight-rank")
        if spec.stride < 1:
            raise CompileError(f"stride must be >= 1, got {spec.stride}",
                               layer=spec.name, constraint="conv-stride")
        if spec.stride > 2:
            raise CompileError(
                f"stride {spec.stride} unsupported — the strided lowering "
                f"covers strides 1 and 2 (DESIGN.md §Strided-lowering)",
                layer=spec.name, constraint="conv-stride-max")
        if spec.padding < 0:
            raise CompileError(f"padding must be >= 0, got {spec.padding}",
                               layer=spec.name, constraint="conv-padding")
        f, c, kh, kw = spec.weights.shape
        if inp.shape[1] != c:
            raise CompileError(
                f"channel mismatch: input has {inp.shape[1]} channels, "
                f"weights expect {c}", layer=spec.name,
                constraint="conv-channels")
        geo = ConvGeometry(c, inp.shape[2], inp.shape[3], kh, kw, spec.stride,
                           spec.padding)
        if geo.out_h <= 0 or geo.out_w <= 0:
            raise CompileError(
                f"kernel {kh}x{kw} (stride {spec.stride}, pad "
                f"{spec.padding}) does not fit the {inp.shape[2]}x"
                f"{inp.shape[3]} input", layer=spec.name,
                constraint="conv-kernel-fit")
        check_stride_tiling(geo, layer=spec.name)
        A = im2row(inp, kh, kw, spec.stride, spec.padding)
        B = ker2col(spec.weights)
        return A, B, geo
    if spec.kind == "fc":
        A = flatten_tensor(inp) if inp.ndim == 4 else np.asarray(inp)
        if A.ndim != 2:
            raise CompileError(
                f"fc input must be 2-D (or a flattenable NCHW tensor), got "
                f"shape {np.asarray(inp).shape}", layer=spec.name,
                constraint="fc-input-rank")
        B = np.asarray(spec.weights)
        if B.ndim != 2:
            raise CompileError(
                f"fc weights must be 2-D (D, F), got shape {B.shape}",
                layer=spec.name, constraint="fc-weight-rank")
        if A.shape[1] != B.shape[0]:
            raise CompileError(
                f"fc dimension mismatch: {A.shape} @ {B.shape}",
                layer=spec.name, constraint="fc-shape")
        return A, B, None
    raise CompileError(f"unknown layer kind {spec.kind!r} (expected 'conv' "
                       f"or 'fc')", layer=spec.name, constraint="layer-kind")


def reference_layer_acc(A: np.ndarray, B: np.ndarray,
                        bias: Optional[np.ndarray], relu: bool,
                        pool_plan: Optional[PoolPlan]) -> np.ndarray:
    """int64 accumulator right before the final SHR — used for the static
    requant-shift choice and overflow check."""
    acc = exact_matmul(A, B)
    if bias is not None:
        acc = acc + bias.astype(np.int64)[None, :]
    if relu:
        acc = np.maximum(acc, 0)
    if pool_plan is not None:
        if pool_plan.mode == "gap":
            # every spatial position folds into row 0 (÷ in the requant)
            return acc.sum(axis=0, keepdims=True)
        if pool_plan.mode == "max3x3":
            return maxpool3x3s2_matrix(acc, pool_plan.in_w)
        pooled = np.zeros((len(pool_plan.keep_rows), acc.shape[1]),
                          dtype=np.int64)
        for r, base in enumerate(pool_plan.keep_rows):
            in_w = pool_plan.out_w * 2
            rows = [base, base + 1, base + in_w, base + in_w + 1]
            if pool_plan.mode == "max":
                pooled[r] = acc[rows].max(axis=0)
            else:
                pooled[r] = acc[rows].sum(axis=0)
        return pooled
    return acc


def residual_operand_matrix(spec: LayerSpec, residual: np.ndarray,
                            shape: Tuple[int, int]) -> np.ndarray:
    """Skip activation (semantic int8 tensor/matrix) → the int32 (M, N)
    second ACC operand of the layer's residual add.  The single place the
    conversion lives — compilation and run-time staging both route through
    it, so the geometries can never drift."""
    sem = np.asarray(residual)
    R = tensor2mat(sem.astype(np.int8)) if sem.ndim == 4 else sem
    if R.ndim != 2 or R.shape != shape:
        raise CompileError(
            f"residual operand (shape {sem.shape}) does not match the "
            f"layer's {shape} result", layer=spec.name,
            constraint="residual-shape")
    return R.astype(np.int32)


def _compile_residual_layer(spec: LayerSpec, A: np.ndarray, B: np.ndarray,
                            geo: Optional[ConvGeometry],
                            residual: Optional[np.ndarray], cfg: VTAConfig,
                            allocator: Optional[DramAllocator],
                            schedule: str = "serialized") -> CompiledLayer:
    """The residual-closing layer (DESIGN.md §Graph): GEMM → SHR(requant)
    → on-VTA vector-vector ADD with the ACC-loaded skip operand →
    optional ReLU → [GAP tree] → SHR(post-add requant)."""
    if spec.pool not in (None, "gap"):
        raise CompileError(
            "of the pools only the GAP fuses with a residual add "
            "(downsample with a strided conv instead)", layer=spec.name,
            constraint="residual-no-pool")
    if residual is None:
        raise CompileError(
            "residual_add layer compiled without a residual operand",
            layer=spec.name, constraint="residual-operand-missing")
    if spec.residual_pre_shift < 0:
        raise CompileError(
            f"residual pre-shift must be >= 0, got "
            f"{spec.residual_pre_shift}", layer=spec.name,
            constraint="residual-pre-shift")
    M, N = A.shape[0], B.shape[1]
    R = residual_operand_matrix(spec, residual, (M, N))

    acc = exact_matmul(A, B)
    if spec.bias is not None:
        acc = acc + spec.bias.astype(np.int64)[None, :]
    s_conv = (spec.requant_shift if spec.requant_shift is not None
              else choose_requant_shift(acc))
    t = (acc >> s_conv) + (R.astype(np.int64) >> spec.residual_pre_shift)
    if spec.relu:
        t = np.maximum(t, 0)
    gap = pool_plan_for(spec, geo)
    if gap is not None:
        t = t.sum(axis=0, keepdims=True)
    s_add = (spec.residual_shift if spec.residual_shift is not None
             else choose_requant_shift(t))
    final = t >> s_add
    if np.abs(final).max(initial=0) > 127:
        raise CompileError(
            f"post-add requant shift {s_add} leaves values outside int8 — "
            f"increase residual_shift", layer=spec.name,
            constraint="requant-int8-range")

    alu_ops: List[object] = []
    if s_conv > 0:
        alu_ops.append(AluImmOp.shr(s_conv))
    alu_ops.append(AluResidualOp(isa.AluOp.ADD,
                                 pre_shift=spec.residual_pre_shift))
    if spec.relu:
        alu_ops.append(AluImmOp.relu())
    if gap is not None:
        row_height = cfg.block_size if should_pad_height(A) else M
        alu_ops += _pool_alu_ops(gap, N, cfg.block_size, row_height)
    if s_add > 0:
        alu_ops.append(AluImmOp.shr(s_add))

    prog = compile_matmul(A, B, bias=spec.bias, alu_ops=alu_ops, residual=R,
                          cfg=cfg, name=spec.name, allocator=allocator,
                          schedule=schedule)
    prog.alu_kind = "join" if gap is None else "join+gap"
    out_h = geo.out_h if geo is not None else None
    out_w = geo.out_w if geo is not None else None
    if gap is not None:
        out_h, out_w = gap.out_h, gap.out_w
    return CompiledLayer(spec=spec, program=prog, input_matrix=A,
                         weight_matrix=B, requant_shift=s_conv,
                         keep_rows=gap.keep_rows if gap else None,
                         out_h=out_h, out_w=out_w,
                         ref_output_matrix=truncate_int8(final),
                         residual_matrix=R, residual_shift=s_add)


def _pool_alu_ops(pool_plan: PoolPlan, n: int, block_size: int,
                  row_height: int) -> List[object]:
    """A pool's pair ops over the result vectors: one ``AluPairOp`` per
    dependency level.  2×2 and 3×3 windows are one flat independent set;
    the GAP tree emits one op per round so every instruction's (dst, src)
    lattice stays disjoint (vectorisable) while the read-after-write chain
    lives *between* instructions."""
    beta = pad_to_multiple(n, block_size) // block_size
    pool_op = (isa.AluOp.ADD if pool_plan.mode in ("avg", "gap")
               else isa.AluOp.MAX)
    ops: List[object] = []
    for round_pairs in pool_plan.rounds or (pool_plan.add_pairs,):
        pairs = []
        for dst, src in round_pairs:
            for j in range(beta):
                pairs.append((_vec_index(dst, j, beta, row_height),
                              _vec_index(src, j, beta, row_height)))
        ops.append(AluPairOp(pool_op, tuple(pairs)))
    return ops


POOL_KINDS = {"avg": "pool2x2", "max": "pool2x2", "max3x3": "maxpool3x3s2",
              "gap": "gap"}


def _pool_capacity(A: np.ndarray, B: np.ndarray, cfg: VTAConfig,
                   schedule: str) -> Tuple[int, int]:
    """``(max_rows, block)``: the result rows one SRAM chunk of this GEMM
    holds under ``schedule`` (a tiled pool keeps each tile inside one), and
    the rows of a block row."""
    bs = cfg.block_size
    rh = bs if should_pad_height(A) else A.shape[0]
    lam = pad_to_multiple(A.shape[1], bs) // bs
    beta = pad_to_multiple(B.shape[1], bs) // bs
    double = (schedule == pipeline_schedule.PIPELINED
              and pipeline_schedule.pipelinable(cfg, rh, 1))
    _, _, alpha_c = chunk_dims(cfg, A.shape[0], lam, beta, rh,
                               double_buffer=double)
    return alpha_c * rh, rh


def compile_layer(spec: LayerSpec, inp: np.ndarray, *,
                  cfg: Optional[VTAConfig] = None,
                  allocator: Optional[DramAllocator] = None,
                  residual: Optional[np.ndarray] = None,
                  schedule: str = "serialized") -> CompiledLayer:
    """Compile one layer (Fig. 11) down to a :class:`VTAProgram`.

    For residual layers (``spec.residual_add``) pass the skip activation
    — the semantic int8 output of the earlier layer — as ``residual``; it
    becomes the program's second ACC operand, merged on the VTA."""
    cfg = cfg or vta_default()
    bs = cfg.block_size
    A, B, geo = layer_matrices(spec, inp)
    if spec.residual_add:
        return _compile_residual_layer(spec, A, B, geo, residual, cfg,
                                       allocator, schedule=schedule)
    if residual is not None:
        raise CompileError(
            "residual operand passed to a layer without residual_add",
            layer=spec.name, constraint="residual-unexpected-operand")
    N = B.shape[1]

    # ---- pooling plan (indices in matrix-row space) ----
    if spec.pool == "max3x3s2" and geo is not None:
        max_rows, block = _pool_capacity(A, B, cfg, schedule)
        pool_plan = pool_plan_for(spec, geo, max_rows=max_rows, block=block)
    else:
        pool_plan = pool_plan_for(spec, geo)

    # ---- static requant shift (+ overflow check) ----
    acc_pre_shift = reference_layer_acc(A, B, spec.bias, spec.relu, pool_plan)
    pool_div = pool_divisor(pool_plan)
    shift = (spec.requant_shift if spec.requant_shift is not None
             else choose_requant_shift(acc_pre_shift, already_shifted=pool_div))
    final = acc_pre_shift >> (pool_div + shift)
    if np.abs(final).max(initial=0) > 127:
        raise CompileError(
            f"requant shift {shift} leaves values outside int8 — increase "
            f"requant_shift", layer=spec.name,
            constraint="requant-int8-range")

    # ---- ALU program over ACC vectors (block-major indices) ----
    input_rows = pool_plan.input_rows if pool_plan is not None else None
    A = expand_rows(A, input_rows)
    pad_h = should_pad_height(A)
    row_height = bs if pad_h else A.shape[0]
    beta = pad_to_multiple(N, bs) // bs
    alu_ops: List[object] = []
    if spec.relu:
        alu_ops.append(AluImmOp.relu())
    if pool_plan is not None:
        alu_ops += _pool_alu_ops(pool_plan, N, bs, row_height)
        total_shift = pool_div + shift
        if total_shift > 0:
            idx = []
            for r in pool_plan.keep_rows:
                for j in range(beta):
                    idx.append(_vec_index(r, j, beta, row_height))
            alu_ops.append(AluIndexedImmOp(isa.AluOp.SHR, total_shift,
                                           tuple(idx)))
    elif shift > 0:
        alu_ops.append(AluImmOp.shr(shift))

    prog = compile_matmul(A, B, bias=spec.bias, alu_ops=alu_ops, cfg=cfg,
                          name=spec.name, allocator=allocator,
                          schedule=schedule)
    if pool_plan is not None:
        prog.alu_kind = POOL_KINDS[pool_plan.mode]

    # ---- reference post-reshape output matrix (int8) ----
    ref = truncate_int8(final)

    keep = pool_plan.keep_rows if pool_plan is not None else None
    out_h = out_w = None
    if geo is not None:
        out_h = pool_plan.out_h if pool_plan else geo.out_h
        out_w = pool_plan.out_w if pool_plan else geo.out_w
    return CompiledLayer(spec=spec, program=prog, input_matrix=A,
                         weight_matrix=B, requant_shift=shift,
                         keep_rows=keep, out_h=out_h, out_w=out_w,
                         ref_output_matrix=ref, input_rows=input_rows)


def verify_layer(layer: CompiledLayer, *, backend: str = "oracle",
                 device=None):
    """Run one compiled layer's program on the chosen backend (``oracle``,
    ``fast``, ``batched`` or ``cuda``; the last three on ``device``, the
    card unless the caller names another) and assert it reproduces the
    compiler's expected OUT region.  Returns the
    :class:`~repro_torch.core.simulator.SimReport`."""
    from .simulator import verify_program
    return verify_program(layer.program, backend=backend, device=device)


def decode_layer_output(layer: CompiledLayer, out_matrix: np.ndarray
                        ) -> np.ndarray:
    """§4.2 host reshaping, stage (i)+(ii) entry: from the decoded (M, N)
    VTA output matrix to the layer's *semantic* output.

    conv → ``(1, F, H', W')`` tensor (pooled rows extracted first);
    fc   → ``(rows, F)`` matrix.
    """
    if layer.keep_rows is not None:
        out_matrix = out_matrix[list(layer.keep_rows)]
    if layer.spec.kind == "conv":
        return mat2tensor(out_matrix, layer.out_h, layer.out_w)
    return out_matrix
