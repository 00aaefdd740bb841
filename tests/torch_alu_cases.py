"""TensorAlu programs that cover every form the epilogue takes: immediate
ops, indexed ops (an index given twice included), pair ops over disjoint, duplicate-``dst`` and
overlapping (sequential) lattices, and the residual op with pre-shifts.

Shared by the CPU tests (against the reference's epilogue and the
``vta_alu`` table) and the card test of the kernel, so it imports neither
``jax`` nor ``torch``: ``alu_ops`` builds a case's ops from either
package's ``gemm_compiler`` and ``isa``."""

from repro_torch.core.isa import AluOp


def alu_cases():
    add, mx, mn, shr = AluOp.ADD, AluOp.MAX, AluOp.MIN, AluOp.SHR
    disjoint = tuple((d, d + 8) for d in range(8))
    dup_dst = ((0, 8), (0, 9), (1, 10), (0, 11))
    overlap = ((0, 1), (1, 2), (2, 3), (4, 0))
    return [
        ("imm", [("imm", add, -7), ("imm", mx, 0), ("imm", shr, 3),
                 ("imm", mn, 100)]),
        ("indexed", [("idx", shr, 2, (0, 3, 5)), ("idx", add, 9, (1, 2))]),
        ("indexed_repeats", [("idx", add, -5, (3, 0, 3, 5)),
                             ("idx", mn, 7, (2, 1, 2))]),
        ("pair_add", [("pair", add, disjoint), ("pair", add, dup_dst)]),
        ("pair_minmax", [("pair", mx, dup_dst), ("pair", mn, disjoint)]),
        ("pair_shr", [("pair", shr, disjoint)]),
        ("pair_overlap", [("pair", add, overlap), ("pair", mx, overlap),
                          ("pair", shr, overlap)]),
        ("residual", [("res", add, 2), ("res", mx, 0), ("res", shr, 0)]),
    ]


def alu_ops(gc, isa, ops):
    out = []
    for kind, op, *rest in ops:
        op = isa.AluOp(int(op))
        if kind == "imm":
            out.append(gc.AluImmOp(op, rest[0]))
        elif kind == "idx":
            out.append(gc.AluIndexedImmOp(op, rest[0], rest[1]))
        elif kind == "pair":
            out.append(gc.AluPairOp(op, rest[0]))
        else:
            out.append(gc.AluResidualOp(op, pre_shift=rest[0]))
    return out
