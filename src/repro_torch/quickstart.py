"""Quickstart — the paper's §3.4 worked example, end to end, on the port.

The port's counterpart of ``examples/quickstart.py``: compiles
C = ReLU(A·B) for 16×16 int8 matrices down to VTA binaries, prints the
DRAM regions and the instruction stream, runs the program on the
functional simulator (``oracle``) and on the ``vta_gemm`` kernel
(``cuda``, one launch), and checks both results bit for bit.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cuda|cpu]

With no ``--device`` the ``cuda`` backend runs on the CUDA card, and the
run fails if there is none; on ``--device cpu`` that backend runs the
kernel's plain torch version.  Exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import List, Optional

import numpy as np

from repro_torch.core import isa
from repro_torch.core.gemm_compiler import AluImmOp, compile_matmul
from repro_torch.core.program import VTAProgram
from repro_torch.core.simulator import run_program
from repro_torch.device import resolve_device


def operands():
    """The reference's seeded 16×16 int8 A and B."""
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, (16, 16), dtype=np.int64).astype(np.int8)
    b = rng.integers(-128, 128, (16, 16), dtype=np.int64).astype(np.int8)
    return a, b


def quickstart_program() -> VTAProgram:
    """ReLU(A·B) compiled to a VTA program."""
    return compile_matmul(*operands(), alu_ops=[AluImmOp.relu()],
                          name="quickstart")


def expected() -> np.ndarray:
    """ReLU(A·B) truncated to int8, on the host."""
    a, b = operands()
    out = np.maximum(a.astype(np.int64) @ b.astype(np.int64), 0)
    return (out & 0xFF).astype(np.uint8).view(np.int8)


def describe(prog: VTAProgram) -> List[str]:
    """The DRAM allocation (§2.2), the instruction stream (§3.3) and the
    UOPs, as the reference's quickstart prints them."""
    lines = ["== DRAM allocation (§2.2) =="]
    for region in prog.allocator.regions:
        lines.append(f"  {region.name:<18} phys @{region.phys_addr:#06x}  "
                     f"logical @{region.logical_addr(0):#06x}  "
                     f"{region.count} × {region.struct_bytes}B")
    lines.append("\n== instruction stream (§3.3) ==")
    for i, insn in enumerate(prog.instructions):
        if isinstance(insn, isa.MemInsn):
            lines.append(f"  [{i}] {insn.opcode.name} "
                         f"{insn.memory_type.name} "
                         f"sram@{insn.sram_base:#x} dram@{insn.dram_base:#x} "
                         f"y={insn.y_size} x={insn.x_size}")
        elif isinstance(insn, isa.GemInsn):
            lines.append(f"  [{i}] GEMM{' (reset)' if insn.reset else ''} "
                         f"uop[{insn.uop_bgn}:{insn.uop_end}] "
                         f"LP_OUT={insn.iter_out} LP_IN={insn.iter_in}")
        elif isinstance(insn, isa.AluInsn):
            lines.append(f"  [{i}] ALU {insn.alu_opcode.name} imm={insn.imm}")
        else:
            lines.append(f"  [{i}] FINISH")
    uops = [(u.acc_idx, u.inp_idx, u.wgt_idx) for u in prog.uops]
    lines.append(f"\nUOPs: {uops}")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the cuda backend (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    prog = quickstart_program()
    print("\n".join(describe(prog)))
    want = expected()
    ok = True
    reports = {}
    for backend in ("oracle", "cuda"):
        out, reports[backend] = run_program(
            prog, backend=backend,
            device=device if backend == "cuda" else None)
        same = np.array_equal(out, want)
        ok &= same
        print(f"\n{backend} ({device if backend == 'cuda' else 'host'}): "
              f"{'bit-exact' if same else 'MISMATCH'}")
    report = reports["oracle"]
    print(f"GeMM loops: {report.gemm_loops} (§3.4: one 16-loop instruction)")
    print(f"DRAM traffic: {report.dram_bytes_total} bytes")
    with tempfile.TemporaryDirectory() as d:
        files = prog.write_binaries(d)
        print("Fig. 5 binaries:", sorted(p.name for p in files.values()))
    print("bit-exact ✓" if ok else "bit-exact ✗")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
