"""One transformer projection layer executed three ways, bit-identically.

The port's counterpart of ``examples/vta_lm_projection.py``:

  1. the paper-faithful VTA path: the W8A8 projection is compiled by the
     standalone compiler (pad → split → binarise → GeMM instructions) and
     executed on the bit-accurate functional simulator (the oracle,
     :func:`repro_torch.core.simulator.run_program`);
  2. the hand-written Hopper ``vta_gemm`` kernel through
     :func:`repro_torch.kernels.ops.vta_matmul` on the device (its plain
     torch version when the device is the CPU);
  3. the plain torch version, ``ref.vta_gemm_ref``, on the host.

All three must produce the same int8 activations; the driver exits
non-zero otherwise.

    PYTHONPATH=src python -m repro_torch.vta_lm_projection [--device cuda|cpu]

With no ``--device`` it runs on the CUDA card and fails if there is none.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from repro_torch.core.gemm_compiler import AluImmOp, compile_matmul
from repro_torch.core.simulator import run_program
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref

SHIFT = 6


def projection_operands(seed: int = 7):
    """A GQA projection: 64 tokens × d_model 96 → kv heads 2 × head_dim 32,
    int8 activations and weights and an int32 bias, as the reference
    draws them."""
    rng = np.random.default_rng(seed)
    x_int8 = rng.integers(-64, 64, (64, 96), dtype=np.int64).astype(np.int8)
    w_int8 = rng.integers(-64, 64, (96, 64), dtype=np.int64).astype(np.int8)
    bias = rng.integers(-2000, 2000, (64,), dtype=np.int64).astype(np.int32)
    return x_int8, w_int8, bias


def run_projection(device: DeviceLike = None) -> Dict[str, object]:
    """The projection three ways; returns the three int8 outputs and the
    oracle's report."""
    dev = resolve_device(device)
    x_int8, w_int8, bias = projection_operands()
    prog = compile_matmul(x_int8, w_int8, bias=bias,
                          alu_ops=[AluImmOp.relu(), AluImmOp.shr(SHIFT)],
                          name="kv_proj")
    vta_out, report = run_program(prog)
    a, b, c = (torch.from_numpy(t) for t in (x_int8, w_int8, bias))
    kern_out = ops.vta_matmul(a.to(dev), b.to(dev), c.to(dev), relu=True,
                              shift=SHIFT, saturate=False).cpu().numpy()
    plain_out = ref.vta_gemm_ref(a, b, c, relu=True, shift=SHIFT,
                                 saturate=False).numpy()
    return {"oracle": vta_out, "kernel": kern_out, "plain": plain_out,
            "report": report, "device": dev}


# More compiled GEMMs beside the projection: (name, M, K, N, relu, shift,
# seed).  K = 75 and 200 are not multiples of the 16-wide block.
MATMUL_CASES = (
    ("k75", 40, 75, 24, True, 4, 11),
    ("k200_no_relu", 33, 200, 40, False, 7, 12),
    ("k64_shift0", 64, 64, 48, True, 0, 13),
)


def run_matmul_case(case, device: DeviceLike = None) -> Dict[str, object]:
    """One of :data:`MATMUL_CASES` compiled by ``compile_matmul`` and run on
    the oracle, then through ``ops.vta_matmul`` on ``device`` and the plain
    version in three output modes: truncating int8, saturating int8 and
    int32.  The oracle commits by truncation and stores no int32, so the
    int32 outputs are held to it through their truncation, and the
    saturating ones to the clip of the int32 output.  Returns each check
    by name (True where it holds) and the oracle's report."""
    name, m, k, n, relu, shift, seed = case
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k), dtype=np.int64).astype(np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int64).astype(np.int8)
    bias = rng.integers(-5000, 5000, (n,), dtype=np.int64).astype(np.int32)
    alu = ([AluImmOp.relu()] if relu else []) + \
        ([AluImmOp.shr(shift)] if shift else [])
    prog = compile_matmul(x, w, bias=bias, alu_ops=alu, name=name)
    oracle, report = run_program(prog)
    a, b, c = (torch.from_numpy(t) for t in (x, w, bias))
    kw = dict(relu=relu, shift=shift)
    out = {}
    for mode, extra in (("wrap", dict(saturate=False)),
                        ("saturate", dict(saturate=True)),
                        ("int32", dict(out_dtype=torch.int32))):
        out[mode] = ops.vta_matmul(a.to(dev), b.to(dev), c.to(dev), **kw,
                                   **extra).cpu()
        out[f"plain_{mode}"] = ref.vta_gemm_ref(a, b, c, **kw, **extra)
    acc = out["int32"].to(torch.int64)
    checks = {
        "kernel_wrap == oracle": np.array_equal(out["wrap"].numpy(), oracle),
        "plain_wrap == oracle": np.array_equal(out["plain_wrap"].numpy(),
                                               oracle),
        "kernel_int32 == plain_int32": torch.equal(out["int32"],
                                                   out["plain_int32"]),
        "truncate(kernel_int32) == oracle": np.array_equal(
            ref.truncate_int8(acc).numpy(), oracle),
        "kernel_saturate == plain_saturate": torch.equal(
            out["saturate"], out["plain_saturate"]),
        "kernel_saturate == clip(kernel_int32)": torch.equal(
            out["saturate"], acc.clamp(-128, 127).to(torch.int8)),
    }
    return {"name": name, "shape": (m, k, n), "checks": checks,
            "saturated": int((acc.abs() > 127).sum()), "report": report}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="a W8A8 projection on the VTA oracle, the kernel and "
                    "its plain version")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)
    res = run_projection(resolve_device(args.device))
    report, vta_out = res["report"], res["oracle"]
    print(f"VTA path: {report.gemm_loops} GeMM loops, "
          f"{report.insn_executed} instructions, "
          f"{report.dram_bytes_total} DRAM bytes")
    ok = True
    for name in ("kernel", "plain"):
        if not np.array_equal(vta_out, res[name]):
            print(f"VTA simulator != {name} on {res['device']}",
                  file=sys.stderr)
            ok = False
    if not ok:
        return 1
    print(f"VTA simulator == vta_gemm on {res['device']} == plain torch "
          f"version (bit-exact)")
    print(f"output sample: {vta_out[0, :8]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
