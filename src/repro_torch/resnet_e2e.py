"""resnet_tiny compiled through the graph front end and served on the CUDA
backend.

The port's counterpart of ``examples/resnet_e2e.py``: a CIFAR-10-scale
ResNet with two residual joins, each join an ALU vector-vector ADD
against an ACC-loaded second operand (on the device, not a host-side
merge).

  1. calibrate weight scales + static requant shifts (two-phase §4.2);
  2. compile the DAG into 7 VTA layer programs sharing one DRAM
     allocation; print the per-layer schedule — input/residual sources,
     chunk counts, ALU ADD instructions — and each join's shifts;
  3. run the compile-time input with every staged input and residual
     checked against the compiled matrices;
  4. serve seeded requests in batches and verify every answer bit-exactly
     against the graph's integer reference.

    PYTHONPATH=src python -m repro_torch.resnet_e2e [--requests 8]
                                                    [--batch 8]
                                                    [--device cuda|cpu]

The reference's ``--backend fast|oracle`` and ``--skip-oracle`` flags are
dropped: the port's network programs run on its ``cuda`` backend only.
With no ``--device`` it runs on the CUDA card and fails if there is none;
``--device cpu`` runs the kernel's plain torch version on the host.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core import isa
from repro_torch.device import resolve_device
from repro_torch.models.resnet_tiny import (compile_resnet_tiny,
                                            reference_forward_int8,
                                            synthetic_image)
from repro_torch.resnet8_e2e import cnn_args, serve_and_check


def schedule_lines(net) -> list:
    """The per-layer schedule: input and residual sources, SRAM chunks,
    GeMM loops and vector-vector ALU ADDs (the residual joins)."""
    srcs, rsrcs = net._sources(), net._res_sources()
    lines = ["layer   in<-  res<-  chunks  gemm_loops  alu_add_insns"]
    for k, layer in enumerate(net.layers):
        adds = sum(1 for i in layer.program.instructions
                   if isinstance(i, isa.AluInsn)
                   and i.alu_opcode == isa.AluOp.ADD and not i.use_imm)
        src = "img" if srcs[k] < 0 else net.layers[srcs[k]].spec.name
        res = "-" if rsrcs[k] is None else net.layers[rsrcs[k]].spec.name
        lines.append(f"  {layer.spec.name:<6}{src:>5}{res:>7}"
                     f"{layer.n_chunks:>7}{layer.program.gemm_loops():>12}"
                     f"{adds:>10}")
    return lines


def main() -> None:
    args = cnn_args("resnet_tiny served on the port's cuda backend")
    device = resolve_device(args.device)

    print("calibrating weight scales + requant shifts, compiling the "
          "resnet_tiny DAG...")
    t0 = time.perf_counter()
    net, graph = compile_resnet_tiny()
    print(f"  compiled in {time.perf_counter() - t0:.3f}s; "
          f"{len(net.layers)} VTA layers, "
          f"total GeMM loops = {net.gemm_loops()}")
    print("\n".join(schedule_lines(net)))
    joins = [l for l in net.layers if l.spec.residual_add]
    if len(joins) != 2 or max(l.n_chunks for l in joins) < 2:
        raise SystemExit("expected two residual joins, one multi-chunk")
    for l in joins:
        print(f"  join @{l.spec.name}: on-VTA ADD, skip pre-shift "
              f"{l.spec.residual_pre_shift}, post-add requant "
              f"{l.residual_shift}")

    out, _ = net.run_functional(device=device)
    if not np.array_equal(out, reference_forward_int8(graph,
                                                      net.input_tensor)):
        raise SystemExit("compile-time input: mismatch against the graph "
                         "integer reference")
    print("  compile-time input: every staged input and residual matches "
          "the compiled matrices")

    images = np.stack([synthetic_image(100 + r)
                       for r in range(args.requests)])
    serve_and_check(net, images,
                    lambda img: reference_forward_int8(graph, img),
                    args.batch, device)


if __name__ == "__main__":
    main()
