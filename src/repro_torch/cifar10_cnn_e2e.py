"""The CIFAR-10-scale CNN compiled to VTA programs and served on the CUDA
backend.

The port's counterpart of ``examples/cifar10_cnn_e2e.py``: same-padded
convolutions, max pooling, and layer matrices that no longer fit one SRAM
residency (layer 1, conv 3→64 k5, lowers to a 1024×75 input matrix:
multi-chunk by construction).

  1. calibrate static requant shifts over a held-out image set (§4.2);
  2. compile all 5 layers into one shared DRAM allocation (Fig. 12) and
     print the per-layer chunk/uop/wave statistics;
  3. run the compile-time input on the ``cuda`` backend with every staged
     input checked against the compiled matrices, then the chain on the
     ``fast`` interpreter and — unless ``--skip-oracle`` — on the oracle,
     asserting every backend agrees byte for byte;
  4. serve seeded requests in batches on the ``cuda`` backend and verify
     every answer bit-exactly against the integer reference.

    PYTHONPATH=src python -m repro_torch.cifar10_cnn_e2e [--requests 8]
                                                         [--batch 8]
                                                         [--skip-oracle]
                                                         [--device cuda|cpu]

With no ``--device`` it runs on the CUDA card and fails if there is none;
``--device cpu`` runs on the host (the kernel's plain torch version on the
``cuda`` backend).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core import isa
from repro_torch.core.cycle_model import FPGA_CLOCK_HZ
from repro_torch.device import resolve_device
from repro_torch.models.cifar_cnn import (compile_cifar_cnn,
                                          reference_forward_int8)
from repro_torch.resnet8_e2e import cnn_args, serve_and_check


def layer_lines(net) -> list:
    """Per layer: SRAM chunks, GeMM loops, UOPs and LOAD_UOP waves."""
    lines = ["layer      chunks  gemm_loops  uops   uop_waves"]
    for layer in net.layers:
        prog = layer.program
        waves = sum(1 for i in prog.instructions
                    if isinstance(i, isa.MemInsn)
                    and i.memory_type == isa.MemId.UOP) - 1
        lines.append(f"  {layer.spec.name:<9}{layer.n_chunks:>5}"
                     f"{prog.gemm_loops():>12}{len(prog.uops):>7}"
                     f"{waves:>10}")
    return lines


def main() -> None:
    args = cnn_args("the CIFAR CNN served on the port's cuda backend",
                    skip_oracle=True)
    device = resolve_device(args.device)

    print("calibrating static requant shifts (§4.2), compiling the "
          "CIFAR-10 CNN through the VTA pipeline...")
    t0 = time.perf_counter()
    weights, shifts, net = compile_cifar_cnn()
    print(f"  compiled in {time.perf_counter() - t0:.3f}s; "
          f"total GeMM loops = {net.gemm_loops()} "
          f"(LeNet-5 was 2942 — ~{net.gemm_loops() / 2942:.0f}x larger)")
    print("\n".join(layer_lines(net)))
    if max(net.chunks_per_layer()) < 2:
        raise SystemExit("expected a multi-chunk layer")
    cr = net.cycle_report()
    print(f"  compute cycles = {cr.total_compute_cycles} "
          f"(+{cr.compute_load_cycles} UOP/ACC-load) → "
          f"{cr.execution_time_s(FPGA_CLOCK_HZ, include_loads=True) * 1e6:.1f}"
          f" µs @650 MHz (the modelled FPGA, not this device)")

    out, _ = net.run_functional(device=device)
    if not np.array_equal(out, reference_forward_int8(
            weights, net.input_tensor, shifts)[0]):
        raise SystemExit("compile-time input: mismatch against the integer "
                         "reference")
    print("  compile-time input: every staged input matches the compiled "
          "matrices")
    for backend in ("fast",) + (() if args.skip_oracle else ("oracle",)):
        print(f"verifying the chain ({backend} backend)...")
        other, _ = net.run_functional(backend=backend, device=device)
        if not np.array_equal(other, out):
            raise SystemExit(f"the {backend} backend disagrees with cuda")
    print("  " + ("fast and cuda" if args.skip_oracle
                  else "oracle, fast and cuda")
          + " backends agree bit-for-bit")

    rng = np.random.default_rng(42)
    images = np.stack([rng.integers(-64, 64, (1, 3, 32, 32)).astype(np.int8)
                       for _ in range(args.requests)])
    serve_and_check(net, images,
                    lambda img: reference_forward_int8(weights, img,
                                                       shifts)[0],
                    args.batch, device)


if __name__ == "__main__":
    main()
