"""ResNet-50 v1.5 compiled through the graph front end and served on the
CUDA backend.

  1. calibrate weight scales and static requant shifts (two-phase §4.2)
     and compile the DAG into 54 VTA layer programs sharing one DRAM
     allocation; print the per-layer schedule — input and residual
     sources, strides, pools, chunk counts;
  2. run the compile-time input through the network with every staged
     input and residual checked against the compiled matrices;
  3. serve seeded requests in batches: one ``vta_gemm`` launch a layer,
     the stem's 3×3/s2 max pool, the 16 joins and the 7×7 GAP on the
     TensorAlu epilogue;
  4. verify every answer bit-exactly against the graph's integer
     reference.

    PYTHONPATH=src python -m repro_torch.resnet50_e2e [--requests 8]
                                                      [--batch 8]
                                                      [--device cuda|cpu]
                                                      [--small]

At the published size (3×224×224) the compile and the reference want the
card machine; ``--small`` builds the same topology at 3×96×96 with every
width an eighth, which the CPU runs in seconds.  With no ``--device`` it
runs on the CUDA card and fails if there is none.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.models import resnet50
from repro_torch.models.resnet8 import reference_forward_int8
from repro_torch.resnet8_e2e import cnn_args, schedule_lines, serve_and_check

SMALL = resnet50.ResNet50Shape(input_hw=96, stem_width=8,
                               widths=(8, 16, 32, 64))


def main() -> None:
    small = "--small" in sys.argv
    if small:
        sys.argv.remove("--small")
    args = cnn_args("ResNet-50 v1.5 served on the port's cuda backend")
    device = resolve_device(args.device)
    shape = SMALL if small else resnet50.ResNet50Shape()

    print("calibrating weight scales + requant shifts, compiling the "
          "ResNet-50 DAG...")
    t0 = time.perf_counter()
    net, graph = resnet50.compile_resnet50(
        resnet50.resnet50_random_weights(shape),
        [resnet50.synthetic_image(s, shape) for s in range(1, 9)],
        resnet50.synthetic_image(0, shape), shape=shape)
    print(f"  compiled in {time.perf_counter() - t0:.3f}s; "
          f"{len(net.layers)} VTA layers, "
          f"total GeMM loops = {net.gemm_loops()}")
    print("\n".join(schedule_lines(net)))

    out, _ = net.run_functional(device=device)
    want = reference_forward_int8(graph, net.input_tensor)
    if not np.array_equal(out, want):
        raise SystemExit("compile-time input: mismatch against the graph "
                         "integer reference")
    print("  compile-time input: every staged input and residual matches "
          "the compiled matrices")

    images = np.stack([resnet50.synthetic_image(100 + r, shape)
                       for r in range(args.requests)])
    serve_and_check(net, images,
                    lambda img: reference_forward_int8(graph, img),
                    args.batch, device)


if __name__ == "__main__":
    main()
