"""resnet8 compiled through the graph front end and served on the CUDA backend.

The port's counterpart of ``examples/resnet8_e2e.py``:

  1. calibrate weight scales and static requant shifts (two-phase §4.2)
     and compile the DAG into 11 VTA layer programs sharing one DRAM
     allocation; print the per-layer schedule — input and residual
     sources, strides, chunk counts;
  2. run the compile-time input through the network with every staged
     input and residual checked against the compiled matrices;
  3. serve seeded requests in batches: one device-resident DRAM stack per
     batch, one ``vta_gemm`` kernel launch per layer, residual joins and
     the global-average-pool head on the TensorAlu epilogue;
  4. verify every answer bit-exactly against the graph's integer
     reference.

    PYTHONPATH=src python -m repro_torch.resnet8_e2e [--requests 32]
                                                     [--batch 8]
                                                     [--device cuda|cpu]

With no ``--device`` it runs on the CUDA card and fails if there is none;
``--device cpu`` runs the kernel's plain torch version on the host.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.resnet8 import (compile_resnet8,
                                        reference_forward_int8,
                                        synthetic_image)


def schedule_lines(net) -> list:
    """The per-layer schedule: input and residual sources, stride, pool,
    SRAM chunks, GeMM loops."""
    srcs, rsrcs = net._sources(), net._res_sources()
    lines = ["layer     in<-   res<-  stride  pool  chunks  gemm_loops"]
    for k, layer in enumerate(net.layers):
        src = "img" if srcs[k] < 0 else net.layers[srcs[k]].spec.name
        res = "-" if rsrcs[k] is None else net.layers[rsrcs[k]].spec.name
        lines.append(f"  {layer.spec.name:<6}{src:>6}{res:>8}"
                     f"{layer.spec.stride:>7}{layer.spec.pool or '-':>7}"
                     f"{layer.n_chunks:>7}{layer.program.gemm_loops():>12}")
    return lines


def request_images(n: int, seed: int = 100) -> np.ndarray:
    """``n`` seeded (1, 3, 32, 32) int8 request images, stacked."""
    return np.stack([synthetic_image(seed + r) for r in range(n)])


def cnn_args(description: str) -> argparse.Namespace:
    """The CNN drivers' flags: ``--requests``, ``--batch``, ``--device``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8,
                    help="requests per served batch (default: 8)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args()
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    return args


def serve_and_check(net, images: np.ndarray, reference, batch: int,
                    device: torch.device) -> None:
    """Serve ``images`` in batches of ``batch`` on ``device`` (after a
    warm-up that builds the kernel and uploads the image), hold every
    answer bit-exactly against ``reference(img)`` and print img/s and the
    N/N line; exits non-zero on a mismatch."""
    net.serve(images[:1], device=device)            # warm-up: build, upload
    logits_all = []
    serve_s = 0.0
    for lo in range(0, len(images), batch):
        t0 = time.perf_counter()
        outs, _ = net.serve(images[lo:lo + batch], device=device)
        serve_s += time.perf_counter() - t0
        logits_all.extend(outs)
    for r, (img, logits) in enumerate(zip(images, logits_all)):
        if not np.array_equal(logits, reference(img)):
            raise SystemExit(f"request {r}: mismatch against the integer "
                             f"reference")
    n = len(images)
    if n:
        print(f"\nserved {n} requests in {serve_s:.4f}s "
              f"({n / serve_s:.1f} img/s, batch {batch} on {device}"
              + (f" [{torch.cuda.get_device_name(device)}]"
                 if device.type == "cuda" else "")
              + "; verification excluded)")
        print(f"bit-exact vs integer reference: {n}/{n}")


def main() -> None:
    args = cnn_args("resnet8 served on the port's cuda backend")
    device = resolve_device(args.device)

    print("calibrating weight scales + requant shifts, compiling the "
          "resnet8 DAG...")
    t0 = time.perf_counter()
    net, graph = compile_resnet8()
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

    serve_and_check(net, request_images(args.requests),
                    lambda img: reference_forward_int8(graph, img),
                    args.batch, device)


if __name__ == "__main__":
    main()
