"""LeNet-5 compiled to VTA programs and served on the device.

The port's counterpart of ``examples/lenet5_e2e.py``:

  1. compile all 5 layers into one shared DRAM allocation (Fig. 12), with
     static requant shifts calibrated over a held-out image set;
  2. serve seeded digit-classification requests in batches: one
     device-resident DRAM stack per batch, on the ``cuda`` backend one
     ``vta_gemm`` kernel launch per layer, on ``fast`` the batched
     instruction interpreter; ``--batch 1`` serves per image
     (``serve_one``, where ``oracle`` runs the per-struct interpreter);
  3. verify every answer bit-exactly against the integer reference and
     report agreement with the float model.

    PYTHONPATH=src python -m repro_torch.lenet5_e2e [--requests 32]
                                                    [--batch 8]
                                                    [--backend cuda|fast|oracle]
                                                    [--device cuda|cpu]

With no ``--device`` it runs on the CUDA card and fails if there is none;
``--device cpu`` runs on the host (the kernel's plain torch version on the
``cuda`` backend).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.cycle_model import FPGA_CLOCK_HZ
from repro_torch.core.network_compiler import compile_network
from repro_torch.device import resolve_device, strict_float32
from repro_torch.models.lenet import (LeNet5Float, calibrate_shifts,
                                      lenet5_random_weights, lenet5_specs,
                                      reference_forward_int8)


def compile_lenet5(seed: int = 0):
    """Random seeded weights, shifts calibrated on 8 held-out images
    (§4.2: everything is fixed at compile time), the compiled network."""
    weights = lenet5_random_weights(seed=seed)
    cal_rng = np.random.default_rng(7)
    cal = [cal_rng.integers(0, 128, (1, 1, 32, 32)).astype(np.int8)
           for _ in range(8)]
    shifts = calibrate_shifts(weights, cal)
    net = compile_network(lenet5_specs(weights, shifts),
                          np.zeros((1, 1, 32, 32), np.int8))
    return weights, net


def request_images(n: int, seed: int = 42) -> np.ndarray:
    """``n`` seeded (1, 1, 32, 32) int8 request images, stacked."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 128, (1, 1, 32, 32)).astype(np.int8)
                     for _ in range(n)])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8,
                    help="requests per served batch; 1 = serve per image "
                         "(default: 8)")
    ap.add_argument("--backend", choices=("cuda", "fast", "oracle"),
                    default="cuda",
                    help="the vta_gemm kernel, or the fast/oracle "
                         "interpreters (default: cuda)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args()
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    if args.batch > 1 and args.backend == "oracle":
        ap.error("--batch > 1 runs a batch engine; --backend oracle is "
                 "per-image only (use --batch 1)")
    device = resolve_device(args.device)

    print("compiling LeNet-5 through the VTA pipeline...")
    t0 = time.perf_counter()
    weights, net = compile_lenet5()
    print(f"  compiled in {time.perf_counter() - t0:.3f}s; "
          f"total GeMM loops = {net.gemm_loops()} (paper: 2942)")
    cr = net.cycle_report()
    print(f"  TensorGemm cycles = {cr.tensor_gemm_cycles} (paper: 2972); "
          f"exec = {cr.execution_time_s(FPGA_CLOCK_HZ) * 1e6:.2f} µs "
          f"@650 MHz (paper: 9.8 µs, leaner ALU schedule)")
    shifts = [l.requant_shift for l in net.layers]

    images = request_images(args.requests)
    if args.batch > 1:
        backend = "batched" if args.backend == "fast" else args.backend
        mode = f"batch {args.batch}, {backend}"
        serve = lambda group: list(net.serve(group, backend=backend,
                                             device=device)[0])
    else:
        mode = f"per-image, {args.backend}"
        serve = lambda group: [net.serve_one(group[0], backend=args.backend,
                                             device=device)]
    serve(images[:1])                               # warm-up: build, upload
    logits_all = []
    serve_s = 0.0
    for lo in range(0, len(images), args.batch):
        t0 = time.perf_counter()
        outs = serve(images[lo:lo + args.batch])
        serve_s += time.perf_counter() - t0
        logits_all.extend(outs)

    model = LeNet5Float(dataclasses.asdict(weights)).to(device)
    with torch.no_grad(), strict_float32():
        float_logits = model(torch.from_numpy(
            images.reshape(-1, 1, 32, 32).astype(np.float32)).to(
                device)).cpu().numpy()
    agree_float = 0
    for r, (img, logits) in enumerate(zip(images, logits_all)):
        ref_logits, _ = reference_forward_int8(weights, img, shifts)
        if not np.array_equal(logits, ref_logits):
            raise SystemExit(f"request {r}: mismatch against the integer "
                             f"reference")
        agree_float += int(np.argmax(logits) == np.argmax(float_logits[r]))
    if args.requests:
        print(f"\nserved {args.requests} requests in {serve_s:.4f}s "
              f"({args.requests / serve_s:.1f} img/s, {mode} "
              f"on {device}"
              + (f" [{torch.cuda.get_device_name(device)}]"
                 if device.type == "cuda" else "")
              + "; verification excluded)")
        print(f"bit-exact vs integer reference: "
              f"{args.requests}/{args.requests}")
        print(f"argmax agreement with float model: "
              f"{agree_float}/{args.requests}")


if __name__ == "__main__":
    main()
