"""Quantization front door end-to-end: float training → PTQ → accuracy.

The port's counterpart of ``examples/quantize_eval.py``, the one-command
version of EXPERIMENTS.md §Accuracy, on a torch device:

  1. train (or load from ``--checkpoint``) a float model on the
     procedural digit dataset on the device — hermetic, seeded, no network
     access;
  2. post-training-quantize it with :func:`repro_torch.quantize.
     quantize_network` (power-of-2 weight scales, biases at accumulator
     scale, the §4.2 activation-range scan under the device's requant
     semantics);
  3. serve the held-out test split through ``vta_gemm`` on the device and
     report int8 vs float top-1 — exiting non-zero if int8 drifts more
     than 2 points from float, or if the device's served logits differ
     from the plain version's on the spot-check images.

    PYTHONPATH=src python -m repro_torch.quantize_eval
        [--net lenet5|resnet8|both] [--train-n N] [--eval-n N]
        [--calib-n N] [--epochs N] [--batch N] [--seed N]
        [--checkpoint PATH.npz] [--device cuda|cpu]

Sizes default from the ``ACCURACY_*`` env vars (falling back to the
full-scale 4000-train / 2000-eval run).  ``--checkpoint`` loads an
existing ``.npz`` float checkpoint if present (one written by either
package) and saves the trained one otherwise; with ``--net both`` it is
used as a per-net suffix template.  With no ``--device`` it runs on the
CUDA card and fails if there is none; ``--device cpu`` trains and serves
on the host (the kernel's plain torch version).
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.device import resolve_device
from repro_torch.quantize import GATE_POINTS, evaluate_net


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="float front door -> PTQ -> dataset-scale accuracy")
    ap.add_argument("--net", choices=("lenet5", "resnet8", "both"),
                    default="both")
    ap.add_argument("--train-n", type=int,
                    default=_env_int("ACCURACY_TRAIN_N", 4000))
    ap.add_argument("--eval-n", type=int,
                    default=_env_int("ACCURACY_EVAL_N", 2000))
    ap.add_argument("--calib-n", type=int,
                    default=_env_int("ACCURACY_CALIB_N", 64))
    ap.add_argument("--epochs", type=int,
                    default=_env_int("ACCURACY_EPOCHS", 6))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz float checkpoint to load if present / "
                         "save after training")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    nets = ("lenet5", "resnet8") if args.net == "both" else (args.net,)
    print(f"net       float%   int8%    delta    {device.type}=cpu  "
          f"(train={args.train_n} eval={args.eval_n} "
          f"calib={args.calib_n} epochs={args.epochs})")
    failed = False
    for net in nets:
        ckpt = args.checkpoint
        if ckpt is not None and args.net == "both":
            root, ext = os.path.splitext(ckpt)
            ckpt = f"{root}.{net}{ext or '.npz'}"
        rec = evaluate_net(net, train_n=args.train_n, eval_n=args.eval_n,
                           calib_n=args.calib_n, epochs=args.epochs,
                           seed=args.seed, batch=args.batch,
                           checkpoint=ckpt, device=device)
        # gate the published (2-decimal) delta — a raw-float boundary
        # like 2.0000000000000018 must read as exactly 2.00 points
        gate = round(rec["delta_points"], 2) <= GATE_POINTS
        failed |= not gate
        agree = rec["device_vs_cpu_spotcheck_bit_identical"]
        print(f"{net:<10}{rec['float_top1'] * 100:6.2f}  "
              f"{rec['int8_top1'] * 100:6.2f}  "
              f"{rec['delta_points']:+6.2f}{'' if gate else ' *FAIL*'}  "
              f"{'bit-identical' if agree else 'MISMATCH'}")
        if not agree:
            failed = True
    if failed:
        print(f"accuracy gate FAILED (int8 must stay within "
              f"{GATE_POINTS} points of float, and the device's logits "
              f"must equal the plain version's)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
