#!/usr/bin/env python3
"""Serve LeNet-5 on the card with the port of one checkout, for A/B runs.

    python3 tools/serve_ab.py [--src PATH] [--label NAME] [--out FILE]

Compiles LeNet-5 (random seed-0 weights, calibrated shifts) with the
``repro_torch`` package under ``--src`` (default: this checkout's
``src``), serves 64 seeded requests as ``chip_smoke.py`` phase 4 does
(every answer bit-exact against ``reference_forward_int8``), then times
and traces it with ``chip_smoke.serve_timing``: img/s at batches 8 and
32 (median of 20 warmed serves), and one traced batch-32 serve's device
busy time, idle share (over the traced wall and over the unprofiled
median) and device-to-host copies.  Prints the card's name and power
limit, and as its last line one JSON object; ``--out`` appends that
object to a file.

To compare two trees on one card, unpack the other one into a directory
that ``.gitignore`` lists and run both in one call, alternating:

    for t in A B B A; do python3 tools/serve_ab.py --src $t/src --label $t; done
"""

import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch, np = smoke.torch, smoke.np
    if not torch.cuda.is_available():
        print("serve_ab: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.lenet5_e2e import compile_lenet5, request_images
    from repro_torch.models.lenet import reference_forward_int8

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = smoke.card_line()
    print(card)
    weights, net = compile_lenet5()
    shifts = [l.requant_shift for l in net.layers]
    images = request_images(64)
    logits, _ = net.serve(images, device=dev)
    exact = sum(bool(np.array_equal(
        logits[r], reference_forward_int8(weights, img, shifts)[0]))
        for r, img in enumerate(images))
    if exact != len(images):
        raise AssertionError(f"{args.label}: bit-exact {exact}/{len(images)}")
    rec = smoke.serve_timing(net, images, dev, f"LeNet-5 ({args.label})")
    out = {"label": args.label, "src": str(src), "card": card,
           "bit_exact": f"{exact}/{len(images)}", **rec}
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    print(json.dumps({"label": args.label, "card": card,
                      "profile_batch32": rec["profile_batch32"]
                      | {"top_device": None, "top_host": None},
                      "batch32_median_s": rec["batch32"]["median_s"],
                      "batch8_median_s": rec["batch8"]["median_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
