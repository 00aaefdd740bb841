"""Train an LM with the full training substrate — microbatched AdamW,
checkpoint/restart, deterministic data, fault injection (port of the
reference's ``examples/train_lm.py``).

Default: lm100m at smoke width, which learns the synthetic Markov
stream; ``--full`` trains the real ~100M configuration (on the card).
Runs on the CUDA card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.train_lm [--steps 60] [--full]
    PYTHONPATH=src python -m repro_torch.train_lm --inject-failure
    PYTHONPATH=src python -m repro_torch.train_lm --device cpu
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.train import train
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--full", action="store_true",
                    help="the real ~100M config (card-sized)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--inject-failure", action="store_true",
                    help="kill the step halfway — the loop restarts from "
                         "the last checkpoint and converges identically")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("lm100m") if args.full else get_smoke("lm100m")
    tc = TrainConfig(
        microbatches=args.microbatches,
        opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=max(1, args.steps // 10),
                              total_steps=args.steps))
    fail_at = [args.steps // 2] if args.inject_failure else None

    report = train(cfg, steps=args.steps, global_batch=args.global_batch,
                   seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                   ckpt_every=max(1, args.steps // 5), train_cfg=tc,
                   fail_at=fail_at, device=device)

    hist = report.metrics_history
    first = next((m["loss"] for m in hist if "loss" in m), float("nan"))
    last = hist[-1]["loss"] if hist else float("nan")
    print(f"\nloss {first:.3f} → {last:.3f} over {report.final_step} steps "
          f"({report.restarts} restarts, "
          f"{report.straggler.slow_steps} straggler steps) on {device}")
    if not last < first:
        print("FAIL: training did not reduce the loss")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
