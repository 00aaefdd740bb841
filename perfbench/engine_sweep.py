"""One sweep of resnet8 behind the port's serving engine, on the card: the
further cell ``resnet8.server`` that PERF.md keeps under Open questions,
measured once to find its knee.  No cell runs it.

    python3 perfbench/engine_sweep.py --rates 1000,4000,... [--seconds 5]
        [--seed 7] [--trace]

resnet8 as ``resnet8.offline`` builds it, behind ``VTAServingEngine`` with
``BatchPolicy(max_batch=256, max_wait_s=0.002, max_depth=16384)`` and one
``cuda`` worker.  At each rate, seeded Poisson arrivals of single images
are replayed on the wall clock for ``--seconds``; every latency is taken
from the request's due time.  One JSON line a rate: offered and completed
requests a second, p50, p95 and p99 from the due time, how late the
generator submitted (p99), rejections and mean batch.  The knee is the
highest rate that completed at least 97 % of its offered requests a second
with none rejected; ``--trace`` then replays one second at 0.8 × the knee
under the profiler and adds the device's idle share over it.
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def replay(engine, images, arrivals, clock):
    """Submit ``images[i % len]`` at ``t0 + arrivals[i]``; returns the due
    times, submit times, tickets and rejections."""
    from repro_torch.serving.vta import QueueFull
    t0 = clock.now()
    due, sent, tickets, rejected = [], [], [], 0
    for i, t in enumerate(arrivals):
        clock.sleep_until(t0 + t)
        due.append(t0 + t)
        sent.append(clock.now())
        try:
            tickets.append(engine.submit(images[i % len(images)]))
        except QueueFull:
            tickets.append(None)
            rejected += 1
    return due, sent, tickets, rejected


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench.lib import harness, manifest, seeds, trace, traffic
    from repro_torch.serving.vta import (BatchPolicy, VTAServingEngine,
                                         WallClock)

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    cell = manifest.load_cell("resnet8.offline", ROOT)
    cfg = cell.config
    net = cell.program().compile(cfg, seeds.weights(cfg, args.seed),
                                 traffic.calibration_images(cfg, args.seed))
    images = list(traffic.images(cfg, 4096, seeds.rng(
        args.seed, seeds.TRAFFIC))[:, None])        # (1, C, H, W) each
    policy = BatchPolicy(max_batch=256, max_wait_s=0.002, max_depth=16384)
    for size in net.padded_batch_sizes(policy.max_batch):
        net.serve(images[:size], device=dev)         # warm every rung
    rng = np.random.default_rng(args.seed)
    clock = WallClock()
    rates = [float(r) for r in args.rates.split(",")]
    knee = None
    for rate in rates + ([None] if args.trace else []):
        traced = rate is None
        if traced:
            if knee is None:
                break
            rate = 0.8 * knee
        n = int(rate * (1.0 if traced else args.seconds))
        arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
        engine = VTAServingEngine(net, policy=policy, backends=("cuda",),
                                  device=dev)
        box = {}

        def run(_=None):
            box["r"] = replay(engine, images, arrivals, clock)
            for t in box["r"][2]:
                if t is not None:
                    t.result(timeout=120)

        with engine:
            tr = trace.profile(run, 1) if traced else run()
        due, sent, tickets, rejected = box["r"]
        done = [(d, t.record) for d, t in zip(due, tickets) if t is not None]
        lat = [r.complete_t - d for d, r in done]
        span = max(r.complete_t for _, r in done) - due[0]
        row = {"rate": rate, "requests": n, "rejected": rejected,
               "completed_per_s": len(done) / span,
               "p50_ms": harness.nearest_rank(lat, 50) * 1e3,
               "p95_ms": harness.nearest_rank(lat, 95) * 1e3,
               "p99_ms": harness.nearest_rank(lat, 99) * 1e3,
               "generator_late_p99_ms": harness.nearest_rank(
                   [s - d for s, d in zip(sent, due)], 99) * 1e3,
               "mean_batch": float(np.mean([r.batch_size for _, r in done])),
               "device": torch.cuda.get_device_name(dev)}
        if not traced and not rejected \
                and row["completed_per_s"] >= 0.97 * rate:
            knee = max(knee or 0.0, rate)
        row["knee"] = knee
        if traced and tr["device"]:
            # the span covers the replay and the wait for its results
            lo, hi = trace.window(tr)
            row["idle_share_pct"] = 100 * (1 - trace.busy_us(tr) / (hi - lo))
        print(json.dumps(row), flush=True)
        time.sleep(0.5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
