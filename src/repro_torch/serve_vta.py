"""Async serving demo: a seeded request stream through the port's VTA
serving engine.

The port's counterpart of ``examples/serve_vta.py``:

  1. compile LeNet-5 through the VTA pipeline (compile-once);
  2. start the async engine — bounded request queue, max-batch/max-wait
     dynamic batch former, a pool of workers draining formed batches on
     one device, on the ``cuda`` kernel backend or the ``batched``
     interpreter (optionally through the integrity guards);
  3. replay a seeded Poisson arrival trace against it in real time;
  4. assert the serving contracts: every result bit-identical to a
     direct ``NetworkProgram.serve`` of the same images, and zero SLO
     accounting errors (``metrics.audit()`` empty);
  5. print the latency/throughput summary (p50/p95/p99, occupancy,
     SLO violations).

    PYTHONPATH=src python -m repro_torch.serve_vta [--requests 16]
        [--rate 200] [--max-batch 4] [--max-wait 0.005]
        [--backends cuda,cuda|batched,batched] [--slo 0.5] [--guard]
        [--device cuda|cpu]

It exits non-zero on any contract violation.  ``--guard`` serves through
the integrity guards (``repro_torch.harden``) and needs ``batched``
workers (``--backends batched[,batched]``); with ``cuda`` workers it exits
with the engine's typed refusal.  With no ``--device`` it runs on the CUDA
card and fails if there is none; ``--device cpu`` runs on the host (the
kernel's plain torch version for ``cuda`` workers).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core.errors import CompileError
from repro_torch.core.network_compiler import compile_network
from repro_torch.device import resolve_device
from repro_torch.models.lenet import (lenet5_random_weights, lenet5_specs,
                                      synthetic_digit)
from repro_torch.serving.vta import (BatchPolicy, QueueFull, VTAServingEngine,
                                     WallClock, poisson_arrival_times,
                                     request_images)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="offered load in requests/second (Poisson)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait", type=float, default=0.005)
    ap.add_argument("--backends", default="cuda,cuda",
                    help="comma-separated worker backends (cuda|batched), "
                         "one worker per entry")
    ap.add_argument("--slo", type=float, default=0.5,
                    help="per-request latency SLO in seconds")
    ap.add_argument("--guard", action="store_true",
                    help="serve through the integrity guards (batched "
                         "workers only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args()
    device = resolve_device(args.device)

    print("compiling LeNet-5 through the VTA pipeline...")
    net = compile_network(lenet5_specs(lenet5_random_weights(0)),
                          synthetic_digit(0))
    print(f"  plan shapes: {[s['inp_nbytes'] for s in net.plan_shapes()]} "
          f"INP bytes/layer; padded batch ladder = "
          f"{net.padded_batch_sizes(args.max_batch)}")

    backends = tuple(args.backends.split(","))
    policy = BatchPolicy(max_batch=args.max_batch,
                         max_wait_s=args.max_wait,
                         max_depth=max(64, 4 * args.requests))
    guard = None
    if args.guard:
        from repro_torch.harden import GuardPolicy
        guard = GuardPolicy()

    try:
        engine = VTAServingEngine(net, policy=policy, backends=backends,
                                  device=device, guard=guard,
                                  slo_s=args.slo)
    except CompileError as exc:
        print(f"refused: {exc}", file=sys.stderr)
        sys.exit(2)

    images = request_images(net, args.requests, seed=args.seed + 1)
    arrivals = poisson_arrival_times(args.rate, args.requests,
                                     seed=args.seed)
    clock = WallClock()
    tickets = []
    with engine:                       # start; drain + shutdown on exit
        t0 = clock.now()
        for img, t_rel in zip(images, arrivals):
            clock.sleep_until(t0 + t_rel)     # replay the seeded trace
            try:
                tickets.append(engine.submit(img))
            except QueueFull as exc:
                print(f"  backpressure: {exc}", file=sys.stderr)
                raise
        outs = [t.result(timeout=120.0) for t in tickets]

    # contract 1: bit-identity vs the direct compile-once serve path
    direct, _ = net.serve(images, device=device)
    mismatches = sum(1 for got, want in zip(outs, direct)
                     if not np.array_equal(got, want))
    # contract 2: zero SLO accounting errors after drain
    audit = engine.metrics.audit()
    summary = engine.metrics.summary()

    print(f"\nserved {summary['completed']:.0f}/{args.requests} requests "
          f"on {backends} workers, device {device} "
          f"(guarded={bool(guard)})")
    print(f"  p50/p95/p99 latency = {summary['p50_ms']:.2f}/"
          f"{summary['p95_ms']:.2f}/{summary['p99_ms']:.2f} ms; "
          f"throughput = {summary['throughput_rps']:.1f} rps")
    print(f"  mean batch occupancy = {summary['mean_batch_occupancy']:.2f}"
          f" (padded {summary['mean_padded_size']:.2f}); "
          f"SLO({args.slo * 1e3:.0f}ms) violations = "
          f"{summary['slo_violations']:.0f}")
    print(f"  bit-identical to direct serve: "
          f"{args.requests - mismatches}/{args.requests}")
    print(f"  accounting audit: "
          f"{'clean' if not audit else audit}")
    if args.guard:
        outcomes = [t.guard_report.outcome for t in tickets]
        print(f"  guard outcomes: "
              f"{ {o: outcomes.count(o) for o in set(outcomes)} }")

    if mismatches or audit or summary["completed"] != args.requests:
        print("SERVING CONTRACT VIOLATION", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
