"""A sweep of the rate offered to resnet8 behind the serving engine, on
the card, to find the knee that a server cell's rate is set from.  No cell
runs it.

    python3 perfbench/engine_sweep.py --rates 2000,4000,... [--seconds 5]
        [--seed 7]

resnet8 as ``resnet8.offline`` builds it, behind ``VTAServingEngine`` with
the policy, workers and pool of ``traffic/server_poisson.json``, its
ladder warmed as a run warms it.  At each rate, seeded Poisson arrivals
of single images come from the process of ``lib/traffic.py`` and are
submitted by the receiving thread of ``lib/harness.py``, as in a run of
the cell, for ``--seconds``; every latency is taken from the request's
due time.  One JSON line a rate: offered and completed requests a second,
p50, p95 and p99 from the due time, how late the generator sent (p50,
p99, most), rejections and mean batch.  The knee is the highest of the rates, taken in the order given,
that completed at least 97 % of its offered requests a second with none
rejected, where every rate before it did too: past capacity a queue that
grows through a short window can still complete 97 % of it.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench.lib import harness, manifest, seeds, traffic

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    pb = ROOT / "perfbench"
    cfg = manifest.load_json(pb / "configs" / "resnet8.json")
    mix = manifest.load_json(pb / "traffic" / "server_poisson.json")
    net = manifest.load_module(pb / "programs" / "resnet8.py").compile(
        cfg, seeds.weights(cfg, args.seed),
        traffic.calibration_images(cfg, args.seed))
    requests = harness.warm_ladder(
        net, traffic.pool(cfg, mix, args.seed)[0], mix, dev)
    knee, past = None, False
    for rate in [float(r) for r in args.rates.split(",")]:
        gen = traffic.Generator(rate, args.seed, args.seconds)
        try:
            loop = harness.OpenLoop(net, requests, mix, gen, dev)
            loop.start()
            loop.go()
            loop.wait_until(time.perf_counter() + args.seconds)
            rows = loop.finish(time.perf_counter() + harness.WAIT_S)
        finally:
            gen.close()
        ok = rows["state"] == 1
        lat = rows["complete"][ok] - rows["due"][ok]
        late = rows["sent"] - rows["due"]
        rejected = int((rows["state"] == 2).sum())
        row = {"rate": rate, "requests": len(ok), "rejected": rejected,
               "completed_per_s": ok.sum() / (rows["complete"][ok].max()
                                              - rows["due"][0]),
               "p50_ms": harness.nearest_rank(lat, 50) * 1e3,
               "p95_ms": harness.nearest_rank(lat, 95) * 1e3,
               "p99_ms": harness.nearest_rank(lat, 99) * 1e3,
               "generator_late_p50_ms": harness.nearest_rank(late, 50) * 1e3,
               "generator_late_p99_ms": harness.nearest_rank(late, 99) * 1e3,
               "generator_late_max_ms": float(late.max()) * 1e3,
               "mean_batch": float(rows["batch"][ok].mean()),
               "device": torch.cuda.get_device_name(dev)}
        past = past or rejected or row["completed_per_s"] < 0.97 * rate
        knee = knee if past else rate
        row["knee"] = knee
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
