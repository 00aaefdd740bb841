#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written ``vta_gemm`` kernel from
   ``src/repro_torch/kernels/csrc/vta_gemm.cu`` with ``nvcc`` and prints
   the build time and ptxas's register/shared-memory report;
3. holds the kernel against its plain torch version
   (``kernels/ref.vta_gemm_ref``) on the card, exact equality, over
   LeNet-5's five GEMM shapes at batch 32, the reference package's kernel
   test shapes, the epilogue grid relu × shift {0, 3, 8} × saturate ×
   {int8, int32} × bias/no bias, and a case whose A·B + bias crosses 2**31;
4. compiles LeNet-5 (random seeded weights, calibrated shifts) with the
   port's compiler and serves 64 seeded requests on the card — four
   batches of 8 and one of 32 — through ``NetworkProgram.serve``; every
   answer must be bit-exact against ``reference_forward_int8`` and the
   kernel launch counter must rise by exactly 5 per served batch;
5. times the kernel, its plain version and ``torch._int_mm`` (a yardstick
   only; the port never calls it) at LeNet-5's shapes — device time from
   CUDA-graph replay, and per-call time between CUDA events with the
   host's launch cost — computes each shape's bound (bytes over 3.35 TB/s
   or int8 operations over 1,979 TOP/s, whichever is larger) and prints
   one JSON line ``{"kernels": [...]}`` before the last line;
6. prints img/s for warmed batches of 8 and 32 (median of 20 serves) and a
   ``torch.profiler`` breakdown of one batch-32 serve: wall time, device
   busy time, idle share and the top device operations.

Any failure raises and exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The full record also goes to ``chiprun_out/chip_smoke.json``.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor cores
KERNEL_GRID = [(8, 128, 128), (100, 300, 200), (256, 256, 256),
               (1, 17, 5), (130, 200, 140), (512, 128, 384)]
BATCH_SIZES = [8, 8, 8, 8, 32]     # 64 requests


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: the host's launch cost included."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Device time per call of ``fn``: ``per_graph`` calls captured in one
    CUDA graph, replayed between CUDA events, so no host launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def bound(m: int, k: int, n: int, bias: bool, out_bytes: int):
    """Least time (ms) for the work: each input read once, each output
    written once, at the memory rate; or the int8 MACs at the peak rate."""
    nbytes = m * k + k * n + (4 * n if bias else 0) + m * n * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_mm_allowed(m: int, k: int, n: int) -> bool:
    """``torch._int_mm``'s CUDA shape rules: M > 16, K and N multiples
    of 8."""
    return m > 16 and k > 0 and k % 8 == 0 and n > 0 and n % 8 == 0


def check_kernel_grid(ops, ref, dev) -> int:
    """Phase 3: the kernel against its plain version, exact; returns the
    largest absolute difference seen (0 when all agree)."""
    rng = np.random.default_rng(2024)
    shapes = [(32 * 784, 32, 16), (32 * 112, 160, 16), (32, 400, 128),
              (32, 128, 96), (32, 96, 16)] + KERNEL_GRID + [(64, 96, 80)]
    worst = 0
    cases = 0
    for m, k, n in shapes:
        a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(
            np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(
            np.int8)).to(dev)
        bias = torch.from_numpy(rng.integers(-5000, 5000, (n,)).astype(
            np.int32)).to(dev)
        for use_bias in (False, True):
            for relu in (False, True):
                for shift in (0, 3, 8):
                    for saturate in (False, True):
                        for out_dtype in (torch.int8, torch.int32):
                            kw = dict(relu=relu, shift=shift,
                                      saturate=saturate, out_dtype=out_dtype)
                            bb = bias if use_bias else None
                            got = ops.vta_matmul(a, b, bb, **kw)
                            want = ref.vta_gemm_ref(a, b, bb, **kw)
                            diff = int((got.to(torch.int64)
                                        - want.to(torch.int64)).abs().max())
                            worst = max(worst, diff)
                            if not torch.equal(got, want):
                                raise AssertionError(
                                    f"vta_gemm != plain at {(m, k, n)} "
                                    f"bias={use_bias} {kw}: max |diff| "
                                    f"{diff}")
                            cases += 1
    # int32 wrap: A·B = 127·127·256 plus a bias near 2**31 crosses it
    a = torch.full((40, 256), 127, dtype=torch.int8, device=dev)
    b = torch.full((256, 24), 127, dtype=torch.int8, device=dev)
    bias = torch.tensor([2 ** 31 - 1000] * 12 + [-(2 ** 31) + 7] * 12,
                        dtype=torch.int32, device=dev)
    b[:, 12:] = -127
    got = ops.vta_matmul(a, b, bias, out_dtype=torch.int32)
    want = ref.vta_gemm_ref(a, b, bias, out_dtype=torch.int32)
    acc = 127 * 127 * 256
    expect = np.array([[((2 ** 31 - 1000 + acc) + 2 ** 31) % 2 ** 32 - 2 ** 31]
                       * 12 + [((-(2 ** 31) + 7 - acc) + 2 ** 31) % 2 ** 32
                               - 2 ** 31] * 12] * 40, dtype=np.int64)
    if not (torch.equal(got, want)
            and np.array_equal(got.cpu().numpy().astype(np.int64), expect)):
        raise AssertionError("int32 wrap case disagrees")
    cases += 1
    torch.cuda.synchronize()
    print(f"kernel grid: {cases} cases exact (max |diff| {worst})")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.cuda_backend import plan_cuda
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vta_gemm as kernel
    from repro_torch.lenet5_e2e import compile_lenet5, request_images
    from repro_torch.models.lenet import reference_forward_int8

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(card)
    record = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    so = kernel.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"built {so.name} in {record['build_s']:.2f}s")
    for line in kernel.build_log.splitlines():
        if "ptxas info" in line or "spill" in line:
            print("  " + line.strip())

    # -- 3. kernel vs plain ----------------------------------------------
    worst = check_kernel_grid(ops, ref, dev)

    # -- 4. main path: LeNet-5 served on the card -------------------------
    weights, net = compile_lenet5()
    shifts = [l.requant_shift for l in net.layers]
    plans = [plan_cuda(l.program) for l in net.layers]
    fused = [p.fused for p in plans]
    if fused != [False, False, True, True, True]:
        raise AssertionError(f"unexpected kernel modes per layer {fused}")
    images = request_images(sum(BATCH_SIZES))
    net.serve(images[:2], device=dev)           # upload the image, warm up
    torch.cuda.synchronize()

    ops.reset_launches()
    per_batch, times, outs = [], [], []
    lo = 0
    for bsz in BATCH_SIZES:
        before = ops.launches
        t0 = time.perf_counter()
        out, _ = net.serve(images[lo:lo + bsz], device=dev)
        times.append(time.perf_counter() - t0)
        per_batch.append(ops.launches - before)
        outs.append(out)
        lo += bsz
    launches = ops.launches
    if per_batch != [5] * len(BATCH_SIZES):
        raise AssertionError(f"kernel launches per batch {per_batch}, "
                             f"expected 5 each")
    logits = np.concatenate(outs)
    for r, img in enumerate(images):
        want, _ = reference_forward_int8(weights, img, shifts)
        if not np.array_equal(logits[r], want):
            raise AssertionError(f"request {r}: logits differ from the "
                                 f"integer reference")
    print(f"LeNet-5: {len(images)}/{len(images)} requests bit-exact; "
          f"kernel launches {launches} ({per_batch} per batch; layers "
          f"int32-out+TensorAlu {fused.count(False)}, fused int8 "
          f"{fused.count(True)})")

    # -- 5. kernel timings at LeNet-5's shapes, batch 32 -----------------
    rng = np.random.default_rng(5)
    shapes = []
    for layer, p in zip(net.layers, plans):
        mp, np_ = p.padded_shape
        m, k, n = 32 * mp, p.lam * p.block_size, np_
        a = torch.from_numpy(rng.integers(0, 128, (m, k)).astype(
            np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-16, 17, (k, n)).astype(
            np.int8)).to(dev)
        if p.fused:
            bias = torch.from_numpy(rng.integers(-64, 65, (n,)).astype(
                np.int32)).to(dev)
            kw = dict(relu=p.relu, shift=p.shift, saturate=False,
                      out_dtype=torch.int8)
        else:
            bias = None
            kw = dict(relu=False, shift=0, saturate=False,
                      out_dtype=torch.int32)
        got = ops.vta_matmul(a, b, bias, **kw)
        want = ref.vta_gemm_ref(a, b, bias, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"{layer.spec.name}: kernel != plain")
        kernel_fn = lambda: ops.vta_matmul(a, b, bias, **kw)
        plain_fn = lambda: ref.vta_gemm_ref(a, b, bias, **kw)
        lib_fn = ((lambda: torch._int_mm(a, b))
                  if int_mm_allowed(m, k, n) else None)
        t_bound, bound_by = bound(m, k, n, bias is not None,
                                  1 if kw["out_dtype"] == torch.int8 else 4)
        shapes.append({
            "layer": layer.spec.name, "m": m, "k": k, "n": n,
            "out": "int8" if p.fused else "int32", "bias": bias is not None,
            "kernel_ms": graph_ms(kernel_fn), "plain_ms": graph_ms(plain_fn),
            "library_ms": graph_ms(lib_fn) if lib_fn else None,
            "call_ms": cuda_ms(kernel_fn), "plain_call_ms": cuda_ms(plain_fn),
            "library_call_ms": cuda_ms(lib_fn) if lib_fn else None,
            "bound_ms": t_bound, "bound_by": bound_by})
    total = lambda key: (None if any(s[key] is None for s in shapes)
                         else sum(s[key] for s in shapes))
    entry = {
        "name": "vta_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/vta_gemm.cu",
        "replaces": "src/repro/kernels/vta_gemm.py:45",
        "launches": launches, "launches_per_batch": 5,
        "max_abs_err": worst, "max_abs_diff": worst,
        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("bytes" if all(s["bound_by"] == "bytes"
                                    for s in shapes) else "operations"),
        "library_ms": total("library_ms"),
        "call_ms": total("call_ms"), "plain_call_ms": total("plain_call_ms"),
        "library_call_ms": total("library_call_ms"),
        "per": ("one served batch of 32: the five LeNet-5 launches; ms = "
                "device time (CUDA-graph replay), call_ms = back-to-back "
                "calls between CUDA events, host launch cost included"),
        "shapes": shapes,
    }
    record["kernels"] = [entry]
    for row in shapes:
        lib = row["library_ms"]
        print(f"  {row['layer']:8s} {row['m']}x{row['k']}x{row['n']} "
              f"{row['out']}: kernel {row['kernel_ms'] * 1e3:.2f} us (per call "
              f"{row['call_ms'] * 1e3:.2f}), plain "
              f"{row['plain_ms'] * 1e3:.2f} us, _int_mm "
              + (f"{lib * 1e3:.2f} us" if lib is not None else "n/a")
              + f", bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")

    # -- 6. throughput and where a served batch's time goes --------------
    record["serve"] = {"main_path_batch_s": times}
    for bsz in (8, 32):
        batch = images[:bsz]
        net.serve(batch, device=dev)                # allocator warm at size
        reps = []
        for _ in range(20):
            t0 = time.perf_counter()
            net.serve(batch, device=dev)
            reps.append(time.perf_counter() - t0)
        med = sorted(reps)[len(reps) // 2]
        record["serve"][f"batch{bsz}"] = {"median_s": med, "runs_s": reps,
                                          "img_per_s": bsz / med}
        print(f"LeNet-5 serve batch {bsz}: median {med * 1e3:.2f} ms "
              f"= {bsz / med:.1f} img/s (host clock, 20 runs, each ends "
              f"in a device sync)")
    from torch.profiler import ProfilerActivity, profile
    batch = images[:32]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.serve(batch, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events (kernels, copies, fills) of the traced serve
    from torch.autograd import DeviceType
    per_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            count, us = per_name.get(evt.name, (0, 0.0))
            per_name[evt.name] = (count + 1, us + evt.time_range.elapsed_us())
    busy_us = sum(us for _, us in per_name.values())
    top = sorted(((k, c, t) for k, (c, t) in per_name.items()),
                 key=lambda r: -r[2])[:10]
    record["serve"]["profile_batch32"] = {
        "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
        "device_events": sum(c for c, _ in per_name.values()),
        "top_device": [{"name": k, "count": c, "device_us": t}
                       for k, c, t in top],
        "top_host": [{"name": e.key, "count": e.count,
                      "self_cpu_us": e.self_cpu_time_total}
                     for e in sorted(prof.key_averages(),
                                     key=lambda e: -e.self_cpu_time_total)
                     [:10]]}
    print(f"profiled batch-32 serve: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms in "
          f"{record['serve']['profile_batch32']['device_events']} device "
          f"events (idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f})")
    for k, c, t in top:
        print(f"  {t:10.1f} us  x{c:<4d} {k[:90]}")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": record["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
