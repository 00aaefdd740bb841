#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels, ``vta_gemm`` and ``flash_attention``
   (``flash_attention.cu`` for float32, ``flash_attention_bf16.cu`` for
   bf16), from ``src/repro_torch/kernels/csrc/`` with ``nvcc`` (the three
   builds run at once) and prints the build times, ptxas's register,
   shared-memory and spill lines for every instantiation as nvcc wrote
   them, one line per ``vta_gemm`` instantiation (registers, spills: any
   spill fails; the float32 attention library's lines are parsed per
   instantiation too, and must match ``flash_attention.F32_INSTANTIATIONS``
   with no spill), and, where ``cuobjdump`` is found, the count of ``IMMA``
   (int8 ``mma.sync``) instructions in ``vta_gemm``'s SASS, of ``HMMA``
   (TF32 ``mma.sync``) in the float32 attention library's (``sass_f32``,
   must be > 0) and whether the bf16 library's SASS holds ``HGMMA``
   (``wgmma``) instructions;
3. holds ``vta_gemm`` against its plain torch version
   (``kernels/ref.vta_gemm_ref``) on the card, exact equality, over
   LeNet-5's five GEMM shapes at batch 32, the reference package's kernel
   test shapes, the epilogue grid relu × shift {0, 3, 8} × saturate ×
   {int8, int32} × bias/no bias, a case whose A·B + bias crosses 2**31,
   the accumulator wrap case (M = 32, K = 139,264, N = 16, A = B = -128:
   A·B wraps past 2**31, int32 and truncating int8 out, through the
   wrapper's plan and with one warp summing all of K), every instantiation
   of ``vta_gemm.INSTANTIATIONS`` forced at a shape that fits it, and
   operands at an odd address (the bytes path);
4. compiles LeNet-5 (random seeded weights, calibrated shifts) with the
   port's compiler and serves 64 seeded requests on the card — four
   batches of 8 and one of 32 — through ``NetworkProgram.serve``; every
   answer must be bit-exact against ``reference_forward_int8`` and the
   kernel launch counter must rise by exactly 5 per served batch;
4b. compiles resnet8 and resnet_tiny (through the graph front end) and the
   CIFAR CNN with the port's compiler at full width (random seeded
   weights, calibrated shifts) and serves each on the card in a batch of 8
   and one of 32 through ``NetworkProgram.serve``, the launch counters set
   to 0 just before and read just after: every answer bit-exact against
   the model's ``reference_forward_int8``, counted N/N, and the kernel
   launch counter rising by exactly the layer count per batch (11, 7, 5);
5. prints ``vta_gemm.plan``'s geometry and times the kernel, its plain
   version and ``torch._int_mm`` (a yardstick only; the port never calls
   it) at LeNet-5's shapes and at the GEMM shapes of resnet8, the CIFAR
   CNN and resnet_tiny at batch 32 (``RESNET8_GEMMS``, ``CIFAR_CNN_GEMMS``,
   ``RESNET_TINY_GEMMS``, the reference compiler's) — device time from
   CUDA-graph replay, and per-call time between CUDA events with the
   host's launch cost — and computes each shape's bound (bytes over
   3.35 TB/s or int8 operations over 1,979 TOP/s, whichever is larger);
   then times, at LeNet-5's and resnet8's shapes, the plan's geometry
   against the rule it was tuned from (``starting_rule``) and, where it
   splits K, the same tile unsplit, in alternating rounds;
6. prints, for resnet8 and then LeNet-5, img/s for warmed batches of 8
   and 32 (median of 20 serves) and a ``torch.profiler`` breakdown of one
   batch-32 serve: wall time, device busy time, idle share (over the
   traced wall and over the unprofiled median, since the profiler
   stretches the serve it traces), device-to-host copies and the top
   device operations;
6b. drives the async serving engine (``repro_torch.serving.vta``) on the
   card for LeNet-5 and resnet8 with ``BatchPolicy(max_batch=32,
   max_wait_s=0.002, max_depth=1024)``: serves every padding-ladder rung
   twice (the first-use cost of a rung), replays an unmeasured warm-up
   trace, then ``serve_all`` of 512 seeded requests with one and with two
   ``cuda`` workers (img/s beside phase 6's direct batch-32 img/s) and a
   seeded Poisson trace of 512 requests at half that direct rate, with one
   and two workers (p50/p95/p99 latency, mean formed and padded batch,
   violations of a 50 ms SLO).  Each run sets the launch counters to 0
   just before and reads them just after: every answer bit-exact against
   a direct serve and the integer reference (N/N), ``metrics.audit()``
   empty, and ``vta_gemm``'s counter equal to the layer count (5, 11)
   times the batches the run executed.  Then ``calibrate_service_model``
   on the card at batch 32 and ``simulate`` of the same trace with it,
   its p50/p99 beside the engine's;
7. holds ``flash_attention`` against its plain version
   (``kernels/ref.attention_ref``) on the card over a grid: the reference's
   kernel test shapes, causal and not, window, ``q_offset``, ragged
   non-causal lengths, every head dim (16–256, 192 included), ``Sq = 1``,
   rows that keep no key, and cases that reach each bf16 path (``wgmma`` tiles, tiles
   with a split KV range, the split-KV decode path at every head dim) and
   both sides of the split path's threshold, in float32 (atol = rtol = 2e-5) and bfloat16 (compared in
   bf16: atol = 4e-3 and rtol = 2**-7, one bf16 ulp relative, and at most
   5 % of the elements may differ from the plain version's bf16 value);
8. drives the attention op ``ops.attention`` once at each of eight
   full-width head geometries of ``src/repro/configs/`` (qwen2.5-3b
   prefill, chunked prefill and decode; a gemma3-1b local layer; whisper-base
   cross-attention; lm100m; nemotron-4-340b prefill and decode, D = 192),
   with the launch counters set to 0 just before
   and read just after, and holds every output against the plain version;
   the launch counter — the kernels the C entry points report they
   launched — must rise by each call's planned launches (2 where a
   combine kernel follows a split); then shows that the bf16 check refuses
   three faults a kernel could have, at the qwen2.5-3b decode case: the
   output rounded toward zero, the last 32 keys dropped, and P rounded to
   bf16 before P·V (``ref.attention_rounded_p``); and that the float32
   check (2e-5) refuses one TF32 product per score at the whisper-base
   case (``ref.attention_tf32_ref(terms=1)``) and passes the kernel's
   three (``terms=3``);
9. times the kernel, its plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only; with
   ``is_causal`` where that is the same function, else with the boolean
   mask of ``ref.attention_mask``) at those eight cases, each over the same
   window of 200 calls (``ATTN_WINDOW``), and computes each case's bound
   (bytes over 3.35 TB/s, or 4·D operations per kept query-key pair at
   the card's peak for the dtype, whichever is larger: 989 TFLOP/s on the
   bf16 tensor cores; for float32 the faster of 67 TFLOP/s on the CUDA
   cores and three TF32 products on the tensor cores at 495 TFLOP/s, the
   kernel's scheme, with the CUDA-core figure kept beside it), with each
   case's path, grid blocks, splits and launches; at
   the two float32 cases SDPA under each backend alone (efficient, math,
   cuDNN), with each backend's max |diff| and the backend the
   default call takes (its device kernels), the library time being the
   fastest backend within 2e-5; times the KV split against another split
   count, in alternating pairs, where the plan splits (the chunked
   prefill, 5 splits against 1; whisper-base, float32, the plan's against
   1) and where it does not (gemma3's local layer, 1 against 2);
10. drives the float front door (``repro_torch.quantize``) for LeNet-5 and
   then resnet8 at the reference's full scale (``FRONT_DOOR``: train 4000,
   eval 2000, calib 64, 6 epochs, batch 64, seed 0; 372 Adam steps a net):
   draws the digit splits, trains the float net on the card
   (``train_float``, TF32 off), measures float top-1 on the card, holds
   the float forward on the card against the CPU's on 64 test images
   (atol = rtol = 1e-4), quantises (``quantize_network``, margin 0),
   compiles, holds the card's int8 logits on the first 64 test images
   against the ``device="cpu"`` serve's (bit for bit), then serves the
   2000-image test split through ``int8_top1`` on the card with the launch
   counters set to 0 just before and read just after (launches = layers ×
   32 stacks); prints the seconds of each step, each epoch's mean loss,
   float and int8 top-1, the delta and eval img/s, with the JAX package's
   recorded CPU figures beside them; fails unless the delta is within 2.00
   points and float top-1 within 2 points of the JAX package's figure;
   trains LeNet-5 a second time from the same seed and reports whether the
   parameters are bit-identical; and times the kernel, its plain version
   and ``torch._int_mm`` at each net's GEMM shapes for a stack of 64;
11. runs the GQA projection (64×96×64) of ``repro_torch.vta_lm_projection``
   on the VTA functional simulator (the oracle, ``run_program``), on
   ``vta_gemm`` on the card (one launch, counted as in phase 10) and on the
   plain version, byte for byte, and three more ``compile_matmul`` GEMMs
   (K = 75 and 200, not multiples of 16; K = 64 with shift 0) on the
   oracle, the kernel and the plain version with truncating int8,
   saturating int8 and int32 out;
12. serves LeNet-5, resnet8, resnet_tiny and the CIFAR CNN on the torch
   instruction interpreters on the card (``repro_torch.core.fast_simulator``):
   ``serve(backend="batched")`` at batches 8 and 32 and
   ``serve_one(backend="fast")`` for 4 images, every answer equal to the
   ``cuda`` backend's (its launches counted: layers per serve) and to the
   integer reference, with no ``vta_gemm`` launch from the interpreters;
   prints img/s of both backends (median of 5 rounds of warmed serves
   taken in turns, host clock), and per batch-32 interpreter serve the kernels the host launched, the
   device's kernels and busy time, the copies each way and the
   interpreter's device-to-host reads;
13. serves LeNet-5 and resnet8 at batch 32 through
   ``serve(backend="batched", guard=GuardPolicy(dual_execute=True))``:
   every report ``clean``, the outputs the ``cuda`` backend's, the shadow
   exactly ``layers`` ``vta_gemm`` launches; times plain, guarded and
   guarded-with-dual batched serves in turns (the overhead in %, median
   of 9 rounds); then drives the
   serving engine with ``backends=("batched",)`` and ``guard=GuardPolicy()``
   over 128 requests: all bit-identical to a direct serve, every guard
   report clean, the audit clean;
14. runs the reference's seeded SEU campaign (``benchmarks/
   fault_campaign.py``'s arms, seed 2026) on the card: LeNet-5 with 200
   injections a class guarded (dual execution against the oracle for
   ``sram``) and 25 unguarded must reproduce the JAX package's counts
   (``LENET_CAMPAIGN``: 1,000 recovered, ``sram`` 30 recovered and 170
   masked, 54/150 silent corruptions unguarded); resnet8 with 10 a class
   guarded (the fast shadow) and 5 unguarded must show no guarded silent
   corruption and the same per-injection outcomes as the same campaign
   on ``device="cpu"``; prints each arm's seconds.

It then prints one JSON line ``{"kernels": [...]}`` (both kernels) before
the last line.  Any failure raises and exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The full record also goes to ``chiprun_out/chip_smoke.json``.
"""

import dataclasses
import functools
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor cores
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12            # H100 SXM dense TF32 tensor cores
KERNEL_GRID = [(8, 128, 128), (100, 300, 200), (256, 256, 256),
               (1, 17, 5), (130, 200, 140), (512, 128, 384)]
BATCH_SIZES = [8, 8, 8, 8, 32]     # 64 requests
# resnet8's GEMMs at batch 32, (layer, M, K, N, out): what the reference
# compiler gives through plan_pallas (tests/test_torch_vta_gemm_plan.py).
RESNET8_GEMMS = [("stem", 32768, 32, 16, "int8"),
                 ("b1a", 32768, 144, 16, "int8"),
                 ("b1b", 32768, 144, 16, "int32"),
                 ("t2a", 8192, 144, 32, "int8"),
                 ("t2p", 8192, 64, 32, "int8"),
                 ("t2b", 8192, 288, 32, "int32"),
                 ("t3a", 2048, 288, 64, "int8"),
                 ("t3p", 2048, 128, 64, "int8"),
                 ("t3b", 2048, 576, 64, "int32"),
                 ("head", 2048, 64, 64, "int32"),
                 ("fc", 32, 64, 16, "int8")]
# the CIFAR CNN's and resnet_tiny's, taken the same way
CIFAR_CNN_GEMMS = [("c1_conv", 32768, 80, 64, "int32"),
                   ("c2_conv", 8192, 576, 32, "int32"),
                   ("c3_conv", 2048, 288, 64, "int32"),
                   ("f4_fc", 32, 1024, 128, "int8"),
                   ("f5_fc", 32, 128, 16, "int8")]
RESNET_TINY_GEMMS = [("stem", 32768, 32, 16, "int32"),
                     ("b1a", 8192, 144, 16, "int8"),
                     ("b1b", 8192, 144, 16, "int32"),
                     ("mid", 8192, 144, 32, "int32"),
                     ("b2a", 2048, 288, 32, "int8"),
                     ("b2b", 2048, 288, 32, "int32"),
                     ("head", 32, 2048, 16, "int8")]
CNN_BATCHES = (8, 32)              # phase 4b: a batch of each a model
WRAP_K = 139_264                   # 32 · 16384 · K crosses 2**31
ATTN_WINDOW = (20, 10)             # phase 9: 20 calls a graph, 10 replays


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


def time_gemm(ops, ref, kernel, sms, rng, layer, m, k, n, kw, dev) -> dict:
    """Phase 5: one GEMM shape, int8 out with a bias or int32 out without:
    the kernel held against the plain version, then device time (CUDA-graph
    replay) and per-call time of the kernel, the plain version and
    ``torch._int_mm`` (A·B alone), its bound and ``vta_gemm.plan``'s
    geometry."""
    a = torch.from_numpy(rng.integers(0, 128, (m, k)).astype(np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-16, 17, (k, n)).astype(np.int8)).to(
        dev)
    int8_out = kw["out_dtype"] == torch.int8
    bias = (torch.from_numpy(rng.integers(-64, 65, (n,)).astype(np.int32))
            .to(dev) if int8_out else None)
    if not torch.equal(ops.vta_matmul(a, b, bias, **kw),
                       ref.vta_gemm_ref(a, b, bias, **kw)):
        raise AssertionError(f"{layer}: kernel != plain")
    kernel_fn = lambda: ops.vta_matmul(a, b, bias, **kw)
    plain_fn = lambda: ref.vta_gemm_ref(a, b, bias, **kw)
    lib_fn = ((lambda: torch._int_mm(a, b)) if int_mm_allowed(m, k, n)
              else None)
    t_bound, bound_by = bound(m, k, n, bias is not None, 1 if int8_out else 4)
    p = kernel.plan(m, k, n, out_dtype=kw["out_dtype"], sm_count=sms)
    return {
        "layer": layer, "m": m, "k": k, "n": n,
        "out": "int8" if int8_out else "int32", "bias": bias is not None,
        "kernel_ms": graph_ms(kernel_fn), "plain_ms": graph_ms(plain_fn),
        "library_ms": graph_ms(lib_fn) if lib_fn else None,
        "call_ms": cuda_ms(kernel_fn), "plain_call_ms": cuda_ms(plain_fn),
        "library_call_ms": cuda_ms(lib_fn) if lib_fn else None,
        "bound_ms": t_bound, "bound_by": bound_by,
        "plan": {"bm": p.bm, "bn": p.bn, "k_split": p.k_split, "bk": p.bk,
                 "stages": p.stages, "load": p.load, "blocks": p.blocks,
                 "warps": p.warps, "smem_bytes": p.smem_bytes}}


def starting_rule(m: int, k: int, n: int, sms: int):
    """(bm, bn, k_split) by the rule ``vta_gemm.plan`` was tuned from: bn
    the smallest tile covering N up to 64; bm the largest whose grid fills
    a wave, else 16; under half a wave, K split over the most warps (up to
    8) that each get a 32-byte step."""
    bn = next((b for b in (16, 32, 64) if b >= n), 64)
    gy = -(-n // bn)
    bm = next((b for b in (128, 64, 32, 16) if -(-m // b) * gy >= sms), 16)
    ks = 1
    if 2 * -(-m // bm) * gy < sms:
        ks = max(s for s in (1, 2, 4, 8) if s <= max(1, -(-k // 32)))
    return bm, bn, ks


def plan_ab(kernel, ref, sms, rng, rows, dev, pairs: int = 3) -> dict:
    """Device time of ``vta_gemm.plan``'s geometry against the starting
    rule's and, where the plan splits K, the same tile unsplit, in
    ``pairs`` alternating rounds at each shape of ``rows`` (phase 5's
    records); each arm is first held against the plain version."""
    out = {}
    for row in rows:
        m, k, n = row["m"], row["k"], row["n"]
        odt = torch.int8 if row["out"] == "int8" else torch.int32
        a = torch.from_numpy(rng.integers(0, 128, (m, k)).astype(np.int8)).to(
            dev)
        b = torch.from_numpy(rng.integers(-16, 17, (k, n)).astype(np.int8)).to(
            dev)
        chosen = kernel.plan(m, k, n, out_dtype=odt, sm_count=sms)
        geoms = {"plan": (chosen.bm, chosen.bn, chosen.k_split),
                 "starting rule": starting_rule(m, k, n, sms)}
        if chosen.k_split > 1:
            geoms["unsplit"] = (chosen.bm, chosen.bn, 1)
        want = ref.vta_gemm_ref(a, b, out_dtype=odt, saturate=False)
        arms = {}
        for name, (bm, bn, ks) in geoms.items():
            p = kernel.make_plan(m, k, n, bm, bn, ks, chosen.load, odt)
            o = torch.empty((m, n), dtype=odt, device=dev)
            fn = functools.partial(kernel._launch, a, b, None, o, p,
                                   saturate=False)
            fn()
            if not torch.equal(o, want):
                raise AssertionError(f"{row['layer']} {name} {(bm, bn, ks)} "
                                     f"!= plain")
            arms[name] = (fn, [], (bm, bn, ks), p.blocks)
        order = list(arms)
        for i in range(pairs):
            for name in (order if i % 2 == 0 else order[::-1]):
                arms[name][1].append(graph_ms(arms[name][0]))
        out[row["layer"]] = {name: {"bm_bn_ksplit": list(g), "blocks": nb,
                                    "kernel_ms": ms}
                             for name, (_, ms, g, nb) in arms.items()}
        print(f"  A/B {row['layer']:7s} " + "; ".join(
            f"{name} {g[0]}x{g[1]} k_split {g[2]} ({nb} blocks) "
            f"{sorted(ms)[len(ms) // 2] * 1e3:.2f} us"
            for name, (_, ms, g, nb) in arms.items()))
    return out


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
    cases += check_accumulator_wrap(ops, ref, dev)
    cases += check_instantiations(ref, dev)
    # operands at an odd address: plan takes the bytes path
    buf = torch.from_numpy(rng.integers(-128, 128, 1 + 48 * 160 + 160 * 32)
                           .astype(np.int8)).to(dev)
    a = buf[1:1 + 48 * 160].view(48, 160)
    b = buf[1 + 48 * 160:].view(160, 32)
    for kw in (dict(relu=True, shift=5, saturate=False),
               dict(out_dtype=torch.int32)):
        if not torch.equal(ops.vta_matmul(a, b, **kw),
                           ref.vta_gemm_ref(a, b, **kw)):
            raise AssertionError(f"vta_gemm != plain at odd operand "
                                 f"addresses {kw}")
        cases += 1
    torch.cuda.synchronize()
    print(f"kernel grid: {cases} cases exact (max |diff| {worst})")
    return worst


def check_accumulator_wrap(ops, ref, dev) -> int:
    """M = 32, K = WRAP_K, N = 16, A = B = -128: A·B = 2,281,701,376 wraps
    to -2,013,265,920.  Through the wrapper (its plan splits K over 8
    warps) and with one warp summing all of K in the mma accumulator;
    int32 out and truncating int8 out.  Returns the cases."""
    from repro_torch.kernels import vta_gemm as vg
    m, k, n = 32, WRAP_K, 16
    a = torch.full((m, k), -128, dtype=torch.int8, device=dev)
    b = torch.full((k, n), -128, dtype=torch.int8, device=dev)
    one_warp = vg.make_plan(m, k, n, 16, 16, 1, "vec16")
    cases = 0
    for kw in (dict(out_dtype=torch.int32),
               dict(out_dtype=torch.int8, saturate=False)):
        want = ref.vta_gemm_ref(a, b, **kw)
        forced = torch.empty((m, n), dtype=kw["out_dtype"], device=dev)
        vg._launch(a, b, None, forced, one_warp,
                   saturate=kw.get("saturate", True))
        for name, got in (("plan", ops.vta_matmul(a, b, **kw)),
                          ("one warp", forced)):
            if not torch.equal(got, want):
                raise AssertionError(f"accumulator wrap case ({name}, {kw}) "
                                     f"!= plain")
            cases += 1
    if int(ref.vta_gemm_ref(a, b, out_dtype=torch.int32)[0, 0]) != (
            -2_013_265_920):
        raise AssertionError("the wrap case's plain value is not the wrapped "
                             "int32 sum")
    return cases


def check_instantiations(ref, dev) -> int:
    """Every (bm, bn, k_split, load) the library holds, forced at a shape
    that fits it (ragged M; ragged K and N on the bytes path), int8 out
    with bias, relu, shift and truncation, and int32 out; exact.  Returns
    the cases."""
    from repro_torch.kernels import vta_gemm as vg
    rng = np.random.default_rng(14)
    cases = 0
    for bm, bn, ks, load in vg.INSTANTIATIONS:
        m, n = 2 * bm + 3, 2 * bn - (5 if load == "bytes" else 0)
        k = 3 * 32 * ks + (7 if load == "bytes" else 16)
        a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(
            np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(
            np.int8)).to(dev)
        bias = torch.from_numpy(rng.integers(-5000, 5000, (n,)).astype(
            np.int32)).to(dev)
        p = vg.make_plan(m, k, n, bm, bn, ks, load)
        for out_dtype, bb, kw in (
                (torch.int8, bias, dict(relu=True, shift=3, saturate=False)),
                (torch.int32, None, {})):
            out = torch.empty((m, n), dtype=out_dtype, device=dev)
            vg._launch(a, b, bb, out, p, **kw)
            if not torch.equal(out, ref.vta_gemm_ref(a, b, bb, **kw,
                                                     out_dtype=out_dtype)):
                raise AssertionError(f"instantiation {(bm, bn, ks, load)} "
                                     f"!= plain at {(m, k, n)} {out_dtype}")
            cases += 1
    return cases


def compile_cnns() -> list:
    """resnet8, resnet_tiny and the CIFAR CNN compiled by the port at full
    width (random seeded weights, calibrated shifts): (name, net, seeded
    request images, reference(img) -> logits, layer count)."""
    from repro_torch.models import cifar_cnn, resnet8, resnet_tiny
    n = sum(CNN_BATCHES)
    r8, g8 = resnet8.compile_resnet8()
    rt, gt = resnet_tiny.compile_resnet_tiny()
    cw, cs, cn = cifar_cnn.compile_cifar_cnn()
    return [
        ("resnet8", r8,
         np.stack([resnet8.synthetic_image(100 + r) for r in range(n)]),
         lambda img: resnet8.reference_forward_int8(g8, img), 11),
        ("resnet_tiny", rt,
         np.stack([resnet_tiny.synthetic_image(100 + r) for r in range(n)]),
         lambda img: resnet_tiny.reference_forward_int8(gt, img), 7),
        ("cifar_cnn", cn,
         np.stack([cifar_cnn.synthetic_cifar_image(100 + r)
                   for r in range(n)]),
         lambda img: cifar_cnn.reference_forward_int8(cw, img, cs)[0], 5),
    ]


def serve_cnns(ops, cnns, dev) -> dict:
    """Phase 4b: each CNN of ``compile_cnns`` served on the card through
    ``NetworkProgram.serve`` in batches of ``CNN_BATCHES``, the launch
    counters set to 0 just before and read just after.  Every answer must
    be bit-exact against the model's integer reference, and ``vta_gemm``'s
    counter must rise by exactly the layer count per batch (no attention
    launch).  Returns the record, with the total launches."""
    for _, net, images, _, _ in cnns:
        net.serve(images[:2], device=dev)       # upload the image, warm up
    torch.cuda.synchronize()
    ops.reset_launches()
    served = []
    for name, net, images, _, layers in cnns:
        per_batch, outs, lo = [], [], 0
        for bsz in CNN_BATCHES:
            before = ops.launches
            out, _ = net.serve(images[lo:lo + bsz], device=dev)
            per_batch.append(ops.launches - before)
            outs.append(out)
            lo += bsz
        served.append((name, per_batch, np.concatenate(outs)))
    launches, attn = ops.launches, ops.attention_launches
    record = {"launches": launches, "models": {}}
    for (name, net, images, reference, layers), (_, per_batch, logits) in \
            zip(cnns, served):
        if per_batch != [layers] * len(CNN_BATCHES) or attn:
            raise AssertionError(f"{name}: kernel launches per batch "
                                 f"{per_batch}, expected {layers} each; "
                                 f"attention launches {attn}, expected 0")
        for r, img in enumerate(images):
            if not np.array_equal(logits[r], reference(img)):
                raise AssertionError(f"{name} request {r}: logits differ "
                                     f"from the integer reference")
        if logits.shape != (len(images), 1, 10):
            raise AssertionError(f"{name}: logits of shape {logits.shape}")
        record["models"][name] = {
            "layers": layers, "batches": list(CNN_BATCHES),
            "launches_per_batch": per_batch,
            "bit_exact": f"{len(images)}/{len(images)}",
            "chunks_per_layer": net.chunks_per_layer(),
            "input_sources": net.input_sources,
            "residual_sources": net.residual_sources}
        print(f"{name}: {len(images)}/{len(images)} requests bit-exact "
              f"(batches {list(CNN_BATCHES)}); kernel launches {per_batch} "
              f"per batch ({layers} layers); chunks per layer "
              f"{net.chunks_per_layer()}")
    return record


def serve_timing(net, images, dev, title: str) -> dict:
    """Phase 6: img/s for warmed batches of 8 and 32 (median of 20 serves,
    host clock, each ending in the copy of the logits) and a
    ``torch.profiler`` breakdown of one batch-32 serve: wall time, device
    busy time, idle share (over the traced wall and over the unprofiled
    median), device-to-host copies and the top device and host
    operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rec = {}
    for bsz in (8, 32):
        batch = images[:bsz]
        net.serve(batch, device=dev)                # allocator warm at size
        reps = []
        for _ in range(20):
            t0 = time.perf_counter()
            net.serve(batch, device=dev)
            reps.append(time.perf_counter() - t0)
        med = sorted(reps)[len(reps) // 2]
        rec[f"batch{bsz}"] = {"median_s": med, "runs_s": reps,
                              "img_per_s": bsz / med}
        print(f"{title} serve batch {bsz}: median {med * 1e3:.2f} ms "
              f"= {bsz / med:.1f} img/s (host clock, 20 runs, each ends "
              f"in a device sync)")
    batch = images[:32]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.serve(batch, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events (kernels, copies, fills) of the traced serve
    per_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            count, us = per_name.get(evt.name, (0, 0.0))
            per_name[evt.name] = (count + 1, us + evt.time_range.elapsed_us())
    busy_us = sum(us for _, us in per_name.values())
    top = sorted(((k, c, t) for k, (c, t) in per_name.items()),
                 key=lambda r: -r[2])[:10]
    d2h = sum(c for k, (c, _) in per_name.items() if "DtoH" in k)
    # The profiler stretches the traced serve's wall time; its device busy
    # time over the unprofiled median reads the idle share of a plain serve.
    plain_ms = rec["batch32"]["median_s"] * 1e3
    rec["profile_batch32"] = prof_rec = {
        "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
        "unprofiled_median_ms": plain_ms,
        "idle_share_unprofiled": 1 - busy_us / 1e3 / plain_ms,
        "device_events": sum(c for c, _ in per_name.values()),
        "device_to_host_copies": d2h,
        "top_device": [{"name": k, "count": c, "device_us": t}
                       for k, c, t in top],
        "top_host": [{"name": e.key, "count": e.count,
                      "self_cpu_us": e.self_cpu_time_total}
                     for e in sorted(prof.key_averages(),
                                     key=lambda e: -e.self_cpu_time_total)
                     [:10]]}
    print(f"{title} profiled batch-32 serve: wall {wall * 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms in "
          f"{prof_rec['device_events']} device events (idle share "
          f"{prof_rec['idle_share']:.3f}; over the unprofiled median "
          f"{plain_ms:.2f} ms {prof_rec['idle_share_unprofiled']:.3f}), "
          f"{d2h} device-to-host copies")
    for k, c, t in top:
        print(f"  {t:10.1f} us  x{c:<4d} {k[:90]}")
    return rec


# -- the serving engine -----------------------------------------------------

ENGINE_POLICY = dict(max_batch=32, max_wait_s=0.002, max_depth=1024)
ENGINE_REQUESTS = 512
ENGINE_SLO_S = 0.05
ENGINE_LOAD = 0.5                  # the trace's rate over direct batch-32's


def _batches(tickets) -> list:
    """The executed batches of an engine run, one (formed, padded) pair
    each: a batch is a worker's dispatch."""
    seen = {}
    for t in tickets:
        r = t.record
        seen[(r.worker, r.dispatch_t)] = (r.batch_size, r.padded_size)
    return list(seen.values())


def _engine_run(ops, vta, net, images, dev, workers, layers, arrivals=None):
    """One measured engine run, the launch counters set to 0 just before it
    and read just after: ``serve_all`` of ``images`` (saturation) or, with
    ``arrivals``, their seeded trace replayed on the wall clock.  Fails
    unless the audit is clean, no request failed and ``vta_gemm`` launched
    exactly ``layers`` times per executed batch."""
    engine = vta.VTAServingEngine(
        net, policy=vta.BatchPolicy(**ENGINE_POLICY),
        backends=("cuda",) * workers, device=dev, slo_s=ENGINE_SLO_S)
    engine.start()                                   # warm-up probe serve
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        if arrivals is None:
            outs, tickets = vta.serve_all(engine, images)
        else:
            clock, tickets = vta.WallClock(), []
            start = clock.now()
            for img, t_rel in zip(images, arrivals):
                clock.sleep_until(start + t_rel)
                tickets.append(engine.submit(img))
            outs = np.stack([t.result(timeout=120.0) for t in tickets])
        wall = time.perf_counter() - t0
    finally:
        engine.shutdown()
    launches, attn = ops.launches, ops.attention_launches
    batches = _batches(tickets)
    audit = engine.metrics.audit()
    summary = engine.metrics.summary()
    if audit or summary["failed"] or summary["completed"] != len(images):
        raise AssertionError(f"engine run: audit {audit}, summary {summary}")
    if launches != layers * len(batches) or attn:
        raise AssertionError(f"engine run: {launches} kernel launches for "
                             f"{len(batches)} batches of {layers} layers; "
                             f"attention launches {attn}")
    return outs, {
        "workers": workers, "wall_s": wall,
        "img_per_s": len(images) / wall, "launches": launches,
        "batches": len(batches),
        "mean_formed_batch": sum(b for b, _ in batches) / len(batches),
        "mean_padded_batch": sum(p for _, p in batches) / len(batches),
        "summary": summary, "audit": audit}


def engine_phase(ops, name, net, layers, reference, direct_img_s, dev):
    """Phase 6b: the async serving engine on the card, one model.

    With ``BatchPolicy(max_batch=32, max_wait_s=0.002, max_depth=1024)``:
    every ladder rung served twice first (its first-use cost: the rung's
    ``vta_gemm.plan`` entries and the allocator's growth), an unmeasured
    warm-up trace, then ``serve_all`` of 512 seeded requests with one and
    with two ``cuda`` workers (saturation), and a seeded Poisson trace of
    512 requests at half of phase 6's direct batch-32 rate with one and
    two workers.  Every answer is held bit-exactly against a direct serve
    and the integer reference; ``calibrate_service_model`` fits the
    card's service model, and ``simulate`` replays the same trace with it
    beside the engine's latencies."""
    from repro_torch.serving import vta
    images = vta.request_images(net, ENGINE_REQUESTS, seed=17)
    stacked = np.stack(images)
    direct = np.concatenate([net.serve(stacked[lo:lo + 32], device=dev)[0]
                             for lo in range(0, len(images), 32)])
    for r, img in enumerate(images):
        if not np.array_equal(direct[r], reference(img)):
            raise AssertionError(f"{name} engine request {r}: direct serve "
                                 f"differs from the integer reference")
    rec = {"direct_batch32_img_per_s": direct_img_s, "first_use_ms": {}}
    for rung in net.padded_batch_sizes(ENGINE_POLICY["max_batch"]):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            net.serve(stacked[:rung], device=dev)
            times.append(time.perf_counter() - t0)
        rec["first_use_ms"][rung] = [t * 1e3 for t in times]
    rate = ENGINE_LOAD * direct_img_s
    arrivals = vta.poisson_arrival_times(rate, ENGINE_REQUESTS, seed=23)
    _engine_run(ops, vta, net, images[:128], dev, 2, layers,
                arrivals=arrivals[:128])             # warm-up trace
    runs = []
    for mode in ("saturation", "trace"):
        for workers in (1, 2):
            outs, run = _engine_run(
                ops, vta, net, images, dev, workers, layers,
                arrivals=arrivals if mode == "trace" else None)
            if not np.array_equal(outs, direct):
                bad = [r for r in range(len(images))
                       if not np.array_equal(outs[r], direct[r])]
                raise AssertionError(f"{name} engine {mode} x{workers}: "
                                     f"requests {bad[:8]} differ")
            run.update(mode=mode, bit_exact=f"{len(images)}/{len(images)}")
            runs.append(run)
            s = run["summary"]
            print(f"{name} engine {mode}, {workers} worker(s): "
                  f"{run['img_per_s']:.1f} img/s (direct batch 32 "
                  f"{direct_img_s:.1f}); p50/p95/p99 {s['p50_ms']:.2f}/"
                  f"{s['p95_ms']:.2f}/{s['p99_ms']:.2f} ms; {run['batches']} "
                  f"batches, mean formed {run['mean_formed_batch']:.2f}, "
                  f"padded {run['mean_padded_batch']:.2f}; SLO "
                  f"{ENGINE_SLO_S * 1e3:.0f} ms violations "
                  f"{s['slo_violations']}; {len(images)}/{len(images)} "
                  f"bit-exact; audit clean; {run['launches']} launches = "
                  f"{layers} x {run['batches']}")
    model = vta.calibrate_service_model(net, batch=32, device=dev)
    sims = {}
    for workers in (1, 2):
        sim = vta.simulate(vta.PoissonSource(rate, ENGINE_REQUESTS, seed=23),
                           vta.BatchPolicy(**ENGINE_POLICY), model,
                           workers=workers, slo_s=ENGINE_SLO_S)
        sims[workers] = sim.metrics.summary()
    print(f"{name} service model ({dev}): base {model.base_s * 1e3:.3f} ms + "
          f"{model.per_image_s * 1e3:.4f} ms/image; trace at "
          f"{rate:.0f} req/s simulated p50/p99 "
          + ", ".join(f"x{w} {sims[w]['p50_ms']:.2f}/{sims[w]['p99_ms']:.2f}"
                      for w in sims)
          + " ms against the engine's "
          + ", ".join(f"x{r['workers']} {r['summary']['p50_ms']:.2f}/"
                      f"{r['summary']['p99_ms']:.2f}"
                      for r in runs if r["mode"] == "trace") + " ms")
    print(f"{name} first use of each ladder rung (first / second serve, ms): "
          + ", ".join(f"{rung}: {a:.2f}/{b:.2f}"
                      for rung, (a, b) in rec["first_use_ms"].items()))
    rec.update(trace_rate_rps=rate, runs=runs,
               service_model={"base_s": model.base_s,
                              "per_image_s": model.per_image_s},
               simulated=sims,
               launches=sum(r["launches"] for r in runs))
    return rec


# -- flash_attention --------------------------------------------------------

# (b, h, hkv, sq, skv, d) of the reference's kernel tests
ATTN_CASES = [(1, 4, 4, 64, 64, 32), (2, 4, 2, 64, 64, 32),
              (1, 8, 1, 32, 32, 16), (1, 2, 2, 48, 96, 32)]
# (atol, rtol).  bf16: one bf16 ulp relative (2**-7) plus 4e-3 for outputs
# near 0, above the largest difference seen (0.0039, one ulp at 0.5-1).
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-3, 2.0 ** -7)}
# The kernel and the plain version both round a float32 result to bf16
# (round to nearest), so their bf16 values differ only where the two float32
# values straddle a rounding boundary; rounding toward zero would change
# about half of them.
BF16_MISMATCH_LIMIT = 0.05
# SDPA rounds p to bf16 before P·V: it is held to the reference's kernel-test
# tolerance, atol = rtol = 2e-2.
SDPA_TOL = (2e-2, 2e-2)
CONTROL_TILE = 32           # keys dropped: the float32 kernel's KV tile at
                            # D = 128, a quarter of the bf16 kernel's

# Full-width head geometries of src/repro/configs/ (the attention op has
# no weights: inputs are seeded normal draws).
ATTN_FULL = [
    dict(name="qwen2.5-3b prefill", config="qwen2_5_3b.py",
         shape=(1, 16, 2, 4096, 4096, 128), dtype=torch.bfloat16,
         causal=True, window=None, q_offset=0, sdpa_causal=True),
    dict(name="qwen2.5-3b chunked prefill", config="qwen2_5_3b.py",
         shape=(1, 16, 2, 512, 4096, 128), dtype=torch.bfloat16,
         causal=True, window=None, q_offset=3584, sdpa_causal=None),
    dict(name="qwen2.5-3b decode", config="qwen2_5_3b.py",
         shape=(8, 16, 2, 1, 4096, 128), dtype=torch.bfloat16,
         causal=True, window=None, q_offset=4095, sdpa_causal=False),
    dict(name="gemma3-1b local layer", config="gemma3_1b.py",
         shape=(1, 4, 1, 4096, 4096, 256), dtype=torch.bfloat16,
         causal=True, window=512, q_offset=0, sdpa_causal=None),
    dict(name="whisper-base cross-attention", config="whisper_base.py",
         shape=(1, 8, 8, 448, 1500, 64), dtype=torch.float32,
         causal=False, window=None, q_offset=0, sdpa_causal=False),
    dict(name="lm100m", config="lm100m.py",
         shape=(4, 10, 2, 1024, 1024, 64), dtype=torch.float32,
         causal=True, window=None, q_offset=0, sdpa_causal=True),
    dict(name="nemotron-4-340b prefill", config="nemotron_4_340b.py",
         shape=(1, 96, 8, 2048, 2048, 192), dtype=torch.bfloat16,
         causal=True, window=None, q_offset=0, sdpa_causal=True),
    dict(name="nemotron-4-340b decode", config="nemotron_4_340b.py",
         shape=(8, 96, 8, 1, 4096, 192), dtype=torch.bfloat16,
         causal=True, window=None, q_offset=4095, sdpa_causal=False),
]


def attention_inputs(rng, shape, dtype, dev):
    b, h, hkv, sq, skv, d = shape
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(dev, dtype) for s in ((b, h, sq, d), (b, hkv, skv, d),
                                           (b, hkv, skv, d)))


def attention_stats(got, want, tol=None) -> dict:
    """How two outputs of one dtype differ: the largest |got - want|, the
    count of elements with |got - want| > atol + rtol * |want| (``tol``,
    else ``ATTN_TOL`` of the dtype), and the share of elements whose value
    differs (bf16 compared as bf16 values)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    atol, rtol = tol or ATTN_TOL[want.dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "n_beyond": int((diff > atol + rtol * w.abs()).sum()),
            "mismatch_share": float((g != w).float().mean()),
            "finite": bool(torch.isfinite(g).all())}


def attention_err(got, want, tol=None) -> dict:
    """``attention_stats``, raising if an element is not finite or beyond
    the tolerance, or, for bf16 at ``ATTN_TOL``, if more than
    ``BF16_MISMATCH_LIMIT`` of the elements differ."""
    st = attention_stats(got, want, tol)
    atol, rtol = tol or ATTN_TOL[want.dtype]
    if not st["finite"]:
        raise AssertionError("non-finite output")
    if st["n_beyond"]:
        raise AssertionError(f"{st['n_beyond']} elements beyond atol "
                             f"{atol:.3g} + rtol {rtol:.3g}·|want| (max "
                             f"|diff| {st['max_abs_err']:.3g})")
    if (tol is None and want.dtype == torch.bfloat16
            and st["mismatch_share"] > BF16_MISMATCH_LIMIT):
        raise AssertionError(f"{st['mismatch_share']:.3f} of the bf16 values "
                             f"differ (limit {BF16_MISMATCH_LIMIT})")
    return st


def attention_grid():
    """Phase 7's cases: (shape, kwargs)."""
    cases = []
    for shape in ATTN_CASES:
        for causal in (True, False):
            sq, skv = shape[3], shape[4]
            off = skv - sq if causal and skv > sq else 0
            cases.append((shape, dict(causal=causal, q_offset=off)))
    cases += [
        ((1, 2, 2, 64, 64, 16), dict(causal=True, window=16)),
        ((1, 4, 1, 300, 300, 256), dict(causal=True, window=64)),
        ((1, 2, 2, 32, 64, 16), dict(causal=True, q_offset=32)),
        ((1, 16, 2, 100, 700, 128), dict(causal=True, q_offset=600)),
        ((1, 2, 2, 40, 40, 16), dict(causal=False)),
        ((1, 2, 2, 32, 40, 16), dict(causal=False)),
        ((1, 8, 8, 45, 150, 64), dict(causal=False)),
        ((8, 16, 2, 1, 333, 128), dict(causal=True, q_offset=332)),
        ((4, 4, 1, 1, 257, 256), dict(causal=True, q_offset=256)),
        ((1, 2, 2, 10, 10, 16), dict(causal=True, q_offset=-5)),
        ((1, 2, 2, 70, 90, 32), dict(causal=False, window=5)),
        # the bf16 paths: the split path's threshold (group x Sq = 16, 24),
        # a tiles grid small enough to split its KV range, window 9 and
        # q_offset < 0 on the split path, non-causal ragged at D = 256
        ((1, 8, 1, 2, 517, 128), dict(causal=True, q_offset=515)),
        ((1, 8, 1, 3, 517, 128), dict(causal=True, q_offset=514)),
        ((1, 2, 1, 300, 2000, 128), dict(causal=True, q_offset=1700)),
        ((2, 4, 4, 1, 300, 64), dict(causal=True, window=9, q_offset=299)),
        ((1, 8, 2, 4, 10, 32), dict(causal=True, q_offset=-2)),
        ((1, 4, 4, 3, 91, 256), dict(causal=False)),
    ]
    for d in (16, 32, 64, 128, 192, 256):
        cases += [((2, 4, 2, 70, 130, d), dict(causal=True, q_offset=60)),
                  ((2, 4, 2, 70, 130, d), dict(causal=False)),
                  ((1, 4, 1, 129, 129, d), dict(causal=True, window=33)),
                  ((2, 8, 2, 3, 1000, d), dict(causal=True, q_offset=997))]
    return cases


def check_attention_grid(ops, ref, plan, dev):
    """Phase 7: the kernel against its plain version over the grid;
    returns the largest |diff| per dtype, the largest share of bf16 values
    that differ, and the cases per path."""
    rng = np.random.default_rng(77)
    worst, share, paths = {}, {}, {}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        worst[dtype], share[dtype] = 0.0, 0.0
        for shape, kw in attention_grid():
            path = plan(*shape, dtype, **kw).path
            paths[path] = paths.get(path, 0) + 1
            q, k, v = attention_inputs(rng, shape, dtype, dev)
            got = ops.attention(q, k, v, **kw)
            want = ref.attention_ref(q, k, v, **kw)
            try:
                st = attention_err(got, want)
            except AssertionError as exc:
                raise AssertionError(f"flash_attention != plain at {shape} "
                                     f"{dtype} {kw} ({path}): {exc}") from None
            worst[dtype] = max(worst[dtype], st["max_abs_err"])
            share[dtype] = max(share[dtype], st["mismatch_share"])
            cases += 1
    torch.cuda.synchronize()
    print(f"attention grid: {cases} cases within tolerance (max |diff| "
          f"float32 {worst[torch.float32]:.3g}, bfloat16 "
          f"{worst[torch.bfloat16]:.3g}; largest share of bf16 values that "
          f"differ {share[torch.bfloat16]:.4f}; cases per path {paths})")
    return worst, share, paths


def tolerance_controls(ref, x, kw) -> dict:
    """The bf16 check must refuse three faults a kernel could have, made
    from the plain version at one bf16 case: its float32 result rounded
    toward zero, the result with the last ``CONTROL_TILE`` keys dropped,
    and P rounded to bf16 before P·V (what a tensor-core kernel that keeps
    P in one bf16 part computes).  Raises if one passes; returns how each
    differs."""
    q, k, v = x
    want = ref.attention_ref(q, k, v, **kw)
    exact = ref.attention_ref(q.float(), k.float(), v.float(), **kw)
    toward_zero = (exact.view(torch.int32) & -65536).view(
        torch.float32).to(torch.bfloat16)
    keep = k.shape[2] - CONTROL_TILE
    short = ref.attention_ref(q, k[:, :, :keep], v[:, :, :keep], **kw)
    out = {}
    p_bf16 = ref.attention_rounded_p(q, k, v, p_split=False, **kw)
    for name, got in (("rounded toward zero", toward_zero),
                      (f"last {CONTROL_TILE} keys dropped", short),
                      ("P rounded to bf16", p_bf16)):
        try:
            attention_err(got, want)
        except AssertionError as exc:
            out[name] = {**attention_stats(got, want), "refused": str(exc)}
            print(f"control '{name}': refused ({exc})")
            continue
        raise AssertionError(f"control '{name}' passed the bf16 check")
    return out


def attention_ab(fa, x, kw, arms: dict, pairs: int) -> dict:
    """Device time of each plan in ``arms`` (name -> plan) at one case, in
    ``pairs`` alternating rounds (a b .., .. b a, ...), all through the same
    launch with buffers made once; each arm is first held against the
    plain version."""
    from repro_torch.kernels import ref
    q, k, v = x
    want = ref.attention_ref(q, k, v, **kw)
    runs = {}
    for name, arm in arms.items():
        out = torch.empty_like(q)
        scratch = (torch.empty(arm.scratch_floats, dtype=torch.float32,
                               device=q.device) if arm.scratch_floats
                   else None)
        fn = functools.partial(fa._launch, q, k, v, out, scratch, arm, **kw)
        fn()
        attention_err(out, want)
        runs[name] = (fn, [])
    order = list(arms)
    for i in range(pairs):
        for name in (order if i % 2 == 0 else order[::-1]):
            runs[name][1].append(graph_ms(runs[name][0], 10, 10))
    return {name: {"block_q": arm.block_q, "block_kv": arm.block_kv,
                   "stages": arm.stages, "splits": arm.splits,
                   "blocks": arm.blocks, "launches": arm.launches,
                   "kernel_ms": runs[name][1]}
            for name, arm in arms.items()}


def split_ab(fa, x, kw, p, other: int, pairs: int = 10) -> dict:
    """Plan ``p`` against the same case at ``other`` KV splits
    (``attention_ab``)."""
    return attention_ab(fa, x, kw, {
        f"splits_{p.splits}": p,
        f"splits_{other}": dataclasses.replace(p, splits=other)}, pairs)


def f32_controls(ref, x, kw) -> dict:
    """The float32 check (atol = rtol = 2e-5) against the emulated TF32
    schemes at one float32 case: one TF32 product per score
    (``attention_tf32_ref(terms=1)``) must be refused; the kernel's three
    (``terms=3``) must pass.  Raises otherwise; returns how each
    differs."""
    want = ref.attention_ref(*x, **kw)
    out = {}
    for terms in (1, 3):
        got = ref.attention_tf32_ref(*x, terms=terms, **kw)
        name = f"tf32 x{terms}"
        try:
            attention_err(got, want)
        except AssertionError as exc:
            if terms == 3:
                raise AssertionError(f"control '{name}' was refused: "
                                     f"{exc}") from None
            out[name] = {**attention_stats(got, want), "refused": str(exc)}
            print(f"control '{name}': refused ({exc})")
            continue
        if terms == 1:
            raise AssertionError(f"control '{name}' passed the float32 "
                                 f"check")
        out[name] = attention_stats(got, want)
        print(f"control '{name}': passes (max |diff| "
              f"{out[name]['max_abs_err']:.3g})")
    return out


SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "MATH", "CUDNN_ATTENTION")


def sdpa_backends(ref, x, kw, case) -> dict:
    """SDPA at one float32 case under each backend alone
    (``torch.nn.attention.sdpa_kernel``), with ``enable_gqa`` or, where a
    backend refuses it, K and V expanded to H heads beforehand (not
    timed); each backend's max |diff| and values beyond 2e-5 against
    ``attention_ref`` and its device time, or why it refused; and the
    device kernels the default call runs (three calls traced after a warm
    one), with the backend they name, or "not seen" where the trace holds
    no device kernel."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    q, k, v = x
    d = q.shape[3]
    want = ref.attention_ref(q, k, v, **kw)
    group = q.shape[1] // k.shape[1]
    kx = k.repeat_interleave(group, dim=1).contiguous()
    vx = v.repeat_interleave(group, dim=1).contiguous()
    causal = case["sdpa_causal"]

    def call(kk, vv, gqa):
        return F.scaled_dot_product_attention(
            q, kk, vv, is_causal=causal, scale=d ** -0.5, enable_gqa=gqa)

    out = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        rec, errors = None, []
        for kk, vv, gqa in ((k, v, True), (kx, vx, False)):
            fn = functools.partial(call, kk, vv, gqa)
            try:
                with sdpa_kernel(backend):
                    got = fn()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                errors.append(str(exc).splitlines()[0][:200])
                continue

            def timed(fn=fn, backend=backend):
                with sdpa_kernel(backend):
                    return fn()
            st = attention_stats(got, want)
            rec = {"enable_gqa": gqa, "max_abs_err": st["max_abs_err"],
                   "n_beyond_2e-5": st["n_beyond"],
                   "kernel_ms": graph_ms(timed, *ATTN_WINDOW)}
            break
        out[name] = rec or {"refused": errors}
    call(k, v, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call(k, v, True)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    names = sorted({e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA})
    joined = " ".join(names).lower()
    default = ("not seen" if not names else
               "cudnn" if "cudnn" in joined else
               "efficient" if ("fmha" in joined or "efficient" in joined)
               else "flash" if "flash" in joined else "math")
    held = {n: r["kernel_ms"] for n, r in out.items()
            if "kernel_ms" in r and r["n_beyond_2e-5"] == 0}
    fastest = min(held, key=held.get) if held else None
    return {"backends": out, "default_kernels": names,
            "default_backend": default, "fastest_within_2e-5": fastest,
            "fastest_ms": held.get(fastest)}


def kept_pairs(sq, skv, causal, window, q_offset) -> int:
    """Query-key pairs the masks keep, per (batch, head)."""
    q_pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, q_pos + 1) if causal else np.full(sq, skv)
    lo = (np.maximum(0, q_pos - window + 1) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.maximum(0, hi - lo).sum())


def attention_bound(case, cuda_cores: bool = False):
    """Least time (ms): q, k, v read once and o written once at the memory
    rate, or 4·D operations per kept pair at the card's peak for the dtype,
    the larger.  bf16: the tensor cores.  float32: the faster of the two
    ways the card takes float32 products, the CUDA cores or three TF32
    products on the tensor cores (the kernel's scheme); with
    ``cuda_cores``, the CUDA cores alone."""
    b, h, hkv, sq, skv, d = case["shape"]
    elt = 2 if case["dtype"] == torch.bfloat16 else 4
    nbytes = elt * d * (2 * b * h * sq + 2 * b * hkv * skv)
    ops = 4 * b * h * d * kept_pairs(sq, skv, case["causal"], case["window"],
                                     case["q_offset"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if case["dtype"] == torch.bfloat16:
        t_ops = ops / BF16_OPS_PER_S * 1e3
    elif cuda_cores:
        t_ops = ops / F32_OPS_PER_S * 1e3
    else:
        t_ops = min(ops / F32_OPS_PER_S, 3 * ops / TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Phase 10: the float front door at the reference's full scale
# (EXPERIMENTS.md §Accuracy: train 4000, eval 2000, calib 64, 6 epochs).
FRONT_DOOR = dict(train_n=4000, eval_n=2000, calib_n=64, epochs=6, batch=64,
                  seed=0)
# EXPERIMENTS.md §Accuracy: the JAX package's run on a CPU at those sizes
JAX_CPU_RECORDED = {"lenet5": (0.9950, 0.9850), "resnet8": (1.0000, 0.9910)}
SPOTCHECK_N = 64                   # first test images served on both devices
FLOAT_TOL = 1e-4                   # float forward, card against CPU


def program_gemms(prog, batch: int) -> list:
    """The ``vta_gemm`` launches of one served stack of ``batch`` images:
    ``(layer, M, K, N, kwargs)`` from each layer's ``plan_cuda`` (fused
    layers int8 out with their relu and shift, others int32 out)."""
    from repro_torch.core.cuda_backend import plan_cuda
    rows = []
    for layer in prog.layers:
        p = plan_cuda(layer.program)
        mp, np_ = p.padded_shape
        kw = (dict(relu=p.relu, shift=p.shift, saturate=False,
                   out_dtype=torch.int8) if p.fused else
              dict(relu=False, shift=0, saturate=False,
                   out_dtype=torch.int32))
        rows.append((layer.spec.name, batch * mp, p.lam * p.block_size, np_,
                     kw))
    return rows


def front_door_phase(ops, ref, kernel, sms, rng, net, dev,
                     retrain: bool = False) -> dict:
    """Phase 10, one net: draw the digit splits, train the float net on the
    card (``train_float``, TF32 off), float top-1 on the card, the float
    forward on the card against the CPU's, PTQ (``quantize_network``,
    margin 0), compile, the spot-check (the card's int8 logits on the first
    ``SPOTCHECK_N`` test images against the ``device="cpu"`` serve), then
    the held-out split through ``int8_top1`` on the card with the launch
    counters set to 0 just before and read just after.  Fails unless the
    delta is within ``quantize.GATE_POINTS``, float top-1 is within it of
    the JAX package's recorded figure, the spot-check is bit-identical,
    the launches equal layers × stacks and the float forwards agree within
    ``FLOAT_TOL``.  ``retrain`` trains a second time from the same seed and
    reports whether the parameters are bit-identical."""
    from repro_torch.device import strict_float32
    # GATE_POINTS: int8 within it of float, and (here) float within it of
    # the JAX package's recorded top-1
    from repro_torch.quantize import (GATE_POINTS, backend_agreement,
                                      digit_dataset, float_model, float_net,
                                      float_top1, int8_top1,
                                      quantize_network, train_float)
    from repro_torch.quantize.train import NET_CHANNELS
    c, ch = FRONT_DOOR, NET_CHANNELS[net]
    t0 = time.perf_counter()
    split = lambda n, name: digit_dataset(n, seed=c["seed"], split=name,
                                          channels=ch)
    train_x, train_y = split(c["train_n"], "train")
    test_x, test_y = split(c["eval_n"], "test")
    calib_x, _ = split(c["calib_n"], "calib")
    rec = {"net": net, **c, "data_s": time.perf_counter() - t0,
           "train_device_mb": (train_x.nbytes + train_y.nbytes) / 1e6}

    def train():
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = train_float(net, train_x, train_y, epochs=c["epochs"],
                             batch=c["batch"], seed=c["seed"], device=dev,
                             losses=losses)
        return params, losses, time.perf_counter() - t0

    params, losses, rec["train_s"] = train()
    per_epoch = c["train_n"] // c["batch"]
    if len(losses) != c["epochs"] * per_epoch:
        raise AssertionError(f"{net}: {len(losses)} Adam steps")
    epoch_loss = torch.stack(losses).reshape(c["epochs"], per_epoch).mean(1)
    rec["steps"] = len(losses)
    rec["epoch_mean_loss"] = epoch_loss.tolist()
    if retrain:
        again, _, rec["retrain_s"] = train()
        rec["retrain_bit_identical"] = all(np.array_equal(again[k], params[k])
                                           for k in params)
    t0 = time.perf_counter()
    facc = float_top1(net, params, test_x, test_y, device=dev)
    rec["float_top1_s"] = time.perf_counter() - t0
    x = torch.from_numpy(test_x[:SPOTCHECK_N])
    with torch.no_grad(), strict_float32():
        card = float_net(net, params, device=dev)(x.to(dev)).cpu()
        host = float_net(net, params, device="cpu")(x)
    rec["float_card_vs_cpu_max_abs_err"] = (card - host).abs().max().item()
    if not torch.allclose(card, host, atol=FLOAT_TOL, rtol=FLOAT_TOL):
        raise AssertionError(f"{net}: float forward on the card differs "
                             f"from the CPU's by "
                             f"{rec['float_card_vs_cpu_max_abs_err']}")
    t0 = time.perf_counter()
    qm = quantize_network(float_model(net, params), calib_x, margin=0)
    rec["ptq_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog = qm.compile()
    rec["compile_s"] = time.perf_counter() - t0
    layers, stacks = len(prog.layers), -(-c["eval_n"] // c["batch"])
    t0 = time.perf_counter()
    rec["spotcheck_bit_identical"] = backend_agreement(
        prog, test_x[:SPOTCHECK_N], input_exp=qm.input_exp, device=dev)
    rec["spotcheck_s"] = time.perf_counter() - t0
    if not rec["spotcheck_bit_identical"]:
        raise AssertionError(f"{net}: int8 logits on the card differ from "
                             f"the CPU serve's")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    iacc = int8_top1(prog, test_x, test_y, input_exp=qm.input_exp,
                     batch=c["batch"], device=dev)
    rec["eval_s"] = time.perf_counter() - t0
    launches = ops.launches
    rec.update(layers=layers, stacks=stacks, launches=launches,
               eval_img_per_s=c["eval_n"] / rec["eval_s"],
               float_top1=facc, int8_top1=iacc,
               delta_points=(facc - iacc) * 100.0,
               weight_exps=dict(qm.weight_exps), shifts=dict(qm.shifts))
    jf, ji = JAX_CPU_RECORDED[net]
    rec["jax_cpu_recorded"] = {"float_top1": jf, "int8_top1": ji,
                               "delta_points": round((jf - ji) * 100, 2)}
    print(f"front door, {net}: data {rec['data_s']:.2f} s, train "
          f"{rec['train_s']:.2f} s ({rec['steps']} Adam steps, TF32 off; "
          f"epoch mean loss "
          + " ".join(f"{v:.4f}" for v in rec["epoch_mean_loss"])
          + f"), PTQ {rec['ptq_s']:.2f} s, compile {rec['compile_s']:.2f} s, "
          f"eval {rec['eval_s']:.3f} s ({rec['eval_img_per_s']:.0f} img/s, "
          f"{stacks} stacks of {c['batch']}); float top-1 {facc * 100:.2f} %, "
          f"int8 {iacc * 100:.2f} %, delta {rec['delta_points']:+.2f} points; "
          f"vta_gemm launches {launches} ({layers} layers x {stacks} stacks); "
          f"spot-check on {SPOTCHECK_N} images bit-identical; float card vs "
          f"CPU max |diff| {rec['float_card_vs_cpu_max_abs_err']:.3g}"
          + (f"; trained twice: parameters "
             f"{'bit-identical' if rec['retrain_bit_identical'] else 'differ'}"
             if retrain else ""))
    print(f"  the JAX package's recorded CPU run (EXPERIMENTS.md): float "
          f"{jf * 100:.2f} %, int8 {ji * 100:.2f} %, delta "
          f"{(jf - ji) * 100:+.2f} points")
    if launches != layers * stacks:
        raise AssertionError(f"{net}: {launches} vta_gemm launches, expected "
                             f"{layers} x {stacks}")
    if round(rec["delta_points"], 2) > GATE_POINTS:
        raise AssertionError(f"{net}: int8 {rec['delta_points']:.2f} points "
                             f"under float")
    if facc * 100 < jf * 100 - GATE_POINTS:
        raise AssertionError(f"{net}: float top-1 {facc * 100:.2f} % is more "
                             f"than {GATE_POINTS} points under the JAX "
                             f"package's {jf * 100:.2f} %")
    rec["gemms"] = [time_gemm(ops, ref, kernel, sms, rng, name, m, k, n, kw,
                              dev)
                    for name, m, k, n, kw in program_gemms(prog, c["batch"])]
    total = lambda key: (None if any(r[key] is None for r in rec["gemms"])
                         else sum(r[key] for r in rec["gemms"]))
    rec["stack_gemm"] = {key: total(key) for key in
                         ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    us = lambda t: "n/a" if t is None else f"{t * 1e3:.2f} us"
    print(f"  vta_gemm at its {layers} shapes, batch {c['batch']}: kernel "
          f"{us(total('kernel_ms'))}, plain {us(total('plain_ms'))}, _int_mm "
          f"{us(total('library_ms'))}, bound {us(total('bound_ms'))}")
    return rec


def projection_phase(ops, dev) -> dict:
    """Phase 11: the GQA projection of ``repro_torch.vta_lm_projection`` on
    the oracle, the kernel on the card (one launch, the counters set to 0
    just before and read just after) and the plain version, byte for byte;
    then ``MATMUL_CASES`` (K not a multiple of 16, int32 out, saturate on
    and off) through ``run_matmul_case``."""
    from repro_torch import vta_lm_projection as proj
    torch.cuda.synchronize()
    ops.reset_launches()
    res = proj.run_projection(dev)
    launches = ops.launches
    if launches != 1:
        raise AssertionError(f"projection: {launches} vta_gemm launches")
    for name in ("kernel", "plain"):
        if not np.array_equal(res["oracle"], res[name]):
            raise AssertionError(f"projection: oracle != {name}")
    report = res["report"]
    rec = {"launches": launches, "gemm_loops": report.gemm_loops,
           "insn_executed": report.insn_executed,
           "dram_bytes": report.dram_bytes_total, "cases": []}
    print(f"projection 64x96x64: oracle ({report.gemm_loops} GeMM loops) == "
          f"vta_gemm on the card ({launches} launch) == plain, bit-exact")
    for case in proj.MATMUL_CASES:
        r = proj.run_matmul_case(case, dev)
        failed = [k for k, ok in r["checks"].items() if not ok]
        if failed:
            raise AssertionError(f"{r['name']}: {failed}")
        rec["cases"].append({"name": r["name"], "shape": list(r["shape"]),
                             "saturated_values": r["saturated"],
                             "checks": sorted(r["checks"])})
        print(f"  {r['name']} {'x'.join(map(str, r['shape']))}: "
              f"{len(r['checks'])} checks hold (oracle, kernel and plain; "
              f"int8 wrap and saturate, int32; {r['saturated']} values "
              f"beyond int8)")
    return rec


# -- phases 12-14: the interpreters, the guards, the seeded campaign ---------

INTERP_BATCHES = (8, 32)           # phase 12: a batched serve at each
INTERP_SERVE_ONE = 4               # phase 12: serve_one(backend="fast")
INTERP_REPEATS = 5                 # phase 12: rounds of warmed serves
GUARD_REPEATS = 9                  # phase 13: rounds of plain/guarded/dual
GUARD_ENGINE_REQUESTS = 128        # phase 13: the guarded engine's trace
CAMPAIGN_SEED = 2026               # phase 14: benchmarks/fault_campaign.py
# The JAX package's LeNet-5 campaign at seed 2026 (EXPERIMENTS.md §Faults;
# the guards-off split from the same injector): 200 injections a class
# with the guards on, then 25 a class with them off.
LENET_CAMPAIGN = {"n_on": 200, "n_off": 25, "guarded": {
    "dram-wgt": {"recovered": 200}, "dram-uop": {"recovered": 200},
    "dram-bias": {"recovered": 200}, "insn-bits": {"recovered": 200},
    "insn-field": {"recovered": 200},
    "sram": {"recovered": 30, "masked": 170}}, "unguarded": {
    "dram-wgt": {"masked": 21, "sdc": 4}, "dram-uop": {"sdc": 19, "masked": 6},
    "dram-bias": {"masked": 14, "sdc": 11},
    "insn-bits": {"detected": 5, "sdc": 8, "masked": 12},
    "insn-field": {"masked": 10, "detected": 7, "sdc": 8},
    "sram": {"masked": 21, "sdc": 4}}}
RESNET8_CAMPAIGN = {"n_on": 10, "n_off": 5}


def median_s(fns: dict, repeats: int = INTERP_REPEATS) -> dict:
    """Median host-clock seconds of each of ``fns`` (name → call) over
    ``repeats`` rounds that call them in turn, after one warm-up call each
    (every call ends in a copy of its answers to the host), so a drift of
    the host's speed falls on all of them alike."""
    for fn in fns.values():
        fn()
    runs = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            runs[name].append(time.perf_counter() - t0)
    return {name: sorted(r)[len(r) // 2] for name, r in runs.items()}


def serve_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the kernels the host
    launched (``cudaLaunchKernel`` calls), the device's kernel and copy
    events, its busy time and the copies each way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    host_launches = sum(1 for e in prof.events()
                        if e.device_type == DeviceType.CPU
                        and e.name in ("cudaLaunchKernel",
                                       "cudaLaunchKernelExC"))
    copies = [e for e in dev_events if "Memcpy" in e.name]
    return {"host_kernel_launches": host_launches,
            "device_kernels": len(dev_events) - len(copies)
            - sum(1 for e in dev_events if "Memset" in e.name),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in dev_events) / 1e3,
            "copies_dtoh": sum(1 for e in copies if "DtoH" in e.name),
            "copies_htod": sum(1 for e in copies if "HtoD" in e.name)}


def interpreter_phase(ops, models, card: str, dev) -> dict:
    """Phase 12: each model served on the torch interpreters on the card —
    ``serve(backend="batched")`` at ``INTERP_BATCHES`` and
    ``serve_one(backend="fast")`` for ``INTERP_SERVE_ONE`` images — held
    bit for bit against the ``cuda`` backend's serve of the same images
    (the launch counters set to 0 just before those serves and read just
    after) and the model's integer reference.  The interpreters must add
    nothing to ``vta_gemm``'s counter.  Reports img/s (median of warmed
    serves of the two backends taken in turns, host clock), and per
    batch-32 interpreter serve the kernels the host launched, the device's kernel events and
    busy time, the copies each way and the interpreter's own count of
    device-to-host reads (``fast_simulator.syncs``)."""
    from repro_torch.core import fast_simulator as fs
    rec = {"card": card, "models": {}, "launches": 0}
    for name, net, images, reference, layers in models:
        lo, golden, m = 0, [], {"layers": layers}
        torch.cuda.synchronize()
        ops.reset_launches()
        for bsz in INTERP_BATCHES:
            golden.append(net.serve(images[lo:lo + bsz], device=dev)[0])
            lo += bsz
        cuda_launches = ops.launches
        if cuda_launches != layers * len(INTERP_BATCHES):
            raise AssertionError(f"{name}: {cuda_launches} vta_gemm "
                                 f"launches for {len(INTERP_BATCHES)} "
                                 f"cuda serves of {layers} layers")
        rec["launches"] += cuda_launches
        ops.reset_launches()
        lo = 0
        for bsz, want in zip(INTERP_BATCHES, golden):
            got, _ = net.serve(images[lo:lo + bsz], backend="batched",
                               device=dev)
            if not np.array_equal(got, want):
                raise AssertionError(f"{name}: batched interpreter != cuda "
                                     f"at batch {bsz}")
            for r in range(bsz):
                if not np.array_equal(got[r], reference(images[lo + r])):
                    raise AssertionError(f"{name} request {lo + r}: the "
                                         f"interpreter != the reference")
            lo += bsz
        for r in range(INTERP_SERVE_ONE):
            one = net.serve_one(images[r], backend="fast", device=dev)
            if not np.array_equal(one, golden[0][r]):
                raise AssertionError(f"{name} request {r}: serve_one(fast) "
                                     f"!= cuda")
        if ops.launches or ops.attention_launches:
            raise AssertionError(f"{name}: the interpreters launched "
                                 f"{ops.launches} vta_gemm kernels")
        for bsz in INTERP_BATCHES:
            batch = images[:bsz]
            t = median_s({
                "batched": lambda: net.serve(batch, backend="batched",
                                             device=dev),
                "cuda": lambda: net.serve(batch, device=dev)})
            m[f"batch{bsz}"] = {"batched_ms": t["batched"] * 1e3,
                                "batched_img_per_s": bsz / t["batched"],
                                "cuda_ms": t["cuda"] * 1e3,
                                "cuda_img_per_s": bsz / t["cuda"]}
        t_one = median_s({"fast": lambda: net.serve_one(
            images[0], backend="fast", device=dev)})["fast"]
        m["serve_one_fast_ms"] = t_one * 1e3
        batch = images[:32]
        fs.reset_syncs()
        net.serve(batch, backend="batched", device=dev)
        m["syncs_per_batch"] = fs.syncs
        m["profile_batch32"] = serve_profile(
            lambda: net.serve(batch, backend="batched", device=dev))
        m["bit_exact"] = (f"{sum(INTERP_BATCHES)}/{sum(INTERP_BATCHES)} "
                          f"batched, {INTERP_SERVE_ONE}/{INTERP_SERVE_ONE} "
                          f"fast")
        rec["models"][name] = m
        p = m["profile_batch32"]
        print(f"{name} on the interpreters: {m['bit_exact']} equal to the "
              f"cuda backend and the integer reference, 0 vta_gemm "
              f"launches; batched "
              + ", ".join(f"batch {b} {m[f'batch{b}']['batched_ms']:.2f} ms"
                          f" = {m[f'batch{b}']['batched_img_per_s']:.1f} "
                          f"img/s (cuda {m[f'batch{b}']['cuda_ms']:.2f} ms)"
                          for b in INTERP_BATCHES)
              + f"; serve_one(fast) {t_one * 1e3:.2f} ms; a batch-32 serve: "
              f"{p['host_kernel_launches']} kernel launches, "
              f"{p['device_kernels']} device kernels, device busy "
              f"{p['device_busy_ms']:.3f} ms, {p['copies_dtoh']} DtoH / "
              f"{p['copies_htod']} HtoD copies, {m['syncs_per_batch']} "
              f"interpreter syncs ({card})")
    return rec


def guarded_phase(ops, models, card: str, dev) -> dict:
    """Phase 13: LeNet-5 and resnet8 at batch 32 through
    ``serve(backend="batched", guard=GuardPolicy(dual_execute=True))``:
    every report ``clean``, the outputs the ``cuda`` backend's, and the
    shadow — the network's default serve, the ``cuda`` backend — making
    exactly ``layers`` ``vta_gemm`` launches (the counters set to 0 just
    before the guarded serve and read just after).  Times the plain
    batched serve, the guarded one and the guarded one with dual
    execution (median of warmed serves taken in turns, host clock).  Then
    the serving
    engine with ``backends=("batched",)`` and ``guard=GuardPolicy()``:
    ``GUARD_ENGINE_REQUESTS`` requests, all bit-identical to a direct serve,
    every guard report clean, the audit clean."""
    from repro_torch.harden import GuardPolicy
    from repro_torch.serving import vta
    rec = {"card": card, "models": {}, "launches": 0}
    n_req = GUARD_ENGINE_REQUESTS
    for name, net, images, _, layers in models:
        batch = images[:32]
        want, _ = net.serve(batch, device=dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        outs, _, reports = net.serve(batch, backend="batched", device=dev,
                                     guard=GuardPolicy(dual_execute=True))
        shadow = ops.launches
        if shadow != layers:
            raise AssertionError(f"{name}: the guarded batch's shadow made "
                                 f"{shadow} vta_gemm launches, expected "
                                 f"{layers}")
        rec["launches"] += shadow
        outcomes = sorted({r.outcome for r in reports})
        if outcomes != ["clean"] or not np.array_equal(outs, want):
            raise AssertionError(f"{name}: guarded batch {outcomes}, or its "
                                 f"outputs differ from the cuda backend's")
        t = median_s({
            "plain": lambda: net.serve(batch, backend="batched", device=dev),
            "guarded": lambda: net.serve(batch, backend="batched",
                                         device=dev, guard=GuardPolicy()),
            "dual": lambda: net.serve(batch, backend="batched", device=dev,
                                      guard=GuardPolicy(dual_execute=True))},
            repeats=GUARD_REPEATS)
        plain, guarded, dual = t["plain"], t["guarded"], t["dual"]
        m = {"layers": layers, "shadow_launches": shadow,
             "outcomes": outcomes, "plain_ms": plain * 1e3,
             "guarded_ms": guarded * 1e3, "guarded_dual_ms": dual * 1e3,
             "overhead_pct": 100 * (guarded / plain - 1),
             "overhead_dual_pct": 100 * (dual / plain - 1)}
        policy = vta.BatchPolicy(max_batch=32, max_wait_s=0.002,
                                 max_depth=1024)
        requests = np.concatenate([images] * -(-n_req // len(images)))
        requests = requests[:n_req]
        direct = np.concatenate([net.serve(requests[i:i + 32], device=dev)[0]
                                 for i in range(0, n_req, 32)])
        ops.reset_launches()
        with vta.VTAServingEngine(net, policy=policy, backends=("batched",),
                                  device=dev, guard=GuardPolicy()) as engine:
            t0 = time.perf_counter()
            served, tickets = vta.serve_all(engine, list(requests))
            wall = time.perf_counter() - t0
        audit = engine.metrics.audit()
        engine_outcomes = sorted({t.guard_report.outcome for t in tickets})
        same = sum(np.array_equal(a, b) for a, b in zip(served, direct))
        if (same != n_req or audit or engine_outcomes != ["clean"]
                or ops.launches):
            raise AssertionError(f"{name} guarded engine: {same}/{n_req} "
                                 f"bit-identical, audit {audit}, outcomes "
                                 f"{engine_outcomes}, "
                                 f"{ops.launches} vta_gemm launches")
        summary = engine.metrics.summary()
        m["engine"] = {"requests": n_req,
                       "bit_identical": f"{same}/{n_req}",
                       "outcomes": engine_outcomes, "audit": "clean",
                       "wall_s": wall, "img_per_s": n_req / wall,
                       "p50_ms": summary["p50_ms"],
                       "p99_ms": summary["p99_ms"],
                       "mean_batch": summary["mean_batch_occupancy"]}
        rec["models"][name] = m
        print(f"{name} guarded batch 32: all clean, shadow {shadow} vta_gemm "
              f"launches; plain batched {plain * 1e3:.2f} ms, guarded "
              f"{guarded * 1e3:.2f} ms ({m['overhead_pct']:+.1f} %), with "
              f"dual execution {dual * 1e3:.2f} ms "
              f"({m['overhead_dual_pct']:+.1f} %); guarded engine "
              f"{same}/{n_req} bit-identical, audit clean, "
              f"{n_req / wall:.1f} img/s ({card})")
    return rec


def _classify(out, golden, report) -> str:
    if out is None:
        return "unrecovered"
    if not np.array_equal(out, golden):
        return "sdc"
    return "recovered" if report.detections else "masked"


def campaign_arms(net, image, dual_backend: str, n_on: int, n_off: int,
                  dev) -> dict:
    """The port's counterpart of ``benchmarks/fault_campaign.py``'s
    ``_guarded_arm`` then ``_unguarded_arm``, from one seeded injector:
    ``n_on`` injections a class served through ``serve_one(backend="fast",
    guard=...)`` (dual execution against ``dual_backend`` for ``sram``),
    then ``n_off`` a class served unguarded, every serve on ``dev``.  The
    golden output is the ``cuda`` backend's.  Returns per-injection
    outcomes, per-class tallies and each arm's seconds."""
    from repro_torch.harden import (FAULT_CLASSES, FaultInjector,
                                    GuardPolicy, guards)
    from repro_torch.harden.faults import estimate_footprint
    inj = FaultInjector(seed=CAMPAIGN_SEED)
    golden_out = net.serve_one(image, device=dev)
    golden = guards.golden_of(net)
    log = {"guarded": [], "unguarded": []}
    tally = {"guarded": {}, "unguarded": {}}
    seconds = {}
    t0 = time.perf_counter()
    for cls in FAULT_CLASSES:
        policy = GuardPolicy(dual_execute=(cls == "sram"),
                             dual_backend=dual_backend)
        counts = tally["guarded"].setdefault(cls, {})
        for _ in range(n_on):
            spec, hook = inj.inject(net, cls)
            if cls == "insn-bits":
                try:
                    inj.materialize(net, spec)
                except ValueError:
                    pass        # undecodable: the stale decode stays
            out, rep = net.serve_one(image, backend="fast", device=dev,
                                     guard=policy, fault_hook=hook)
            outcome = _classify(out, golden_out, rep)
            counts[outcome] = counts.get(outcome, 0) + 1
            log["guarded"].append((spec.describe(), outcome, rep.outcome,
                                   rep.retries))
            guards.restore_network(net, golden)
    seconds["guarded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for cls in FAULT_CLASSES:
        counts = tally["unguarded"].setdefault(cls, {})
        for _ in range(n_off):
            spec, hook = inj.inject(net, cls)
            decode_failed = False
            if cls == "insn-bits":
                try:
                    inj.materialize(net, spec)
                except ValueError:
                    decode_failed = True
            bomb = any(estimate_footprint(layer.program.instructions)
                       > guards.MAX_INSN_FOOTPRINT for layer in net.layers)
            if decode_failed:
                outcome = "detected"
            elif bomb:
                outcome = "hang"
            else:
                try:
                    out = net.serve_one(image, backend="fast", device=dev,
                                        fault_hook=hook)
                except guards._SERVE_FAULTS as exc:
                    # the reference scores any crash as detected; here only
                    # its typed serve faults are, so that a torch error in
                    # place of one fails the phase instead of scoring
                    outcome = "detected"
                    log["unguarded_errors"] = log.get(
                        "unguarded_errors", []) + [
                        f"{type(exc).__name__}: {exc}"[:200]]
                else:
                    outcome = ("masked" if np.array_equal(out, golden_out)
                               else "sdc")
            counts[outcome] = counts.get(outcome, 0) + 1
            log["unguarded"].append((spec.describe(), outcome))
            guards.restore_network(net, golden)
    seconds["unguarded"] = time.perf_counter() - t0
    if guards.verify_network(net, golden):
        raise AssertionError("the campaign left the network corrupted")
    return {"log": log, "tally": tally, "seconds": seconds,
            "sdc_guarded": sum(t.get("sdc", 0)
                               for t in tally["guarded"].values()),
            "sdc_unguarded": sum(t.get("sdc", 0)
                                 for t in tally["unguarded"].values())}


def campaign_phase(card: str, dev) -> dict:
    """Phase 14: the reference's seeded SEU campaign on the card.  LeNet-5
    (seed-0 weights, image ``synthetic_digit(1)``, the oracle shadow) at
    the reference's settings must reproduce the JAX package's per-class
    counts exactly (``LENET_CAMPAIGN``); resnet8 (image
    ``synthetic_image(1)``, the fast shadow) at ``RESNET8_CAMPAIGN`` must
    give the same per-injection outcomes on the card as on the host
    (``device="cpu"``).  Both: no silent corruption with the guards on."""
    from repro_torch.core.network_compiler import compile_network
    from repro_torch.models import lenet, resnet8
    rec = {"card": card, "seed": CAMPAIGN_SEED}
    net = compile_network(lenet.lenet5_specs(lenet.lenet5_random_weights(0)),
                          lenet.synthetic_digit(0))
    res = campaign_arms(net, lenet.synthetic_digit(1), "oracle",
                        LENET_CAMPAIGN["n_on"], LENET_CAMPAIGN["n_off"], dev)
    for arm in ("guarded", "unguarded"):
        if res["tally"][arm] != LENET_CAMPAIGN[arm]:
            raise AssertionError(f"LeNet-5 campaign, guards {arm}: "
                                 f"{res['tally'][arm]} != the JAX package's "
                                 f"{LENET_CAMPAIGN[arm]}")
    rec["lenet5"] = {k: res[k] for k in ("tally", "seconds", "sdc_guarded",
                                         "sdc_unguarded")}
    rec["lenet5"]["unguarded_errors"] = res["log"].get("unguarded_errors", [])
    print(f"LeNet-5 campaign (seed {CAMPAIGN_SEED}, "
          f"{LENET_CAMPAIGN['n_on']} a class guarded, "
          f"{LENET_CAMPAIGN['n_off']} unguarded): the JAX package's counts "
          f"exactly; guarded {res['tally']['guarded']}, 0 SDC "
          f"({res['seconds']['guarded']:.1f} s); unguarded "
          f"{res['sdc_unguarded']}/{6 * LENET_CAMPAIGN['n_off']} SDC "
          f"{res['tally']['unguarded']} ({res['seconds']['unguarded']:.1f} s)"
          f" ({card})")
    runs = {}
    for where in (dev, torch.device("cpu")):
        r8, _ = resnet8.compile_resnet8()
        runs[where.type] = campaign_arms(
            r8, resnet8.synthetic_image(1), "fast", RESNET8_CAMPAIGN["n_on"],
            RESNET8_CAMPAIGN["n_off"], where)
    card_run, host_run = runs["cuda"], runs["cpu"]
    if card_run["sdc_guarded"] or card_run["log"] != host_run["log"]:
        raise AssertionError(f"resnet8 campaign: guarded SDC "
                             f"{card_run['sdc_guarded']}, or the card's "
                             f"outcomes differ from the host's")
    rec["resnet8"] = {"n_on": RESNET8_CAMPAIGN["n_on"],
                      "n_off": RESNET8_CAMPAIGN["n_off"],
                      "tally": card_run["tally"],
                      "seconds": card_run["seconds"],
                      "seconds_cpu": host_run["seconds"],
                      "sdc_guarded": card_run["sdc_guarded"],
                      "sdc_unguarded": card_run["sdc_unguarded"],
                      "identical_to_cpu": True}
    print(f"resnet8 campaign ({RESNET8_CAMPAIGN['n_on']} a class guarded, "
          f"{RESNET8_CAMPAIGN['n_off']} unguarded): per-injection outcomes "
          f"identical on the card and the host; guarded "
          f"{card_run['tally']['guarded']}, 0 SDC; unguarded "
          f"{card_run['sdc_unguarded']}/{6 * RESNET8_CAMPAIGN['n_off']} SDC;"
          f" card {card_run['seconds']['guarded']:.1f} + "
          f"{card_run['seconds']['unguarded']:.1f} s, host "
          f"{host_run['seconds']['guarded']:.1f} + "
          f"{host_run['seconds']['unguarded']:.1f} s ({card})")
    return rec


def find_cuobjdump():
    """``cuobjdump`` from the toolkit, else the copy in Triton's package."""
    for path in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if path and pathlib.Path(path).is_file():
            return path
    try:
        import triton
    except ImportError:
        return None
    path = (pathlib.Path(triton.__file__).parent / "backends" / "nvidia"
            / "bin" / "cuobjdump")
    return str(path) if path.is_file() else None


def sass_counts(so) -> dict:
    """Counts of HGMMA (wgmma), HMMA (float mma.sync) and IMMA (integer
    mma.sync) instructions in a built library's SASS, or None where no
    cuobjdump is found."""
    tool = find_cuobjdump()
    if tool is None:
        return {"cuobjdump": None}
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    return {"cuobjdump": tool, "HGMMA": out.count("HGMMA"),
            "HMMA": out.count("HMMA"), "IMMA": out.count("IMMA")}


def vta_gemm_ptxas(log: str) -> list:
    """ptxas's registers and spill bytes for each vta_gemm instantiation
    (template arguments bm, bn, k_split, vec16) in a build log."""
    rows, cur = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '\S*vta_gemm_kernel"
                          r"ILi(\d+)ELi(\d+)ELi(\d+)ELb([01])", line)
        if found:
            bm, bn, ks, vec = (int(x) for x in found.groups())
            cur = {"bm": bm, "bn": bn, "k_split": ks,
                   "load": "vec16" if vec else "bytes"}
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill_bytes"] = sum(int(x) for x in re.findall(
                r"(\d+) bytes spill", line))
        elif cur is not None and "Used" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    return rows


def f32_ptxas(log: str) -> list:
    """ptxas's registers and spill bytes for each kernel of the float32
    attention library: every ``f32_kernel`` instantiation (D, warps, keys
    a tile, stages, Q in registers, blocks an SM) and the combine."""
    rows, cur = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '\S*f32_kernel"
                          r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])"
                          r"ELi(\d+)E", line)
        if found:
            d, w, bk, st, qreg, minb = (int(x) for x in found.groups())
            cur = {"kernel": "f32", "d": d, "block_q": 16 * w,
                   "block_kv": bk, "stages": st, "qreg": bool(qreg),
                   "blocks_per_sm": minb}
            rows.append(cur)
        elif "Compiling entry function" in line and "combine_kernel" in line:
            cur = {"kernel": "combine"}
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill_bytes"] = sum(int(x) for x in re.findall(
                r"(\d+) bytes spill", line))
        elif cur is not None and "Used" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.cuda_backend import plan_cuda
    from repro_torch.kernels import flash_attention as attn_kernel
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

    # -- 2. build every kernel at once -----------------------------------
    def timed_build(k):
        t0 = time.perf_counter()
        so = k.build()
        return so, time.perf_counter() - t0

    kernels = (kernel.KERNEL, *attn_kernel.KERNELS)
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        builds = list(pool.map(timed_build, kernels))
    record["build_s"], record["ptxas"] = {}, {}
    for k, (so, seconds) in zip(kernels, builds):
        record["build_s"][so.name] = seconds
        lines = [line.strip() for line in k.build_log.splitlines()
                 if "ptxas" in line or "spill" in line]
        record["ptxas"][so.name] = lines
        print(f"built {so.name} in {seconds:.2f}s")
        if k is kernel.KERNEL:          # one line per instantiation
            continue
        for line in lines:
            print(f"  {line}")
    gemm_ptxas = vta_gemm_ptxas(kernel.KERNEL.build_log)
    for row in gemm_ptxas:
        print(f"  vta_gemm bm {row['bm']} bn {row['bn']} k_split "
              f"{row['k_split']} {row['load']}: {row['registers']} registers, "
              f"{row['spill_bytes']} spill bytes")
    if not kernel.KERNEL.build_log:
        print("  vta_gemm: library built by an earlier run; no ptxas lines")
    elif len(gemm_ptxas) != len(kernel.INSTANTIATIONS) or any(
            row["spill_bytes"] for row in gemm_ptxas):
        raise AssertionError(f"vta_gemm: {len(gemm_ptxas)} instantiations "
                             f"built, {len(kernel.INSTANTIATIONS)} declared, "
                             f"or ptxas spills")
    attn_ptxas = f32_ptxas(attn_kernel.KERNEL.build_log)
    if not attn_kernel.KERNEL.build_log:
        print("  f32 attention: library built by an earlier run; no ptxas "
              "lines")
    elif ({(r["d"], r["block_q"], r["block_kv"], r["stages"]):
           (r["qreg"], r["blocks_per_sm"]) for r in attn_ptxas
           if r["kernel"] == "f32"} != attn_kernel.F32_INSTANTIATIONS
          or any(r.get("spill_bytes") for r in attn_ptxas)):
        raise AssertionError(f"f32 attention: {attn_ptxas} against "
                             f"{len(attn_kernel.F32_INSTANTIATIONS)} "
                             f"declared instantiations, or ptxas spills")
    record["sass_vta_gemm"] = sass_counts(builds[0][0])
    record["sass_f32"] = sass_counts(builds[1][0])
    record["sass_bf16"] = sass_counts(builds[-1][0])
    print(f"vta_gemm SASS: {record['sass_vta_gemm']}")
    print(f"f32 attention SASS: {record['sass_f32']}")
    print(f"bf16 attention SASS: {record['sass_bf16']}")
    if record["sass_vta_gemm"].get("IMMA") == 0:
        raise AssertionError("the vta_gemm library holds no IMMA")
    if record["sass_f32"].get("HMMA") == 0:
        raise AssertionError("the f32 attention library holds no HMMA")
    if record["sass_bf16"].get("HGMMA") == 0:
        raise AssertionError("the bf16 attention library holds no HGMMA")

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
    if per_batch != [5] * len(BATCH_SIZES) or ops.attention_launches:
        raise AssertionError(f"kernel launches per batch {per_batch}, "
                             f"expected 5 each; attention launches "
                             f"{ops.attention_launches}, expected 0")
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

    # -- 4b. main path: resnet8, resnet_tiny, the CIFAR CNN on the card -----
    cnns = compile_cnns()
    record["cnn_serve"] = serve_cnns(ops, cnns, dev)

    # -- 5. kernel timings at LeNet-5's and resnet8's shapes, batch 32 ----
    rng = np.random.default_rng(5)
    sms = attn_kernel.device_sm_count(dev)
    shapes = [time_gemm(ops, ref, kernel, sms, rng, name, m, k, n, kw, dev)
              for name, m, k, n, kw in program_gemms(net, 32)]
    resnet8 = [time_gemm(ops, ref, kernel, sms, rng, name, m, k, n,
                         dict(relu=True, shift=4, saturate=False,
                              out_dtype=torch.int8) if out == "int8" else
                         dict(relu=False, shift=0, saturate=False,
                              out_dtype=torch.int32), dev)
               for name, m, k, n, out in RESNET8_GEMMS]
    more = {title: [time_gemm(ops, ref, kernel, sms, rng, name, m, k, n,
                              dict(relu=True, shift=4, saturate=False,
                                   out_dtype=torch.int8) if out == "int8"
                              else dict(relu=False, shift=0, saturate=False,
                                        out_dtype=torch.int32), dev)
                    for name, m, k, n, out in gemms]
            for title, gemms in (("CIFAR CNN", CIFAR_CNN_GEMMS),
                                 ("resnet_tiny", RESNET_TINY_GEMMS))}
    total = lambda key: (None if any(s[key] is None for s in shapes)
                         else sum(s[key] for s in shapes))
    entry = {
        "name": "vta_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/vta_gemm.cu",
        "replaces": "src/repro/kernels/vta_gemm.py:45",
        "launches": launches + record["cnn_serve"]["launches"],
        "launches_by_path": {
            "lenet5": launches,
            **{name: sum(m["launches_per_batch"]) for name, m in
               record["cnn_serve"]["models"].items()}},
        "launches_per_batch": 5,
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
        "resnet8_shapes": resnet8,
        "cifar_cnn_shapes": more["CIFAR CNN"],
        "resnet_tiny_shapes": more["resnet_tiny"],
        "sass": record["sass_vta_gemm"],
        "ptxas": gemm_ptxas,
    }
    record["kernels"] = [entry]
    for title, rows in (("LeNet-5", shapes), ("resnet8", resnet8),
                        *more.items()):
        us = lambda t: "n/a" if t is None else f"{t * 1e3:.2f} us"
        libs = [r["library_ms"] for r in rows]
        print(f"vta_gemm at {title}'s shapes, batch 32 (sum of kernel "
              f"{us(sum(r['kernel_ms'] for r in rows))}, _int_mm "
              f"{us(None if None in libs else sum(libs))}):")
        for row in rows:
            pl = row["plan"]
            print(f"  {row['layer']:5s} {row['m']}x{row['k']}x{row['n']} "
                  f"{row['out']}: kernel {us(row['kernel_ms'])} (per call "
                  f"{us(row['call_ms'])}), plain {us(row['plain_ms'])}, "
                  f"_int_mm {us(row['library_ms'])}, bound "
                  f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}); plan "
                  f"{pl['bm']}x{pl['bn']} k_split {pl['k_split']} bk "
                  f"{pl['bk']} stages {pl['stages']} {pl['load']}, "
                  f"{pl['blocks']} blocks of {pl['warps']} warps, "
                  f"{pl['smem_bytes']} B shared")
    print("vta_gemm: plan against the starting rule and the unsplit tile "
          "(median of 3 alternating rounds):")
    entry["plan_ab"] = plan_ab(kernel, ref, sms, rng, shapes + resnet8, dev)

    # -- 6. throughput and where a served batch's time goes --------------
    record["serve"] = {"main_path_batch_s": times}
    r8_net, r8_images = cnns[0][1], cnns[0][2]
    record["serve"]["resnet8"] = serve_timing(r8_net, r8_images, dev,
                                              "resnet8")
    record["serve"].update(serve_timing(net, images, dev, "LeNet-5"))

    # -- 6b. main path: the async serving engine on the card ---------------
    record["engine"] = {
        "lenet5": engine_phase(
            ops, "LeNet-5", net, 5,
            lambda img: reference_forward_int8(weights, img, shifts)[0],
            record["serve"]["batch32"]["img_per_s"], dev),
        "resnet8": engine_phase(
            ops, "resnet8", r8_net, 11, cnns[0][3],
            record["serve"]["resnet8"]["batch32"]["img_per_s"], dev)}
    entry["launches"] += sum(e["launches"]
                             for e in record["engine"].values())
    entry["launches_by_path"].update(
        {f"engine_{k}": e["launches"] for k, e in record["engine"].items()})

    # -- 7. flash_attention vs plain over the grid ------------------------
    plan = functools.partial(attn_kernel.plan,
                             sm_count=attn_kernel.device_sm_count(dev))
    grid_worst, grid_share, grid_paths = check_attention_grid(
        ops, ref, plan, dev)

    # -- 8. attention path: the op at eight full-width head geometries -----
    rng = np.random.default_rng(8)
    inputs = [attention_inputs(rng, c["shape"], c["dtype"], dev)
              for c in ATTN_FULL]
    kwargs = [dict(causal=c["causal"], window=c["window"],
                   q_offset=c["q_offset"]) for c in ATTN_FULL]
    plans = [plan(*c["shape"], c["dtype"], **kw)
             for c, kw in zip(ATTN_FULL, kwargs)]
    planned = [p.launches for p in plans]
    torch.cuda.synchronize()
    ops.reset_launches()
    outs, case_launches = [], []
    for x, kw in zip(inputs, kwargs):
        before = ops.attention_launches
        outs.append(ops.attention(*x, **kw))
        case_launches.append(ops.attention_launches - before)
    torch.cuda.synchronize()
    attn_launches, gemm_launches = ops.attention_launches, ops.launches
    if case_launches != planned or gemm_launches:
        raise AssertionError(f"attention launches {case_launches} for "
                             f"{len(ATTN_FULL)} calls, planned {planned} "
                             f"(vta_gemm {gemm_launches})")
    stats = []
    for case, x, kw, out in zip(ATTN_FULL, inputs, kwargs, outs):
        try:
            stats.append(attention_err(out, ref.attention_ref(*x, **kw)))
        except AssertionError as exc:
            raise AssertionError(f"{case['name']}: kernel != plain: "
                                 f"{exc}") from None
    del outs
    print(f"attention path: {len(ATTN_FULL)} full-width calls, attention "
          f"launches {attn_launches} {case_launches} (planned "
          f"{planned}), all within "
          f"tolerance of the plain version")
    controls = tolerance_controls(ref, inputs[2], kwargs[2])
    by_name = {c["name"]: i for i, c in enumerate(ATTN_FULL)}
    i = by_name["whisper-base cross-attention"]
    f32_control = f32_controls(ref, inputs[i], kwargs[i])

    # -- 9. times at the full-width cases, bound, SDPA yardstick ----------
    import torch.nn.functional as F
    rows = []
    for case, (q, k, v), kw, st, p, n in zip(ATTN_FULL, inputs, kwargs,
                                             stats, plans, case_launches):
        b, h, hkv, sq, skv, d = case["shape"]
        err = st["max_abs_err"]
        sm_scale = d ** -0.5
        kernel_fn = lambda: ops.attention(q, k, v, **kw)
        plain_fn = lambda: ref.attention_ref(q, k, v, **kw)
        if case["sdpa_causal"] is None:     # the same function needs a mask
            mask = ref.attention_mask(sq, skv, case["causal"], case["window"],
                                      case["q_offset"], dev)
            lib_fn = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=sm_scale, enable_gqa=True)
        else:
            lib_fn = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=case["sdpa_causal"], scale=sm_scale,
                enable_gqa=True)
        try:
            lib_err = attention_err(lib_fn(), plain_fn(),
                                    SDPA_TOL)["max_abs_err"]
        except AssertionError as exc:
            raise AssertionError(f"{case['name']}: SDPA != plain: "
                                 f"{exc}") from None
        t_bound, bound_by = attention_bound(case)
        row = {"case": case["name"], "config": "src/repro/configs/"
               + case["config"], "shape_b_h_hkv_sq_skv_d": list(case["shape"]),
               "dtype": str(case["dtype"]).replace("torch.", ""),
               "causal": case["causal"], "window": case["window"],
               "q_offset": case["q_offset"], "path": p.path,
               "grid": list(p.grid), "blocks": p.blocks, "splits": p.splits,
               "chunk": p.chunk, "block_q": p.block_q,
               "block_kv": p.block_kv, "smem_bytes": p.smem_bytes,
               "launches": n, "max_abs_err": err,
               "mismatch_share": st["mismatch_share"],
               "sdpa_mask": ("explicit bool" if case["sdpa_causal"] is None
                             else "is_causal" if case["sdpa_causal"]
                             else "none"),
               "kept_pairs_per_head": kept_pairs(
                   sq, skv, case["causal"], case["window"], case["q_offset"]),
               "kernel_ms": graph_ms(kernel_fn, *ATTN_WINDOW),
               "call_ms": cuda_ms(kernel_fn, 10, 2),
               "plain_ms": graph_ms(plain_fn, *ATTN_WINDOW),
               "plain_call_ms": cuda_ms(plain_fn, 10, 2),
               "library_ms": graph_ms(lib_fn, *ATTN_WINDOW),
               "library_call_ms": cuda_ms(lib_fn, 10, 2),
               "library_max_abs_err": lib_err,
               "bound_ms": t_bound, "bound_by": bound_by}
        row["share_of_bound"] = t_bound / row["kernel_ms"]
        # after the kernel's own timing, so the library's heavier runs do
        # not precede it
        backends = (sdpa_backends(ref, (q, k, v), kw, case)
                    if case["dtype"] == torch.float32 else None)
        if backends is not None:
            # the CUDA-core bound beside the tensor-core one; the library
            # time is the fastest backend within 2e-5
            row["bound_cuda_cores_ms"] = attention_bound(case, True)[0]
            row["share_of_cuda_cores_bound"] = (row["bound_cuda_cores_ms"]
                                                / row["kernel_ms"])
            row["sdpa"] = backends
            row["library_default_ms"] = row["library_ms"]
            if backends["fastest_ms"] is not None:
                row["library_ms"] = backends["fastest_ms"]
        rows.append(row)
        print(f"  {row['case']:30s} {p.path} blocks {p.blocks} splits "
              f"{p.splits} launches {n}: "
              f"kernel {row['kernel_ms']:.4f} ms (per call "
              f"{row['call_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
              f"SDPA {row['library_ms']:.4f} ms"
              + (f" ({backends['fastest_within_2e-5']}; default call "
                 f"{row['library_default_ms']:.4f} ms, "
                 f"{backends['default_backend']})" if backends else "")
              + f", bound {t_bound:.4f} ms "
              f"({bound_by}), share {row['share_of_bound']:.4f}"
              + (f" (CUDA-core bound {row['bound_cuda_cores_ms']:.4f} ms, "
                 f"share {row['share_of_cuda_cores_bound']:.4f})"
                 if backends else "") + ", max |diff| "
              f"{err:.3g}, values that differ {st['mismatch_share']:.4f}")
    ab = {}
    for name, other in (("qwen2.5-3b chunked prefill", 1),
                        ("gemma3-1b local layer", 2),
                        ("whisper-base cross-attention", 1)):
        i = by_name[name]
        ab[name] = split_ab(attn_kernel, inputs[i], kwargs[i], plans[i],
                            other)
        print(f"  KV split A/B, {name}: " + ", ".join(
            f"{key} ({arm['blocks']} blocks) "
            + " ".join(f"{t:.4f}" for t in arm["kernel_ms"]) + " ms"
            for key, arm in ab[name].items()))
    ops_bound = sum(r["bound_ms"] for r in rows
                    if r["bound_by"] == "operations")
    attn_total = lambda key: sum(r[key] for r in rows)
    record["kernels"].append({
        "name": "flash_attention", "route": "cuda",
        "source": ("src/repro_torch/kernels/csrc/flash_attention_bf16.cu, "
                   "src/repro_torch/kernels/csrc/flash_attention.cu"),
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": attn_launches,
        "max_abs_err": max([*(st["max_abs_err"] for st in stats),
                            *grid_worst.values()]),
        "grid_max_abs_err_float32": grid_worst[torch.float32],
        "grid_max_abs_err_bfloat16": grid_worst[torch.bfloat16],
        "grid_max_mismatch_share_bfloat16": grid_share[torch.bfloat16],
        "grid_cases_per_path": grid_paths,
        "sass_bf16": record["sass_bf16"],
        "sass_f32": record["sass_f32"],
        "ptxas_f32": attn_ptxas,
        "tolerance_controls": controls,
        "f32_tolerance_controls": f32_control,
        "ms": attn_total("kernel_ms"), "plain_ms": attn_total("plain_ms"),
        "bound_ms": attn_total("bound_ms"),
        "bound_by": ("operations" if 2 * ops_bound >= attn_total("bound_ms")
                     else "bytes"),
        "library_ms": attn_total("library_ms"),
        "library_default_ms": sum(r.get("library_default_ms",
                                        r["library_ms"]) for r in rows),
        "call_ms": attn_total("call_ms"),
        "plain_call_ms": attn_total("plain_call_ms"),
        "per": ("the attention path: one call at each of the eight full-width "
                "cases (launches counts every kernel, the combine kernel "
                "after a split too); ms = device time (CUDA-graph replay, "
                "200 calls a case), call_ms = back-to-back calls between "
                "CUDA events; "
                "library_ms is SDPA, with the boolean mask built once before "
                "timing where is_causal is not the same function, and at "
                "the float32 cases the fastest backend within 2e-5 "
                "(library_default_ms: the default call); kernel, plain and "
                "every SDPA time over the same 200 calls; bound_ms counts "
                "float32 as three TF32 products at 495 TFLOP/s, the faster "
                "of that and 67 TFLOP/s on the CUDA cores (each float32 "
                "case also has bound_cuda_cores_ms); bound_by names the "
                "larger share of the summed bound"),
        "cases": rows,
        "split_ab": ab,
    })

    # -- 10. the float front door: train, quantise, serve the test split ----
    rng = np.random.default_rng(10)
    record["front_door"] = {
        name: front_door_phase(ops, ref, kernel, sms, rng, name, dev,
                               retrain=name == "lenet5")
        for name in ("lenet5", "resnet8")}
    # -- 11. the projection: oracle, kernel and plain version --------------
    record["projection"] = projection_phase(ops, dev)
    for name, fd in record["front_door"].items():
        entry["launches"] += fd["launches"]
        entry["launches_by_path"][f"front_door_{name}"] = fd["launches"]
    entry["launches"] += record["projection"]["launches"]
    entry["launches_by_path"]["projection"] = record["projection"]["launches"]
    entry["front_door_stack_gemm"] = {
        name: {**fd["stack_gemm"], "batch": FRONT_DOOR["batch"],
               "launches_per_stack": fd["layers"]}
        for name, fd in record["front_door"].items()}

    # -- 12. the torch interpreters on the card ---------------------------
    models = [("lenet5", net, images,
               lambda img: reference_forward_int8(weights, img, shifts)[0],
               5)] + cnns
    record["interpreters"] = interpreter_phase(ops, models, card, dev)
    # -- 13. guarded serving: the batch, its shadow, the engine ------------
    record["guarded"] = guarded_phase(ops, models[:2], card, dev)
    # -- 14. the reference's seeded SEU campaign ---------------------------
    record["campaign"] = campaign_phase(card, dev)
    for key, path in (("interpreters", "interpreters_cuda_serves"),
                      ("guarded", "guarded_shadow")):
        entry["launches"] += record[key]["launches"]
        entry["launches_by_path"][path] = record[key]["launches"]

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
