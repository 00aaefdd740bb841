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
   operands at an odd address (the bytes path); then repeats the
   one-stage ``vec16`` geometries (``repeat_check``: the grid's first
   case, (25088, 32, 16), and every ``vec16`` tile forced with one ring
   stage) ``REPEAT_RUNS`` times each into fresh output buffers filled
   with a sentinel byte, counting the elements that differ from the plain
   version and those never written — any difference fails the run;
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
   on ``device="cpu"``; prints each arm's seconds;
15. serves qwen2.5-3b at full width (36 layers, d 2048, 16 heads over 2,
   vocab 151936; seeded float32 weights, 3.40 B parameters, TF32 off)
   through the port's LM ``Server`` (batch 4, ``max_seq`` 1280): 8
   requests with prompts of 768–1024 tokens (seed 15) and 16 new tokens
   each, two generations, after a warm prefill and step.  Every causal
   self-attention call of prefill and dense decode runs the float32
   ``flash_attention`` kernel: the attention launches, counted from 0 over
   the serve, must equal the sum of ``flash_attention.plan(...).launches``
   of every call (one a layer in prefill, a split and its combine a layer
   a decode step); every logit finite, every token below the vocabulary.
   Generation 1 is replayed teacher-forced on the plain path
   (``layers.plain_attention``: ``chunked_attention`` and
   ``_attn_scores_decode``) and each call's logits must agree within
   ``LM_TOL`` × max |plain logit|.  Prints prefill ms a generation, the
   median decode step, tokens/s and peak memory; a profiled prefill and
   decode step (the attention kernels' device time beside the step's, the
   idle share); the decode and prefill bounds; and the two attention
   calls of the path timed alone (kernel, plain, SDPA, bound; their
   launches and times in the ``flash_attention`` entry as ``lm_calls``,
   the serve's launches added to its ``launches``; ``lm_serve`` in the
   record);
16. runs the paper's §3.4 quickstart (``python -m repro_torch.quickstart``:
   ReLU(A·B) at 16×16 on the oracle and on one ``vta_gemm`` launch, bit for
   bit); runs the card test of the eleven LM smoke configs
   (``tests/test_torch_card.py -k lm_prefill_and_decode`` in a pytest
   process: the seven dense ones, mixtral, moonshot, jamba and rwkv6, each
   in float32, bf16 and bf16 over a float32 cache, kernel path against the
   plain path, launches against the plans; qwen1.5-110b smoke's head dim 8
   runs padded to 16); serves moonshot-v1-16b-a3b at full width (48
   layers, d 2048, 16 heads, head dim 128, 64 experts top-6, d_ff 1408,
   vocab 163840; seeded bf16 weights, 28.06 B parameters) through the LM
   ``Server`` (batch 4, ``max_seq`` 1280, bf16 cache): 8 requests of
   768–1024 prompt tokens (seed 16), 16 new tokens each, two generations;
   attention launches equal to the plans' sum (``bf16_tiles`` prefill,
   ``bf16_split`` decode), logits finite, tokens in the vocabulary; a
   kernel-path replay of generation 1 with every attention call held to
   its plain version on its own operands; the plain-path replay's logits
   against ``MOE_TOL`` with the router-flip share of each call (reported);
   prefill and decode times, tokens/s, peak memory, a profiled prefill and
   decode step, the bounds, and the two attention calls alone against
   their bound and SDPA (``moe_serve``; its calls added to the attention
   entry's ``lm_calls``); then frees those weights and serves rwkv6-7b at
   full width (32 layers, d 4096, seeded float32 weights, 7.53 B
   parameters, TF32 off): one generation of 4 prompts (the longest a
   multiple of the WKV chunk) and 16 new tokens, logits finite, and a
   960-token prefill plus 64 teacher-forced decode steps leaving every
   layer's ``wkv`` state and the last logits within ``RWKV_TOL`` of one
   1024-token prefill (``rwkv_serve``);
17. trains on the card (``train`` in the record): the card tests of
   training (``tests/test_torch_card.py -k "lm_train_step or
   attention_grad"`` in a pytest process: one float32 train step of each
   LM smoke config and two with remat, kernel path against plain path,
   launches against the plans; the attention op under grad in float32
   and bf16, its gradients exactly the plain version's); lm100m at its
   published width (96 M float32 parameters, remat ``dots``) through
   ``launch.train.train``: 100 steps of 32 × 256 tokens in 2
   microbatches, lr 1e-3, a checkpoint every 25 steps and a failure
   injected before step 60 — one restart, the replayed steps' losses
   equal to their first pass (rtol 1e-5), the last loss below the first,
   attention launches = (forward + recompute) × layers × microbatches ×
   steps run × the plan's, step 1's loss within 1e-4 and grad norm
   within 1e-3 of the same step inside ``layers.plain_attention``, steps
   2-5 within those limits or ten times the distance of a control run
   with the kernel's split-TF32 arithmetic emulated in its place (the
   plain run goes on to step 100, its distance reported); qwen2.5-3b at
   its published width (3.40 B float32 parameters, remat ``full``): 3 AdamW
   steps on one 4 × 1024 batch, losses finite and falling, launches
   against the plans, step 1 within 1e-3 of the plain path's; for both,
   the median step time, tokens/s, peak memory, a profiled step (device
   time, idle share, the attention kernels and the plain backward's
   range, top device ops) and the step's bound (6 × N × tokens, 2 more
   × the blocks' N under remat ``full``, plus attention, at 67
   TFLOP/s); and the attention op alone at the two
   training shapes: under grad its output within 2e-5 of
   ``attention_ref`` and its gradients equal to ``chunked_attention``'s,
   the kernel's forward beside SDPA's and the bound,
   the plain recompute-and-backward beside SDPA's backward (the
   attention entry's ``train_calls``; the training launches added to its
   ``launches``);
18. runs the mesh layer (``mesh`` in the record) with one rank a visible
   card, W = ``torch.cuda.device_count()`` (at most 4), spawned from here
   over NCCL (W printed): lm100m at its published width through
   ``launch.train.train`` on mesh (1, W), phase 17's configuration for 20
   steps, a checkpoint every 10 written under the mesh and a failure
   before step 15 (one restart onto the mesh, the replayed losses within
   1e-5 of the first pass), attention launches a rank equal to the plans'
   sum on the local shapes, the losses within 1e-6 (W = 1) or 2e-4 of
   phase 17's unsharded first 20 (bit-equality reported), the median
   step and tokens/s, and one profiled step on the mesh (device time and
   idle share beside phase 17's profiled step); the same run's first 5
   steps with
   ``grad_compression="int8_pod"`` on a (1, 1, W) pod mesh, every
   compressed gradient equal to ``compress_replica`` (the reference's
   ``_compress_body`` in numpy, n_pods = 1) bit for bit and the losses
   within ``MESH_POD_RTOL`` of the uncompressed run's (step 1 within
   1e-6), the parameters after step 1 equal to an AdamW step from the
   initial state on step 1's compressed gradients; and qwen2.5-3b at full width in float32: a 4 × 128 prefill and
   7 greedy decode steps through ``serving.engine`` unsharded (phase 15's
   path), then the same tokens on mesh (1, W) with the
   ``cache_pack``-placed cache, every step's logits within 1e-3 × max
   |logit| of the unsharded ones, launches equal to the plans' sum, and
   one more decode step profiled on each path; the phase's launches are
   added to the attention entry's.
19. runs the dry run (``dryrun`` in the record): a process without
   the card (a fake process group, every tensor on ``meta``; started
   before phase 17, its traces run on the host beside phases 17–18)
   traces qwen2.5-3b's decode_32k and train_4k cells on 16×16 through
   ``launch.dryrun.run_cell`` (their JSON and trace seconds printed) and
   the meta traces of two steps at mesh (1, 1) — lm100m's training step
   in phase 17's configuration and qwen2.5-3b's decode step over phase
   18's cache — while a rank over NCCL places the same steps for real
   and runs each once under ``analysis.op_cost`` inside
   ``plain_attention``: every op must equal the meta trace's (op,
   operand shapes and dtypes, FLOPs, bytes, fused bytes, collectives;
   any difference itemised), the argument bytes the placed trees' local
   bytes.  Then each step runs on the kernel path (attention launches
   equal to the plans' sum) and once profiled: device time beside the
   terms FLOPs / 67 TFLOP/s and bytes / 3.35 TB/s, and the predicted
   peak memory (arguments + the trace's storage peak) beside
   ``torch.cuda.max_memory_allocated`` (reported).

It then prints one JSON line ``{"kernels": [...]}`` (both kernels) before
the last line.  ``python3 chip_smoke.py --only 3,18,19`` builds and runs
phases 3, 18 and/or 19 alone (a development run: phase 18 then computes
its own unsharded baseline, and no kernel line is printed).  Any failure raises and exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The full record also goes to ``chiprun_out/chip_smoke.json``.
"""

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

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
REPEAT_RUNS = 256                  # phase 3's one-stage vec16 repeat
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


def repeat_check(ref, dev, reps: int = REPEAT_RUNS) -> dict:
    """Phase 3's repeat of the one-stage ``vec16`` geometries: phase 3's
    first case, (M, K, N) = (25088, 32, 16) through its own plan, and
    every ``vec16`` instantiation forced with one ring stage at (196·bm,
    32·k_split, bn), int8 out with no bias, relu, shift or saturation,
    ``reps`` times each.  Every run writes into a fresh output buffer
    filled with a sentinel byte (0x5A and 0xA5 in turns: an element the
    kernel never wrote is caught by the turn whose sentinel its true value
    is not), and is compared with the plain version.  Counts the elements
    that differ and, of them, those that still hold the sentinel (never
    written); any difference raises after all the runs."""
    from repro_torch.kernels import vta_gemm as vg
    rng = np.random.default_rng(3)
    sms = vg.device_sm_count(dev)
    cases = [(25088, 32, 16, vg.plan(25088, 32, 16, sm_count=sms))]
    for bm, bn, ks, load in vg.INSTANTIATIONS:
        if load == "vec16":
            m, k, n = 196 * bm, 32 * ks, bn
            cases.append((m, k, n, vg.make_plan(m, k, n, bm, bn, ks, load)))
    runs = differing = unwritten = 0
    bad = []
    for m, k, n, p in cases:
        if p.stages != 1 or p.load != "vec16":
            raise AssertionError(f"repeat case {(m, k, n)}: plan {p} is not "
                                 f"one-stage vec16")
        a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(
            np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(
            np.int8)).to(dev)
        kw = dict(relu=False, shift=0, saturate=False)
        want = ref.vta_gemm_ref(a, b, None, out_dtype=torch.int8, **kw)
        case_diff = case_unwritten = 0
        for r in range(reps):
            sentinel = (0x5A, -0x5B)[r % 2]         # 0x5A, 0xA5
            out = torch.full((m, n), sentinel, dtype=torch.int8, device=dev)
            vg._launch(a, b, None, out, p, **kw)
            wrong = out != want
            case_diff += int(wrong.sum())
            case_unwritten += int((wrong & (out == sentinel)).sum())
            runs += 1
        if case_diff:
            bad.append({"shape": [m, k, n], "tile": [p.bm, p.bn, p.k_split],
                        "differing": case_diff, "unwritten": case_unwritten})
        differing += case_diff
        unwritten += case_unwritten
    torch.cuda.synchronize()
    out = {"cases": len(cases), "reps_per_case": reps, "runs": runs,
           "differing_elements": differing, "unwritten_elements": unwritten,
           "faulty_cases": bad}
    print(f"vta_gemm one-stage vec16 repeat: {len(cases)} geometries x "
          f"{reps} runs = {runs} runs on fresh sentinel-filled buffers; "
          f"{differing} elements differ from the plain version, "
          f"{unwritten} of them never written")
    if differing:
        raise AssertionError(f"vta_gemm repeat check: {bad}")
    return out


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


# -- phase 15: the LM server at full width ------------------------------------

LM_ARCH = "qwen2.5-3b"             # src/repro_torch/configs/qwen2_5_3b.py
LM_BATCH, LM_MAX_SEQ = 4, 1280
LM_REQUESTS, LM_NEW = 8, 16        # two generations of four
LM_PROMPT = (768, 1024)            # prompt lengths, drawn from seed 15
# kernel path against the plain path, teacher-forced: max |diff| of each
# call's logits at most LM_TOL × that call's max |plain logit| (the kernel
# holds 2e-5 a call; 36 layers of float32 residual stream lie between)
LM_TOL = 1e-3
LM_DECODE_POS = 1000               # the decode call timed alone


ATTN_KERNEL_NAMES = ("f32_kernel", "tiles_kernel", "split_kernel",
                     "combine_kernel")      # the attention sources' kernels


def lm_profile(fn, range_name: Optional[str] = None) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the attention kernels'
    device time (``ATTN_KERNEL_NAMES``), every device event's, the host
    clock of the traced call and the idle share; with ``range_name``, the
    device span of the ``record_function`` ranges of that name
    (``range_ms``; ``None`` where the trace carries no device-side
    range), kept out of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [e for e in device if e.name == range_name]
    events = [e for e in device if e.name != range_name]
    attn = [e for e in events
            if any(name in e.name for name in ATTN_KERNEL_NAMES)]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    out = {"attention_kernel_ms": sum(e.time_range.elapsed_us()
                                      for e in attn) / 1e3,
           "attention_kernels": len(attn),
           "device_busy_ms": busy_ms, "traced_wall_ms": wall,
           "idle_share": 1.0 - busy_ms / wall,
           "device_events": len(events),
           "top_device_ops": [{"name": name[:90], "ms": ms, "count": n}
                              for name, (ms, n) in top]}
    if range_name is not None:
        out["range_ms"] = (sum(e.time_range.elapsed_us() for e in ranges)
                           / 1e3 if ranges else None)
        out["ranges"] = len(ranges)
    return out


def lm_call_case(ops, ref, fa, name, shape, q_offset, sms, dev,
                 dtype=torch.float32) -> dict:
    """One attention call of the LM path alone at its shape and dtype:
    kernel against ``ref.attention_ref`` (``ATTN_TOL``), device times of
    the kernel, the plain version and SDPA (causal: ``is_causal``; decode:
    an explicit bool mask, built before timing), its launches and bound
    (the keys the masks keep, read once)."""
    import torch.nn.functional as F
    b, h, hkv, sq, skv, d = shape
    x = attention_inputs(np.random.default_rng(150), shape, dtype, dev)
    kw = dict(causal=True, window=None, q_offset=q_offset)
    p = fa.plan(*shape, dtype, **kw, sm_count=sms)
    before = ops.attention_launches
    got = ops.attention(*x, **kw)
    launches = ops.attention_launches - before
    want = ref.attention_ref(*x, **kw)
    st = attention_err(got, want)
    if launches != p.launches:
        raise AssertionError(f"{name}: {launches} launches, planned "
                             f"{p.launches}")
    if q_offset == 0 and sq == skv:
        lib = lambda: F.scaled_dot_product_attention(
            *x, is_causal=True, scale=d ** -0.5, enable_gqa=True)
    else:
        mask = ref.attention_mask(sq, skv, True, None, q_offset, dev)
        lib = lambda: F.scaled_dot_product_attention(
            *x, attn_mask=mask, scale=d ** -0.5, enable_gqa=True)
    lib_err = attention_err(lib(), want, SDPA_TOL)["max_abs_err"]
    kept = dict(shape=(b, h, hkv, sq, min(skv, q_offset + sq), d),
                dtype=dtype, causal=True, window=None, q_offset=q_offset)
    t_bound, bound_by = attention_bound(kept)
    row = {"case": name, "shape_b_h_hkv_sq_skv_d": list(shape),
           "dtype": str(dtype).replace("torch.", ""),
           "q_offset": q_offset, "path": p.path, "blocks": p.blocks,
           "splits": p.splits, "launches": launches,
           "max_abs_err": st["max_abs_err"],
           "mismatch_share": st["mismatch_share"],
           "kernel_ms": graph_ms(lambda: ops.attention(*x, **kw),
                                 *ATTN_WINDOW),
           "plain_ms": graph_ms(lambda: ref.attention_ref(*x, **kw),
                                *ATTN_WINDOW),
           "library_ms": graph_ms(lib, *ATTN_WINDOW),
           "library_max_abs_err": lib_err,
           "bound_ms": t_bound, "bound_by": bound_by}
    if dtype == torch.float32:
        row["bound_cuda_cores_ms"] = attention_bound(kept, True)[0]
    row["share_of_bound"] = t_bound / row["kernel_ms"]
    return row


def lm_phase(ops, ref, fa, card: str, dev) -> dict:
    """Phase 15: qwen2.5-3b at full width (seeded float32 weights, TF32
    off) served by the port's ``Server``: 8 requests in two generations of
    four, 16 new tokens each, every causal self-attention call on the
    ``flash_attention`` kernel.  The attention launches, counted from 0
    over the serve, must equal the sum of ``plan(...).launches`` of every
    call; every logit finite, every token below the vocabulary; then the
    first generation is replayed teacher-forced on the plain path
    (``layers.plain_attention``) and each call's logits must agree within
    ``LM_TOL``.  Reports prefill and decode times, tokens/s, peak memory,
    the attention kernels' device time in one prefill and one decode step
    beside the step's, and the two attention calls timed alone."""
    from repro_torch.configs import get_config
    from repro_torch.device import strict_float32
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import layers
    from repro_torch.models.params import init_params, param_count
    from repro_torch.models.transformer import model_defs
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import decode_step, prefill

    cfg = get_config(LM_ARCH)
    defs = model_defs(cfg)
    n_params = param_count(defs)
    sms = fa.device_sm_count(dev)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(
        LM_PROMPT[0], LM_PROMPT[1] + 1))).astype(np.int32)
        for _ in range(LM_REQUESTS)]
    shape = (LM_BATCH, cfg.n_heads, cfg.n_kv_heads)
    planned, calls = 0, 0
    for g in range(0, LM_REQUESTS, LM_BATCH):
        plen = max(len(p) for p in prompts[g:g + LM_BATCH])
        planned += cfg.n_layers * fa.plan(*shape, plen, plen, cfg.head_dim,
                                          torch.float32, sm_count=sms
                                          ).launches
        for t in range(LM_NEW - 1):
            planned += cfg.n_layers * fa.plan(
                *shape, 1, LM_MAX_SEQ, cfg.head_dim, torch.float32,
                q_offset=plen + t, sm_count=sms).launches
        calls += cfg.n_layers * LM_NEW
    out = {"arch": LM_ARCH, "card": card, "params": n_params,
           "batch": LM_BATCH, "max_seq": LM_MAX_SEQ,
           "requests": LM_REQUESTS, "new_tokens": LM_NEW,
           "prompt_lengths": [len(p) for p in prompts],
           "attention_calls": calls, "planned_launches": planned}
    with strict_float32():
        t0 = time.perf_counter()
        params = init_params(defs, seed=0, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        server = Server(cfg, params, batch_size=LM_BATCH,
                        max_seq=LM_MAX_SEQ, device=dev, record=True)
        for rid, p in enumerate(prompts):
            server.submit(Request(rid, p, LM_NEW))
        with torch.inference_mode():        # warm: a prefill and a step
            warm = init_cache(cfg, LM_BATCH, LM_MAX_SEQ, torch.float32, dev)
            toks = torch.zeros((LM_BATCH, LM_PROMPT[1]), dtype=torch.long,
                               device=dev)
            prefill(params, cfg, toks, warm)
            decode_step(params, cfg, warm, toks[:, 0], LM_PROMPT[1])
            del warm, toks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        results = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, gemm = ops.attention_launches, ops.launches
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        if launches != planned or gemm:
            raise AssertionError(f"LM serve: {launches} attention launches, "
                                 f"planned {planned} (vta_gemm {gemm})")
        tokens = [t for rid in sorted(results) for t in results[rid]]
        if (sorted(results) != list(range(LM_REQUESTS))
                or any(len(results[r]) != LM_NEW for r in results)
                or max(tokens) >= cfg.vocab or min(tokens) < 0):
            raise AssertionError(f"LM serve: results {results}")
        gens = server.generations
        for gen in gens:
            for logits in gen.logits:
                if not torch.isfinite(logits[:, :cfg.vocab]).all():
                    raise AssertionError("LM serve: a logit is not finite")
        prefill_s = [gen.seconds[0] for gen in gens]
        decode_s = sorted(s for gen in gens for s in gen.seconds[1:])
        out.update({
            "launches": launches, "serve_s": wall,
            "tokens": len(tokens), "tokens_per_s": len(tokens) / wall,
            "prefill_ms": [s * 1e3 for s in prefill_s],
            "decode_ms_median": decode_s[len(decode_s) // 2] * 1e3,
            "decode_ms_min": decode_s[0] * 1e3,
            "decode_ms_max": decode_s[-1] * 1e3,
            "steps_per_generation": [len(g.steps) for g in gens]})

        # teacher-forced replay of generation 1 on the plain path
        gen = gens[0]
        diffs = []
        before = ops.attention_launches
        with torch.inference_mode(), layers.plain_attention():
            t0 = time.perf_counter()
            cache = init_cache(cfg, LM_BATCH, LM_MAX_SEQ, torch.float32, dev)
            plain, cache = prefill(params, cfg,
                                   torch.from_numpy(gen.prompts).to(dev),
                                   cache)
            torch.cuda.synchronize()
            plain_prefill_s = time.perf_counter() - t0
            want = [plain]
            for fed, pos in gen.steps:
                plain, cache = decode_step(
                    params, cfg, cache,
                    torch.from_numpy(fed.astype(np.int64)).to(dev), pos)
                want.append(plain)
            del cache
        if ops.attention_launches != before:
            raise AssertionError("the plain replay launched the kernel")
        for i, (got, w) in enumerate(zip(gen.logits, want)):
            w = w[:, :cfg.vocab]
            err = float((got[:, :cfg.vocab] - w).abs().max())
            scale = float(w.abs().max())
            diffs.append({"call": "prefill" if i == 0 else f"decode {i}",
                          "max_abs_diff": err, "max_abs_logit": scale})
            if not err <= LM_TOL * scale:
                raise AssertionError(
                    f"LM {diffs[-1]['call']}: kernel path != plain path: "
                    f"max |diff| {err:.3g} > {LM_TOL} × {scale:.3g}")
        out["teacher_forced"] = {
            "tolerance": f"{LM_TOL} x max |plain logit| a call",
            "calls": diffs,
            "max_abs_diff": max(d["max_abs_diff"] for d in diffs),
            "max_rel_diff": max(d["max_abs_diff"] / d["max_abs_logit"]
                                for d in diffs),
            "plain_prefill_ms": plain_prefill_s * 1e3}
        del want, plain, gens, server

        # one prefill and one decode step under the profiler
        with torch.inference_mode():
            toks = torch.from_numpy(gen.prompts).to(dev)
            cache = init_cache(cfg, LM_BATCH, LM_MAX_SEQ, torch.float32, dev)
            out["profile_prefill"] = lm_profile(
                lambda: prefill(params, cfg, toks, cache))
            fed = torch.from_numpy(gen.steps[0][0].astype(np.int64)).to(dev)
            pos = gen.steps[0][1]
            decode_step(params, cfg, cache, fed, pos)      # warm
            out["profile_decode"] = lm_profile(
                lambda: decode_step(params, cfg, cache, fed, pos))
            for key in ("profile_prefill", "profile_decode"):
                prof = out[key]
                want_n = cfg.n_layers * (
                    fa.plan(*shape, *((toks.shape[1],) * 2), cfg.head_dim,
                            torch.float32, sm_count=sms).launches
                    if key == "profile_prefill" else
                    fa.plan(*shape, 1, LM_MAX_SEQ, cfg.head_dim,
                            torch.float32, q_offset=pos,
                            sm_count=sms).launches)
                if prof["attention_kernels"] not in (0, want_n):
                    raise AssertionError(f"{key}: {prof['attention_kernels']}"
                                         f" attention kernels traced, "
                                         f"planned {want_n}")
            del cache
        del params
    torch.cuda.empty_cache()

    # the two calls of the path alone
    d = cfg.head_dim
    out["calls"] = [
        lm_call_case(ops, ref, fa, "qwen2.5-3b LM prefill f32",
                     (*shape, LM_PROMPT[1], LM_PROMPT[1], d), 0, sms, dev),
        lm_call_case(ops, ref, fa, "qwen2.5-3b LM decode f32",
                     (*shape, 1, LM_MAX_SEQ, d), LM_DECODE_POS, sms, dev)]

    # bounds: decode reads every weight but the embedding table (4 of its
    # rows) and the kept K/V; prefill's products on the CUDA cores
    d_model, vp = cfg.d_model, cfg.vocab_padded
    layer_params = n_params - 2 * vp * d_model
    kv_bytes = (4 * cfg.n_layers * 2 * LM_BATCH * cfg.n_kv_heads
                * (LM_PROMPT[1] + 1) * d)
    decode_bytes = 4 * (n_params - vp * d_model + LM_BATCH * d_model) \
        + kv_bytes
    plen = max(len(p) for p in prompts[:LM_BATCH])
    prefill_ops = (2 * layer_params * LM_BATCH * plen
                   + 2 * d_model * vp * LM_BATCH
                   + cfg.n_layers * 4 * LM_BATCH * cfg.n_heads * d
                   * kept_pairs(plen, plen, True, None, 0))
    out["bounds"] = {
        "decode_weight_bytes_all": 4 * n_params,
        "decode_bytes": decode_bytes,
        "decode_ms": decode_bytes / HBM_BYTES_PER_S * 1e3,
        "prefill_ops": prefill_ops,
        "prefill_ms": prefill_ops / F32_OPS_PER_S * 1e3,
        "prefill_tokens": LM_BATCH * plen}
    bd = out["bounds"]
    pp, pd = out["profile_prefill"], out["profile_decode"]
    print(f"LM server ({card}): {LM_ARCH} full width, {n_params / 1e9:.3f} B "
          f"float32 parameters (init {out['init_s']:.2f} s), "
          f"{LM_REQUESTS} requests x {LM_NEW} tokens, prompts "
          f"{out['prompt_lengths']}: {len(tokens)} tokens in {wall:.3f} s "
          f"({out['tokens_per_s']:.2f} tokens/s); prefill "
          + ", ".join(f"{t:.1f}" for t in out["prefill_ms"])
          + f" ms a generation (plain-path replay "
          f"{out['teacher_forced']['plain_prefill_ms']:.1f} ms); decode "
          f"median {out['decode_ms_median']:.2f} ms a step (min "
          f"{out['decode_ms_min']:.2f}, max {out['decode_ms_max']:.2f}); "
          f"peak memory {out['peak_memory_bytes'] / 2**30:.2f} GiB")
    print(f"  attention launches {launches} = planned {planned} over "
          f"{calls} calls; teacher-forced kernel vs plain: max |diff| "
          f"{out['teacher_forced']['max_abs_diff']:.3g} "
          f"({out['teacher_forced']['max_rel_diff']:.3g} of max |logit|, "
          f"limit {LM_TOL})")
    print(f"  profiled prefill ({card}): attention kernels "
          f"{pp['attention_kernel_ms']:.3f} ms of {pp['device_busy_ms']:.3f} "
          f"ms device time, wall {pp['traced_wall_ms']:.3f} ms, idle share "
          f"{pp['idle_share']:.4f}; decode step: attention "
          f"{pd['attention_kernel_ms']:.4f} ms of {pd['device_busy_ms']:.3f} "
          f"ms, wall {pd['traced_wall_ms']:.3f} ms, idle share "
          f"{pd['idle_share']:.4f}")
    print(f"  bounds: decode reads {bd['decode_bytes'] / 1e9:.2f} GB (all "
          f"weights {bd['decode_weight_bytes_all'] / 1e9:.2f} GB) >= "
          f"{bd['decode_ms']:.3f} ms at 3.35 TB/s; prefill of "
          f"{bd['prefill_tokens']} tokens {bd['prefill_ops'] / 1e12:.2f} "
          f"TFLOP >= {bd['prefill_ms']:.1f} ms at 67 TFLOP/s")
    for row in out["calls"]:
        print(f"  {row['case']} {tuple(row['shape_b_h_hkv_sq_skv_d'])} "
              f"q_offset {row['q_offset']} ({card}): {row['path']} blocks "
              f"{row['blocks']} splits {row['splits']} launches "
              f"{row['launches']}: kernel {row['kernel_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}, share "
              f"{row['share_of_bound']:.3f}), max |diff| "
              f"{row['max_abs_err']:.3g}")
    return out


# -- phase 16: MoE, Mamba and RWKV-6 on the card ------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"   # src/repro_torch/configs/
MOE_BATCH, MOE_MAX_SEQ = 4, 1280
MOE_REQUESTS, MOE_NEW = 8, 16      # two generations of four
MOE_PROMPT = (768, 1024)           # prompt lengths, drawn from seed 16
# bf16 kernel path against the bf16 plain path, teacher-forced on the
# serve's routing: each call's max |diff| of logits against MOE_TOL × its
# max |plain logit| (PERF.md, written before the first run).  Reported, with
# the router-flip share: bf16 rounding through 48 random layers is expected
# to decorrelate the two paths' logits; the gate is every attention call of
# the path held to its plain version on its own operands
MOE_TOL = 5e-2
MOE_DECODE_POS = 1000              # the decode call timed alone
RWKV_ARCH = "rwkv6-7b"
RWKV_BATCH, RWKV_NEW = 4, 16
RWKV_PROMPT = (768, 1024)          # drawn from seed 16; longest rounded up
                                   # to a multiple of the WKV chunk (64)
RWKV_SPLIT = (960, 64)             # prefill + teacher-forced steps = 1024
RWKV_TOL = 1e-3                    # of max |value|: wkv states, logits
SMOKE_CARD_CASES = 33              # 11 smoke configs × 3 dtype pairs


def quickstart_phase(ops, dev) -> dict:
    """The paper's §3.4 example (``python -m repro_torch.quickstart``) on
    the card: the oracle and one ``vta_gemm`` launch, bit for bit."""
    import contextlib
    import io
    from repro_torch import quickstart
    ops.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = quickstart.main(["--device", str(dev)])
    launches = ops.launches
    text = said.getvalue()
    if rc != 0 or launches != 1 or "cuda (cuda:0): bit-exact" not in text:
        raise AssertionError(f"quickstart: rc {rc}, {launches} vta_gemm "
                             f"launches:\n{text}")
    print(f"quickstart (§3.4, ReLU(A·B) 16x16): oracle and cuda bit-exact, "
          f"{launches} vta_gemm launch")
    return {"launches": launches, "bit_exact": True}


def smoke_card_phase() -> dict:
    """The eleven LM smoke configs, kernel path against plain path
    (``tests/test_torch_card.py::test_lm_prefill_and_decode_kernel_
    matches_plain``, three dtype pairs each), in a pytest process of its
    own."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", "tests/test_torch_card.py", "-k",
         "lm_prefill_and_decode"], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    seconds = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    if proc.returncode != 0 or f"{SMOKE_CARD_CASES} passed" not in tail:
        raise AssertionError(f"LM smoke configs on the card: rc "
                             f"{proc.returncode}\n{proc.stdout[-6000:]}\n"
                             f"{proc.stderr[-3000:]}")
    print(f"LM smoke configs on the card (dense 7, MoE/Mamba/RWKV-6 4; "
          f"f32, bf16, bf16 over an f32 cache): {tail} in {seconds:.1f} s")
    return {"result": tail, "seconds": seconds}


class AttentionCallCheck:
    """While open, every ``ops.attention`` call on the card is also run on
    its plain version (``ref.attention_ref``) with the same operands and
    held to ``attention_err``'s tolerance for the dtype (bf16: also at
    most ``BF16_MISMATCH_LIMIT`` of the values differing)."""

    def __init__(self, ops, ref):
        self.ops, self.ref, self.real = ops, ref, ops.attention
        self.stats, self.failures = [], []

    def __enter__(self):
        def checked(q, k, v, **kw):
            out = self.real(q, k, v, **kw)
            kw.pop("backend", None)
            try:
                self.stats.append(attention_err(
                    out, self.ref.attention_ref(q, k, v, **kw)))
            except AssertionError as exc:
                self.failures.append(f"{tuple(q.shape)} {kw}: {exc}")
            return out
        self.ops.attention = checked
        return self

    def __exit__(self, *exc):
        self.ops.attention = self.real

    def summary(self) -> dict:
        return {"calls": len(self.stats),
                "max_abs_err": max(s["max_abs_err"] for s in self.stats),
                "max_mismatch_share": max(s["mismatch_share"]
                                          for s in self.stats),
                "failures": self.failures[:5]}


def moe_phase(ops, ref, fa, card: str, dev) -> dict:
    """Phase 16: moonshot-v1-16b-a3b at full width in bf16 (seeded
    weights) served by the port's ``Server``: 8 requests in two
    generations of four, 16 new tokens each, every causal self-attention
    call on the bf16 ``flash_attention`` kernels (``bf16_tiles`` prefill,
    ``bf16_split`` decode).  Gates: the attention launches equal the
    plans' sum, logits finite, tokens in the vocabulary; generation 1
    replayed teacher-forced on the kernel path with every attention call
    held to its plain version on the same operands.  Reported: the same
    replay on the plain path (``layers.plain_attention``, the serve's
    routing through ``moe.routing_log``), each call's max |diff| / max
    |logit| against ``MOE_TOL``, and the share of (layer, token) whose
    expert set the plain path's own router would have picked otherwise.
"""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import layers, moe
    from repro_torch.models.params import init_params, param_count
    from repro_torch.models.transformer import model_defs
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import decode_step, prefill

    bf16 = torch.bfloat16
    cfg = get_config(MOE_ARCH)
    defs = model_defs(cfg)
    n_params = param_count(defs)
    d = fa.padded_head_dim(cfg.head_dim)
    sms = fa.device_sm_count(dev)
    print(f"MoE LM ({card}): {MOE_ARCH} full width: {cfg.n_layers} layers, "
          f"d {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, "
          f"head dim {cfg.head_dim}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} (d_ff {cfg.moe.d_ff_expert}), vocab {cfg.vocab}: "
          f"{n_params / 1e9:.3f} B parameters, {2 * n_params / 1e9:.2f} GB "
          f"of bf16 weights")
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(
        MOE_PROMPT[0], MOE_PROMPT[1] + 1))).astype(np.int32)
        for _ in range(MOE_REQUESTS)]
    shape = (MOE_BATCH, cfg.n_heads, cfg.n_kv_heads)
    planned, calls, plens = 0, 0, []
    for g in range(0, MOE_REQUESTS, MOE_BATCH):
        plen = max(len(p) for p in prompts[g:g + MOE_BATCH])
        plens.append(plen)
        planned += cfg.n_layers * fa.plan(*shape, plen, plen, d, bf16,
                                          sm_count=sms).launches
        for t in range(MOE_NEW - 1):
            planned += cfg.n_layers * fa.plan(
                *shape, 1, MOE_MAX_SEQ, d, bf16, q_offset=plen + t,
                sm_count=sms).launches
        calls += cfg.n_layers * MOE_NEW
    out = {"arch": MOE_ARCH, "card": card, "params": n_params,
           "weight_bytes": 2 * n_params, "dtype": "bfloat16",
           "batch": MOE_BATCH, "max_seq": MOE_MAX_SEQ,
           "requests": MOE_REQUESTS, "new_tokens": MOE_NEW,
           "prompt_lengths": [len(p) for p in prompts],
           "attention_calls": calls, "planned_launches": planned}
    t0 = time.perf_counter()
    params = init_params(defs, seed=0, dtype=bf16, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["weights_allocated_bytes"] = torch.cuda.memory_allocated(dev)
    server = Server(cfg, params, batch_size=MOE_BATCH, max_seq=MOE_MAX_SEQ,
                    dtype=bf16, device=dev, record=True)
    for rid, p in enumerate(prompts):
        server.submit(Request(rid, p, MOE_NEW))
    with torch.inference_mode():            # warm: a prefill and a step
        warm = init_cache(cfg, MOE_BATCH, MOE_MAX_SEQ, bf16, dev)
        toks = torch.zeros((MOE_BATCH, MOE_PROMPT[1]), dtype=torch.long,
                           device=dev)
        prefill(params, cfg, toks, warm)
        decode_step(params, cfg, warm, toks[:, 0], MOE_PROMPT[1])
        del warm, toks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with moe.routing_log() as kernel_routes:
        ops.reset_launches()
        t0 = time.perf_counter()
        results = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, gemm = ops.attention_launches, ops.launches
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        if launches != planned or gemm:
            raise AssertionError(f"MoE serve: {launches} attention launches,"
                                 f" planned {planned} (vta_gemm {gemm})")
        tokens = [t for rid in sorted(results) for t in results[rid]]
        if (sorted(results) != list(range(MOE_REQUESTS))
                or any(len(results[r]) != MOE_NEW for r in results)
                or max(tokens) >= cfg.vocab or min(tokens) < 0):
            raise AssertionError(f"MoE serve: results {results}")
        gens = server.generations
        for gen in gens:
            for logits in gen.logits:
                if not torch.isfinite(logits[:, :cfg.vocab].float()).all():
                    raise AssertionError("MoE serve: a logit is not finite")
        prefill_s = [gen.seconds[0] for gen in gens]
        decode_s = sorted(s for gen in gens for s in gen.seconds[1:])
        out.update({
            "launches": launches, "serve_s": wall,
            "tokens": len(tokens), "tokens_per_s": len(tokens) / wall,
            "prefill_ms": [s * 1e3 for s in prefill_s],
            "decode_ms_median": decode_s[len(decode_s) // 2] * 1e3,
            "decode_ms_min": decode_s[0] * 1e3,
            "decode_ms_max": decode_s[-1] * 1e3,
            "steps_per_generation": [len(g.steps) for g in gens]})
    del kernel_routes[cfg.n_layers * MOE_NEW:]              # generation 1
    gen = gens[0]

    def replay(plain: bool):
        """Generation 1 teacher-forced on the serve's routing: its logits
        and the routes its own router picked."""
        scope = layers.plain_attention() if plain else \
            contextlib.nullcontext()
        with torch.inference_mode(), scope, \
                moe.routing_log(replay=kernel_routes) as own:
            cache = init_cache(cfg, MOE_BATCH, MOE_MAX_SEQ, bf16, dev)
            logits, cache = prefill(params, cfg,
                                    torch.from_numpy(gen.prompts).to(dev),
                                    cache)
            seen = [logits]
            for fed, pos in gen.steps:
                logits, cache = decode_step(
                    params, cfg, cache,
                    torch.from_numpy(fed.astype(np.int64)).to(dev), pos)
                seen.append(logits)
        return seen, own

    # every attention call of the kernel path against its plain version on
    # the same operands
    with AttentionCallCheck(ops, ref) as checked:
        replay(plain=False)
    out["attention_calls_checked"] = checked.summary()
    if (checked.summary()["calls"] != cfg.n_layers * MOE_NEW
            or checked.failures):
        raise AssertionError(f"MoE replay: attention calls against the "
                             f"plain version: {checked.summary()}")
    # the plain path (teacher-forced, the serve's routing)
    before = ops.attention_launches
    want, plain_routes = replay(plain=True)
    if ops.attention_launches != before:
        raise AssertionError("the plain replay launched the kernel")
    diffs = []
    for i, (got, w) in enumerate(zip(gen.logits, want)):
        w = w[:, :cfg.vocab].float()
        err = float((got[:, :cfg.vocab].float() - w).abs().max())
        scale = float(w.abs().max())
        layer_calls = slice(i * cfg.n_layers, (i + 1) * cfg.n_layers)
        differ = [(a.sort(-1).values != b.sort(-1).values).any(-1)
                  .float().mean() for a, b in zip(
                      kernel_routes[layer_calls], plain_routes[layer_calls])]
        diffs.append({"call": "prefill" if i == 0 else f"decode {i}",
                      "max_abs_diff": err, "max_abs_logit": scale,
                      "rel_diff": err / scale, "within_limit":
                      bool(torch.isfinite(w).all()) and err <= MOE_TOL * scale,
                      "router_flip_share": float(torch.stack(differ).mean())})
    out["teacher_forced"] = {
        "tolerance": f"{MOE_TOL} x max |plain logit| a call, the plain path "
                     f"on the kernel path's routing (reported; a miss is "
                     f"recorded with the router-flip share)",
        "calls": diffs,
        "max_rel_diff": max(x["rel_diff"] for x in diffs),
        "calls_within_limit": sum(x["within_limit"] for x in diffs),
        "max_router_flip_share": max(x["router_flip_share"] for x in diffs),
        "calls_with_a_flip": sum(x["router_flip_share"] > 0 for x in diffs)}
    del want, kernel_routes, plain_routes, results

    # one prefill and one decode step under the profiler
    with torch.inference_mode():
        toks = torch.from_numpy(gen.prompts).to(dev)
        cache = init_cache(cfg, MOE_BATCH, MOE_MAX_SEQ, bf16, dev)
        out["profile_prefill"] = lm_profile(
            lambda: prefill(params, cfg, toks, cache))
        fed = torch.from_numpy(gen.steps[0][0].astype(np.int64)).to(dev)
        pos = gen.steps[0][1]
        decode_step(params, cfg, cache, fed, pos)          # warm
        out["profile_decode"] = lm_profile(
            lambda: decode_step(params, cfg, cache, fed, pos))
        for key in ("profile_prefill", "profile_decode"):
            prof = out[key]
            want_n = cfg.n_layers * (
                fa.plan(*shape, *((toks.shape[1],) * 2), d, bf16,
                        sm_count=sms).launches
                if key == "profile_prefill" else
                fa.plan(*shape, 1, MOE_MAX_SEQ, d, bf16, q_offset=pos,
                        sm_count=sms).launches)
            if prof["attention_kernels"] not in (0, want_n):
                raise AssertionError(f"{key}: {prof['attention_kernels']} "
                                     f"attention kernels traced, planned "
                                     f"{want_n}")
        del cache
    del params, gens, server, gen
    torch.cuda.empty_cache()                # the weights go before rwkv6

    out["calls"] = [
        lm_call_case(ops, ref, fa, f"{MOE_ARCH} LM prefill bf16",
                     (*shape, MOE_PROMPT[1], MOE_PROMPT[1], d), 0, sms, dev,
                     bf16),
        lm_call_case(ops, ref, fa, f"{MOE_ARCH} LM decode bf16",
                     (*shape, 1, MOE_MAX_SEQ, d), MOE_DECODE_POS, sms, dev,
                     bf16)]

    # bounds.  Decode: the capacity dispatch runs every expert (capacity
    # int(4·6·1.25/64) or 1 = 1), so a step reads every weight but the
    # embedding table (4 of its rows) and the kept K/V.  Prefill: the
    # products the code computes (every expert at its capacity, pad slots
    # included) at the bf16 tensor-core peak.
    m, dm, vp = cfg.moe, cfg.d_model, cfg.vocab_padded
    hd = cfg.n_heads * cfg.head_dim
    kv_bytes = (2 * cfg.n_layers * 2 * MOE_BATCH * cfg.n_kv_heads
                * (MOE_PROMPT[1] + 1) * cfg.head_dim)
    decode_bytes = 2 * (n_params - vp * dm + MOE_BATCH * dm) + kv_bytes
    plen = plens[0]
    tok = MOE_BATCH * plen
    cap = int(tok * m.top_k * m.capacity_factor / m.n_experts) or 1
    per_layer = (2 * tok * dm * (2 * hd + 2 * cfg.n_kv_heads
                                 * cfg.head_dim)
                 + 4 * MOE_BATCH * cfg.n_heads * cfg.head_dim
                 * kept_pairs(plen, plen, True, None, 0)
                 + 2 * tok * dm * m.n_experts
                 + 2 * 3 * m.n_experts * cap * dm * m.d_ff_expert)
    prefill_ops = cfg.n_layers * per_layer + 2 * MOE_BATCH * dm * vp
    out["bounds"] = {
        "decode_bytes": decode_bytes,
        "decode_ms": decode_bytes / HBM_BYTES_PER_S * 1e3,
        "prefill_ops": prefill_ops, "prefill_capacity": cap,
        "prefill_ms": prefill_ops / BF16_OPS_PER_S * 1e3,
        "prefill_tokens": tok}
    bd, pp, pd = out["bounds"], out["profile_prefill"], out["profile_decode"]
    tf = out["teacher_forced"]
    print(f"  init {out['init_s']:.2f} s; {MOE_REQUESTS} requests x {MOE_NEW}"
          f" tokens, prompts {out['prompt_lengths']}: {len(tokens)} tokens "
          f"in {wall:.3f} s ({out['tokens_per_s']:.2f} tokens/s); prefill "
          + ", ".join(f"{t:.1f}" for t in out["prefill_ms"])
          + f" ms a generation; decode median {out['decode_ms_median']:.2f}"
          f" ms a step (min {out['decode_ms_min']:.2f}, max "
          f"{out['decode_ms_max']:.2f}); peak memory "
          f"{out['peak_memory_bytes'] / 2**30:.2f} GiB")
    ck = out["attention_calls_checked"]
    print(f"  attention launches {launches} = planned {planned} over {calls}"
          f" calls; the {ck['calls']} attention calls of a kernel-path replay "
          f"of generation 1 against the plain version on their operands: "
          f"max |diff| {ck['max_abs_err']:.3g}, values that differ at most "
          f"{ck['max_mismatch_share']:.4f} (bf16 tolerance, all within)")
    print(f"  teacher-forced logits, kernel path vs plain path (bf16, the "
          f"serve's routing): max |diff| / max |logit| "
          f"{tf['max_rel_diff']:.3g}, {tf['calls_within_limit']} of "
          f"{len(tf['calls'])} calls within {MOE_TOL}; router picks another "
          f"expert set in {tf['calls_with_a_flip']} calls; per call rel diff"
          f" / flip share: "
          + ", ".join(f"{x['rel_diff']:.3g}/{x['router_flip_share']:.4f}"
                      for x in tf["calls"]))
    print(f"  profiled prefill ({card}): attention kernels "
          f"{pp['attention_kernel_ms']:.3f} ms of {pp['device_busy_ms']:.3f} "
          f"ms device time, wall {pp['traced_wall_ms']:.3f} ms, idle share "
          f"{pp['idle_share']:.4f}; decode step: attention "
          f"{pd['attention_kernel_ms']:.4f} ms of {pd['device_busy_ms']:.3f} "
          f"ms, wall {pd['traced_wall_ms']:.3f} ms, idle share "
          f"{pd['idle_share']:.4f}")
    for key, prof in (("prefill", pp), ("decode step", pd)):
        print(f"  top device ops, {key} ({prof['device_events']} events): "
              + "; ".join(f"{o['name'][:48]} {o['ms']:.3f} ms x{o['count']}"
                          for o in prof["top_device_ops"]))
    print(f"  bounds: decode reads {bd['decode_bytes'] / 1e9:.2f} GB >= "
          f"{bd['decode_ms']:.3f} ms at 3.35 TB/s; prefill of "
          f"{bd['prefill_tokens']} tokens (expert capacity {cap}) "
          f"{bd['prefill_ops'] / 1e12:.2f} TFLOP >= {bd['prefill_ms']:.2f} "
          f"ms at 989 TFLOP/s")
    for row in out["calls"]:
        print(f"  {row['case']} {tuple(row['shape_b_h_hkv_sq_skv_d'])} "
              f"q_offset {row['q_offset']} ({card}): {row['path']} blocks "
              f"{row['blocks']} splits {row['splits']} launches "
              f"{row['launches']}: kernel {row['kernel_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}, share "
              f"{row['share_of_bound']:.3f}), max |diff| "
              f"{row['max_abs_err']:.3g}")
    return out


def rwkv_phase(ops, card: str, dev) -> dict:
    """Phase 16: rwkv6-7b at full width in float32 (seeded weights, TF32
    off) served by the port's ``Server``: one generation of 4 prompts (the
    longest a multiple of the WKV chunk), 16 new tokens; every logit
    finite.  Then the recurrent state check: a ``RWKV_SPLIT[0]``-token
    prefill followed by ``RWKV_SPLIT[1]`` teacher-forced decode steps must
    leave every layer's ``wkv`` state and the last logits within
    ``RWKV_TOL`` × max |value| of one prefill of the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.device import strict_float32
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.params import init_params, param_count
    from repro_torch.models.transformer import model_defs
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import decode_step, prefill

    cfg = get_config(RWKV_ARCH)
    defs = model_defs(cfg)
    n_params = param_count(defs)
    print(f"RWKV-6 LM ({card}): {RWKV_ARCH} full width: {cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} WKV "
          f"heads of {cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}: {n_params / 1e9:.3f} B parameters, "
          f"{4 * n_params / 1e9:.2f} GB of float32 weights")
    rng = np.random.default_rng(16)
    lengths = [int(rng.integers(RWKV_PROMPT[0], RWKV_PROMPT[1] + 1))
               for _ in range(RWKV_BATCH)]
    top = int(np.argmax(lengths))
    lengths[top] = 64 * -(-lengths[top] // 64)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in lengths]
    out = {"arch": RWKV_ARCH, "card": card, "params": n_params,
           "weight_bytes": 4 * n_params, "dtype": "float32",
           "batch": RWKV_BATCH, "new_tokens": RWKV_NEW,
           "prompt_lengths": lengths}
    max_seq = max(lengths) + RWKV_NEW
    with strict_float32():
        t0 = time.perf_counter()
        params = init_params(defs, seed=0, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        server = Server(cfg, params, batch_size=RWKV_BATCH, max_seq=max_seq,
                        device=dev, record=True)
        for rid, p in enumerate(prompts):
            server.submit(Request(rid, p, RWKV_NEW))
        with torch.inference_mode():        # warm: a prefill and a step
            warm = init_cache(cfg, RWKV_BATCH, max_seq, torch.float32, dev)
            toks = torch.zeros((RWKV_BATCH, max(lengths)), dtype=torch.long,
                               device=dev)
            prefill(params, cfg, toks, warm)
            decode_step(params, cfg, warm, toks[:, 0], max(lengths))
            del warm, toks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        results = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        if ops.attention_launches or ops.launches:
            raise AssertionError("rwkv6 serve launched a kernel")
        tokens = [t for rid in sorted(results) for t in results[rid]]
        gen = server.generations[0]
        if (sorted(results) != list(range(RWKV_BATCH))
                or any(len(results[r]) != RWKV_NEW for r in results)
                or max(tokens) >= cfg.vocab or min(tokens) < 0
                or not all(torch.isfinite(l[:, :cfg.vocab]).all()
                           for l in gen.logits)):
            raise AssertionError(f"rwkv6 serve: results {results}")
        decode_s = sorted(gen.seconds[1:])
        out.update({
            "serve_s": wall, "tokens": len(tokens),
            "tokens_per_s": len(tokens) / wall,
            "prefill_ms": gen.seconds[0] * 1e3,
            "decode_ms_median": decode_s[len(decode_s) // 2] * 1e3,
            "decode_ms_min": decode_s[0] * 1e3,
            "decode_ms_max": decode_s[-1] * 1e3})
        del server, gen

        # the state check: prefill then teacher-forced steps = one prefill
        n0, steps = RWKV_SPLIT
        seq = torch.from_numpy(np.random.default_rng(161).integers(
            0, cfg.vocab, (RWKV_BATCH, n0 + steps))).to(dev)
        with torch.inference_mode():
            whole = init_cache(cfg, RWKV_BATCH, n0 + steps, torch.float32,
                               dev)
            want, whole = prefill(params, cfg, seq, whole)
            part = init_cache(cfg, RWKV_BATCH, n0 + steps, torch.float32,
                              dev)
            got, part = prefill(params, cfg, seq[:, :n0], part)
            for t in range(steps):
                got, part = decode_step(params, cfg, part, seq[:, n0 + t],
                                        n0 + t)
        layers = [(a["wkv"][r], b["wkv"][r])       # stacked repeats
                  for a, b in zip(part.blocks, whole.blocks)
                  for r in range(a["wkv"].shape[0])]
        layers += [(a["wkv"], b["wkv"]) for a, b in zip(part.tail,
                                                        whole.tail)]
        rows = []
        for name, a, b in [("logits", got[:, :cfg.vocab],
                            want[:, :cfg.vocab])] + [
                (f"wkv layer {i}", a, b) for i, (a, b) in enumerate(layers)]:
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            rows.append({"leaf": name, "max_abs_diff": err,
                         "max_abs_value": scale, "rel_diff": err / scale})
            if not (torch.isfinite(a).all() and err <= RWKV_TOL * scale):
                raise AssertionError(f"rwkv6 state check, {name}: max |diff|"
                                     f" {err:.3g} > {RWKV_TOL} × {scale:.3g}")
        out["state_check"] = {
            "split": list(RWKV_SPLIT), "tolerance": f"{RWKV_TOL} x max "
            f"|value|", "max_rel_diff": max(r["rel_diff"] for r in rows),
            "logits_rel_diff": rows[0]["rel_diff"],
            "wkv_max_rel_diff": max(r["rel_diff"] for r in rows[1:]),
            "leaves": rows}
        del params, whole, part, layers
    torch.cuda.empty_cache()
    sc = out["state_check"]
    print(f"  init {out['init_s']:.2f} s; 4 prompts {lengths} x {RWKV_NEW} "
          f"tokens: {len(tokens)} tokens in {wall:.3f} s "
          f"({out['tokens_per_s']:.2f} tokens/s); prefill "
          f"{out['prefill_ms']:.1f} ms; decode median "
          f"{out['decode_ms_median']:.2f} ms a step (min "
          f"{out['decode_ms_min']:.2f}, max {out['decode_ms_max']:.2f}); "
          f"peak memory {out['peak_memory_bytes'] / 2**30:.2f} GiB")
    print(f"  state check, prefill {RWKV_SPLIT[0]} + {RWKV_SPLIT[1]} "
          f"teacher-forced steps vs one prefill of {sum(RWKV_SPLIT)}: wkv "
          f"max rel diff {sc['wkv_max_rel_diff']:.3g}, logits "
          f"{sc['logits_rel_diff']:.3g} (limit {RWKV_TOL})")
    return out


# -- phase 17: training at full width -----------------------------------------

TRAIN_ARCH = "lm100m"              # src/repro_torch/configs/lm100m.py
# the reference driver's usage line (global batch 32, seq 256) and the
# example's microbatches and lr (examples/train_lm.py)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_LR = 32, 256, 2, 1e-3
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 100, 25, 60
TRAIN_REPLAY_RTOL = 1e-5           # tests/test_fault_tolerance.py
TRAIN_PLAIN_STEPS = 5              # kernel path against plain path, gated
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-4, 1e-3
# from step 2 on a step may also lie this many times the emulated
# control's distance from the plain path (float32 noise of the kernel's
# size, spread by the steps before)
TRAIN_CONTROL_FACTOR = 10
QWEN_TRAIN_BATCH, QWEN_TRAIN_SEQ, QWEN_TRAIN_STEPS = 4, 1024, 3
QWEN_TRAIN_RTOL = 1e-3             # step 1 against the plain path
TRAIN_CARD_CASES = 21              # 13 train steps, 8 attention grads
TRAIN_ATTN_ITERS = 20              # op-level backward timing, calls


def train_bound(cfg, tokens: int, batch: int, seq: int) -> dict:
    """Least time of a train step at 67 TFLOP/s float32: 6 operations a
    token for each parameter a product reads (forward 2, backward 4; an
    untied embedding table is gathered, not multiplied), 2 more for each
    block parameter where remat ``full`` recomputes the blocks' products
    (``dots`` keeps them and recomputes only attention and elementwise
    work), and attention's 4·D operations a kept pair three times over
    (forward, a backward of twice it), four where a remat recomputes it."""
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import model_defs
    defs = model_defs(cfg)
    gathered = (0 if cfg.tie_embeddings
                else param_count({"embed": defs["embed"]}))
    blocks = param_count([defs["blocks"], defs["tail"],
                          defs.get("encoder", {}).get("blocks", [])])
    linear = 6 * (param_count(defs) - gathered) * tokens
    recompute = 2 * blocks * tokens if cfg.remat == "full" else 0
    attn = ((3 if cfg.remat == "none" else 4) * 4 * cfg.head_dim
            * kept_pairs(seq, seq, True, None, 0) * batch * cfg.n_heads
            * cfg.n_layers)
    total = linear + recompute + attn
    return {"operations": total, "linear_operations": linear,
            "recompute_operations": recompute,
            "attention_operations": attn,
            "ms": total / F32_OPS_PER_S * 1e3}


def train_card_phase() -> dict:
    """The card tests of training (``tests/test_torch_card.py``: one
    float32 train step of each LM smoke config and two with remat, kernel
    path against plain path, launches against the plans; the attention op
    under grad in float32 and bf16) in a pytest process of its own."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", "tests/test_torch_card.py", "-k",
         "lm_train_step or attention_grad"], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    seconds = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    if proc.returncode != 0 or f"{TRAIN_CARD_CASES} passed" not in tail:
        raise AssertionError(f"training card tests: rc {proc.returncode}\n"
                             f"{proc.stdout[-6000:]}\n{proc.stderr[-3000:]}")
    print(f"training card tests (11 smoke configs + 2 with remat, float32 "
          f"kernel vs plain; the op's gradients f32/bf16): {tail} in "
          f"{seconds:.1f} s")
    return {"result": tail, "seconds": seconds}


def train_lm_phase(ops, ref, fa, card: str, dev) -> dict:
    """Phase 17 (a): lm100m at its published width (14 layers, d 640, 10
    heads over 2, head dim 64, d_ff 2560, vocab 4096, remat ``dots``;
    seeded float32 weights) trained by the port's ``launch.train.train``:
    global batch 32 of 256 tokens in 2 microbatches, lr 1e-3, float32
    AdamW, 100 steps, a checkpoint every 25 and one injected failure
    before step 60 (restored from step 50, steps 50-59 replayed).
    Gates: every loss finite, the last below the first, one restart, each
    replayed step's loss its first pass's within ``TRAIN_REPLAY_RTOL``,
    attention launches = (forward + remat recompute) × layers ×
    microbatches × steps run × the plan's launches; the first
    ``TRAIN_PLAIN_STEPS`` steps rerun from the same draw inside
    ``layers.plain_attention``: step 1 (the same parameters on both
    paths) within ``TRAIN_LOSS_RTOL`` (loss) and ``TRAIN_GNORM_RTOL``
    (grad norm); steps 2-5 within those limits or within
    ``TRAIN_CONTROL_FACTOR`` times a control's distance at that step: the
    kernel path from the same draw with the kernel's split-TF32
    arithmetic emulated in its place (``ref.attention_tf32_ref``,
    terms=3), a run that parts from the plain one by float32 noise of the
    kernel's size.  The plain run goes on to step 100 and its distance is
    reported."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.device import strict_float32
    from repro_torch.launch.train import build_trainer, train
    from repro_torch.models import layers
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import model_defs
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig

    cfg = get_config(TRAIN_ARCH)
    n_params = param_count(model_defs(cfg))
    tc = TrainConfig(microbatches=TRAIN_MICRO, opt=adamw.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=max(1, TRAIN_STEPS // 10),
        total_steps=TRAIN_STEPS))
    sms = fa.device_sm_count(dev)
    call = (TRAIN_BATCH // TRAIN_MICRO, cfg.n_heads, cfg.n_kv_heads,
            TRAIN_SEQ, TRAIN_SEQ, cfg.head_dim)
    per_call = fa.plan(*call, torch.float32, sm_count=sms).launches
    forwards = 1 if cfg.remat == "none" else 2      # + the remat recompute
    restored = (TRAIN_FAIL_AT // TRAIN_CKPT_EVERY) * TRAIN_CKPT_EVERY
    steps_run = TRAIN_STEPS + TRAIN_FAIL_AT - restored
    per_step = forwards * cfg.n_layers * TRAIN_MICRO * per_call
    planned = per_step * steps_run
    formula = (f"{forwards} (forward + remat recompute) x {cfg.n_layers} "
               f"layers x {TRAIN_MICRO} microbatches x {steps_run} steps "
               f"run ({TRAIN_STEPS} + {TRAIN_FAIL_AT - restored} replayed) "
               f"x {per_call} launch a call = {planned}")
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        report = train(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                       seq_len=TRAIN_SEQ, ckpt_dir=str(ckpt),
                       ckpt_every=TRAIN_CKPT_EVERY, train_cfg=tc,
                       fail_at=[TRAIN_FAIL_AT], log_every=0, device=dev,
                       step_hook=lambda state, step: stamps.append(
                           (step, time.perf_counter())))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, gemm = ops.attention_launches, ops.launches
    peak = torch.cuda.max_memory_allocated(dev)
    hist = report.metrics_history
    if launches != planned or gemm:
        raise AssertionError(f"lm100m training: {launches} attention "
                             f"launches, planned {formula} (vta_gemm {gemm})")
    losses = [m["loss"] for m in hist]
    if not all(np.isfinite(losses)) or not all(
            np.isfinite(m["grad_norm"]) for m in hist):
        raise AssertionError("lm100m training: a loss or grad norm is not "
                             "finite")
    first_pass = hist[:TRAIN_FAIL_AT]
    replay = hist[TRAIN_FAIL_AT:TRAIN_FAIL_AT + TRAIN_FAIL_AT - restored]
    if (report.restarts != 1 or report.final_step != TRAIN_STEPS
            or [m["step"] for m in first_pass]
            != list(range(1, TRAIN_FAIL_AT + 1))
            or [m["step"] for m in replay]
            != list(range(restored + 1, TRAIN_FAIL_AT + 1))):
        raise AssertionError(f"lm100m training: restarts "
                             f"{report.restarts}, steps "
                             f"{[m['step'] for m in hist]}")
    replay_rel = max(abs(r["loss"] - first_pass[r["step"] - 1]["loss"])
                     / abs(first_pass[r["step"] - 1]["loss"])
                     for r in replay)
    if replay_rel > TRAIN_REPLAY_RTOL:
        raise AssertionError(f"lm100m training: a replayed loss is "
                             f"{replay_rel:.3g} from its first pass")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"lm100m training: loss {losses[0]} -> "
                             f"{losses[-1]}")
    durations = sorted(t1 - t0 for (s0, t0), (s1, t1)
                       in zip(stamps, stamps[1:]) if s1 == s0 + 1)
    step_s = durations[len(durations) // 2]
    trajectory = first_pass[:restored] + hist[TRAIN_FAIL_AT:]

    # the kernel path against the plain path from the same draw
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=0)
    init_state, run_step, _ = build_trainer(cfg, tc, data_cfg, 0, dev)
    state = init_state()
    plain, plain_times = [], []
    before = ops.attention_launches
    with strict_float32(), layers.plain_attention():
        for step in range(TRAIN_STEPS):
            t1 = time.perf_counter()
            state = run_step(state, step)
            plain_times.append(time.perf_counter() - t1)
            plain.append(state.metrics)
    if ops.attention_launches != before:
        raise AssertionError("the plain run launched the kernel")
    # the control: the kernel path from the same draw with the kernel's
    # split-TF32 arithmetic emulated in its place (attention_tf32_ref,
    # terms=3, within 2e-5 of attention_ref as the kernel is), so the run
    # parts from the plain one by a forward error of the kernel's size
    def emulated(q, k, v, *, backend, **kw):
        return ref.attention_tf32_ref(q, k, v, terms=3, **kw)

    state = init_state()
    control, real = [], ops.attention
    before = ops.attention_launches
    ops.attention = emulated
    try:
        with strict_float32():
            for step in range(TRAIN_PLAIN_STEPS):
                state = run_step(state, step)
                control.append(state.metrics)
    finally:
        ops.attention = real
    if ops.attention_launches != before:
        raise AssertionError("the emulated control launched the kernel")
    rel = lambda a, b, key: abs(a[key] - b[key]) / abs(b[key])
    gated, failed = [], []
    for i in range(TRAIN_PLAIN_STEPS):
        k, p, c = trajectory[i], plain[i], control[i]
        row = {"step": i + 1, "loss_rel": rel(k, p, "loss"),
               "grad_norm_rel": rel(k, p, "grad_norm"),
               "control_loss_rel": rel(c, p, "loss"),
               "control_grad_norm_rel": rel(c, p, "grad_norm")}
        gated.append(row)
        # step 1 (the same parameters on both paths) within the limits;
        # later steps within them or within TRAIN_CONTROL_FACTOR times
        # the control's distance at that step
        for key, limit in (("loss", TRAIN_LOSS_RTOL),
                           ("grad_norm", TRAIN_GNORM_RTOL)):
            allowed = limit if i == 0 else max(
                limit, TRAIN_CONTROL_FACTOR * row[f"control_{key}_rel"])
            if row[f"{key}_rel"] > allowed:
                failed.append((i + 1, key, row[f"{key}_rel"], allowed))
    if failed:
        raise AssertionError(f"lm100m: kernel path vs plain path beyond "
                             f"(step, metric, distance, allowed) {failed}; "
                             f"{gated}")
    end = {"loss_kernel": trajectory[-1]["loss"],
           "loss_plain": plain[-1]["loss"],
           "loss_rel": abs(trajectory[-1]["loss"] - plain[-1]["loss"])
           / abs(plain[-1]["loss"])}

    # one profiled step on the kernel path, after a warm one
    with strict_float32():
        state = run_step(state, TRAIN_STEPS)
        prof = lm_profile(lambda: run_step(state, TRAIN_STEPS + 1),
                          ops.PLAIN_BACKWARD_RANGE)
    del state
    if prof["attention_kernels"] not in (0, per_step):
        raise AssertionError(f"profiled step: {prof['attention_kernels']} "
                             f"attention kernels traced, planned {per_step}")
    torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound = train_bound(cfg, tokens, TRAIN_BATCH, TRAIN_SEQ)
    out = {"arch": TRAIN_ARCH, "card": card, "params": n_params,
           "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "microbatches": TRAIN_MICRO, "lr": TRAIN_LR,
           "steps": TRAIN_STEPS, "ckpt_every": TRAIN_CKPT_EVERY,
           "fail_at": TRAIN_FAIL_AT, "restarts": report.restarts,
           "launches": launches, "planned_launches": planned,
           "launch_formula": formula, "train_s": wall,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses_every_10": [m["loss"] for m in trajectory[9::10]],
           "first_losses": [m["loss"] for m in first_pass[:MESH_STEPS]],
           "replay_max_rel": replay_rel,
           "step_ms_median": step_s * 1e3,
           "step_ms_min": durations[0] * 1e3,
           "step_ms_max": durations[-1] * 1e3,
           "tokens_per_s": tokens / step_s,
           "peak_memory_bytes": peak,
           "plain_step_ms_median": sorted(plain_times)[
               len(plain_times) // 2] * 1e3,
           "kernel_vs_plain": gated, "end_of_run": end,
           "profile_step": prof, "bound": bound,
           "share_of_bound": bound["ms"] / (step_s * 1e3)}
    print(f"lm100m training ({card}): full width, {n_params / 1e6:.2f} M "
          f"float32 parameters, {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens ({TRAIN_MICRO} microbatches, remat "
          f"{cfg.remat}) in {wall:.1f} s: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; restarts {report.restarts}, replayed steps "
          f"{restored + 1}-{TRAIN_FAIL_AT} within {replay_rel:.3g} of their "
          f"first pass; step median {step_s * 1e3:.1f} ms (min "
          f"{durations[0] * 1e3:.1f}, max {durations[-1] * 1e3:.1f}), "
          f"{tokens / step_s:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"  attention launches {launches} = {formula}")
    print(f"  kernel vs plain, step 1: loss {gated[0]['loss_rel']:.3g} "
          f"(limit {TRAIN_LOSS_RTOL}), grad norm "
          f"{gated[0]['grad_norm_rel']:.3g} (limit {TRAIN_GNORM_RTOL}); "
          f"steps 1-{TRAIN_PLAIN_STEPS} loss "
          + ", ".join(f"{r['loss_rel']:.3g}" for r in gated)
          + ", grad norm "
          + ", ".join(f"{r['grad_norm_rel']:.3g}" for r in gated)
          + "; the emulated control's loss "
          + ", ".join(f"{r['control_loss_rel']:.3g}" for r in gated)
          + ", grad norm "
          + ", ".join(f"{r['control_grad_norm_rel']:.3g}" for r in gated)
          + f"; after {TRAIN_STEPS} steps loss {end['loss_kernel']:.5f} vs "
          f"plain {end['loss_plain']:.5f} ({end['loss_rel']:.3g}); plain "
          f"step median {out['plain_step_ms_median']:.1f} ms")
    print(f"  profiled step ({card}): device {prof['device_busy_ms']:.1f} "
          f"ms of {prof['traced_wall_ms']:.1f} ms (idle share "
          f"{prof['idle_share']:.4f}); attention kernels "
          f"{prof['attention_kernel_ms']:.2f} ms ({prof['attention_kernels']}"
          f" launches), plain backward "
          + (f"{prof['range_ms']:.2f} ms"
             if prof["range_ms"] is not None
             else "not measured (no device-side range)")
          + f"; bound {bound['ms']:.1f} ms (share {out['share_of_bound']:.3f}"
          f" of the median step)")
    for op in prof["top_device_ops"]:
        print(f"    {op['ms']:9.3f} ms {op['count']:5d}x {op['name']}")
    return out


def train_qwen_phase(ops, fa, card: str, dev) -> dict:
    """Phase 17 (b): qwen2.5-3b at its published width (36 layers, d 2048,
    16 heads over 2, head dim 128, d_ff 11008, vocab 151936, remat
    ``full``; seeded float32 weights, 3.398 B parameters) takes 3 steps of
    the port's train step on one seeded batch of 4 × 1024 from
    ``make_batch``, with the reference's default train config for the
    arch (float32 moments, one microbatch, warmup 1 of 3).  Gates: losses
    and grad norms finite, step 3's loss below step 1's, attention
    launches = 2 × layers × 3 × the plan's, and step 1's loss and grad
    norm within ``QWEN_TRAIN_RTOL`` of the same step inside
    ``layers.plain_attention`` (taken first: the step updates in place)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import strict_float32
    from repro_torch.launch.train import default_train_config
    from repro_torch.models import layers
    from repro_torch.models.params import init_params, param_count, tree_items
    from repro_torch.models.transformer import model_defs
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_grad_fn, make_train_step

    cfg = get_config(LM_ARCH)
    defs = model_defs(cfg)
    n_params = param_count(defs)
    tc = default_train_config(LM_ARCH, QWEN_TRAIN_BATCH, QWEN_TRAIN_STEPS)
    if (tc.microbatches, tc.opt.eightbit, tc.opt.warmup_steps) != (1, False, 1):
        raise AssertionError(f"qwen2.5-3b train config {tc}")
    sms = fa.device_sm_count(dev)
    call = (QWEN_TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, QWEN_TRAIN_SEQ,
            QWEN_TRAIN_SEQ, cfg.head_dim)
    per_call = fa.plan(*call, torch.float32, sm_count=sms).launches
    forwards = 1 if cfg.remat == "none" else 2
    per_step = forwards * cfg.n_layers * per_call
    planned = per_step * QWEN_TRAIN_STEPS
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=QWEN_TRAIN_SEQ,
                          global_batch=QWEN_TRAIN_BATCH, seed=0)
    with strict_float32():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_params(defs, seed=0, dtype=torch.float32, device=dev)
        for _, p in tree_items(params, lambda x: isinstance(x, torch.Tensor)):
            p.requires_grad_(True)
        opt = adamw.init(tc.opt, params)
        batch = make_batch(data_cfg, 0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        before = ops.attention_launches
        t0 = time.perf_counter()
        with layers.plain_attention():
            loss, _, grads = make_grad_fn(cfg, tc)(params, batch)
            plain = {"loss": float(loss),
                     "grad_norm": float(adamw.global_norm(grads))}
        del grads, loss
        plain_s = time.perf_counter() - t0
        if ops.attention_launches != before:
            raise AssertionError("the plain step launched the kernel")
        step = make_train_step(cfg, tc)
        ops.reset_launches()
        hist, times = [], []
        for _ in range(QWEN_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            names = sorted(met)
            values = torch.stack([met[k].float() for k in names]).tolist()
            times.append(time.perf_counter() - t0)
            hist.append(dict(zip(names, values)))
        launches, gemm = ops.attention_launches, ops.launches
        peak = torch.cuda.max_memory_allocated(dev)
        prof = lm_profile(lambda: step(params, opt, batch),
                          ops.PLAIN_BACKWARD_RANGE)
    del params, opt, batch, step
    torch.cuda.empty_cache()
    if launches != planned or gemm:
        raise AssertionError(f"qwen2.5-3b training: {launches} attention "
                             f"launches, planned {planned} (vta_gemm {gemm})")
    if not (np.isfinite([m["loss"] for m in hist]).all()
            and np.isfinite([m["grad_norm"] for m in hist]).all()):
        raise AssertionError(f"qwen2.5-3b training: {hist}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"qwen2.5-3b training: loss {hist[0]['loss']} "
                             f"-> {hist[-1]['loss']}")
    rel = {k: abs(hist[0][k] - plain[k]) / abs(plain[k])
           for k in ("loss", "grad_norm")}
    if max(rel.values()) > QWEN_TRAIN_RTOL:
        raise AssertionError(f"qwen2.5-3b step 1: kernel path vs plain "
                             f"path {rel}")
    if prof["attention_kernels"] not in (0, per_step):
        raise AssertionError(f"profiled step: {prof['attention_kernels']} "
                             f"attention kernels traced, planned {per_step}")
    tokens = QWEN_TRAIN_BATCH * QWEN_TRAIN_SEQ
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    bound = train_bound(cfg, tokens, QWEN_TRAIN_BATCH, QWEN_TRAIN_SEQ)
    out = {"arch": LM_ARCH, "card": card, "params": n_params,
           "batch": QWEN_TRAIN_BATCH, "seq_len": QWEN_TRAIN_SEQ,
           "steps": QWEN_TRAIN_STEPS, "remat": cfg.remat,
           "init_s": init_s, "losses": [m["loss"] for m in hist],
           "grad_norms": [m["grad_norm"] for m in hist],
           "step_ms": [t * 1e3 for t in times],
           "step_ms_median_after_first": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "peak_memory_bytes": peak,
           "launches": launches, "planned_launches": planned,
           "plain_step1": plain, "plain_grad_step_s": plain_s,
           "kernel_vs_plain_step1": rel, "profile_step": prof,
           "bound": bound, "share_of_bound": bound["ms"] / (step_s * 1e3)}
    print(f"qwen2.5-3b training ({card}): full width, {n_params / 1e9:.3f} B "
          f"float32 parameters, remat {cfg.remat}, {QWEN_TRAIN_STEPS} AdamW "
          f"steps on {QWEN_TRAIN_BATCH} x {QWEN_TRAIN_SEQ} tokens: losses "
          + ", ".join(f"{m['loss']:.4f}" for m in hist)
          + "; grad norms " + ", ".join(f"{m['grad_norm']:.4g}" for m in hist)
          + "; steps " + ", ".join(f"{t * 1e3:.0f}" for t in times)
          + f" ms ({tokens / step_s:.0f} tokens/s after the first); peak "
          f"memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)")
    print(f"  attention launches {launches} = {forwards} x {cfg.n_layers} "
          f"layers x {QWEN_TRAIN_STEPS} steps x {per_call}; step 1 vs plain "
          f"path: loss {rel['loss']:.3g}, grad norm {rel['grad_norm']:.3g} "
          f"(limit {QWEN_TRAIN_RTOL}; plain grads {plain_s:.1f} s)")
    print(f"  profiled step ({card}): device {prof['device_busy_ms']:.1f} "
          f"ms of {prof['traced_wall_ms']:.1f} ms (idle share "
          f"{prof['idle_share']:.4f}); attention kernels "
          f"{prof['attention_kernel_ms']:.2f} ms ({prof['attention_kernels']}"
          f" launches), plain backward "
          + (f"{prof['range_ms']:.2f} ms"
             if prof["range_ms"] is not None
             else "not measured (no device-side range)")
          + f"; bound {bound['ms']:.0f} ms (share {out['share_of_bound']:.3f}"
          f" of the median step)")
    for op in prof["top_device_ops"]:
        print(f"    {op['ms']:9.3f} ms {op['count']:5d}x {op['name']}")
    return out


def backward_bound(case) -> float:
    """Least time (ms) of the attention backward with its recompute:
    q, k, v, o and dO read, dQ, dK, dV written at the memory rate, or
    10·D operations a kept pair (Q Kᵀ again, dV, dP, dQ, dK) at the
    float32 rate of ``attention_bound``, the larger."""
    b, h, hkv, sq, skv, d = case["shape"]
    nbytes = 4 * d * (4 * b * h * sq + 4 * b * hkv * skv)
    ops = 10 * b * h * d * kept_pairs(sq, skv, True, None, 0)
    t_ops = min(ops / F32_OPS_PER_S, 3 * ops / TF32_OPS_PER_S)
    return max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3


def train_attention_case(ops, ref, name, shape, chunk, dev) -> dict:
    """One attention call of a train step alone, float32 causal.  Gates:
    the op under grad (``ops.with_plain_backward``) carries a ``grad_fn``,
    its output lies within ``attention_err``'s float32 tolerance of
    ``attention_ref`` and its q/k/v gradients equal the plain
    ``chunked_attention``'s.  Times: the kernel's forward, SDPA's (every
    backend, the fastest within 2e-5) and the bound; the op's backward as training runs it (the plain
    ``chunked_attention`` recomputed and differentiated, ``chunk`` its q
    and kv chunk) beside SDPA's backward on that backend (its forward and
    backward less its forward), each between CUDA events over
    ``TRAIN_ATTN_ITERS`` calls."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.models import layers
    b, h, hkv, sq, skv, d = shape
    x = attention_inputs(np.random.default_rng(170), shape, torch.float32,
                         dev)
    kw = dict(causal=True, window=None, q_offset=0)
    case = {"shape": shape, "dtype": torch.float32, "causal": True,
            "window": None, "q_offset": 0, "sdpa_causal": True}
    sd = sdpa_backends(ref, x, kw, case)
    fwd_bound, fwd_by = attention_bound(case)
    plain = functools.partial(layers.chunked_attention, q_chunk=chunk,
                              kv_chunk=chunk, **kw)
    leaves = [t.detach().requires_grad_(True) for t in x]
    ct = torch.from_numpy(np.random.default_rng(171).standard_normal(
        (b, h, sq, d)).astype(np.float32)).to(dev)

    launch = functools.partial(ops.attention, **kw)

    def plain_backward():
        return torch.autograd.grad(plain(*leaves), leaves, ct)

    def kernel_train_call():
        out = ops.with_plain_backward(launch, plain, *leaves)
        return torch.autograd.grad(out, leaves, ct)

    # the op as training calls it, held to its plain versions at this
    # shape: the output against attention_ref at the float32 tolerance,
    # the gradients equal to chunked_attention's own
    out = ops.with_plain_backward(launch, plain, *leaves)
    if out.grad_fn is None:
        raise AssertionError(f"{name}: the op's output has no grad_fn")
    fwd_err = attention_err(out.detach(), ref.attention_ref(*x, **kw))
    got = torch.autograd.grad(out, leaves, ct)
    want = plain_backward()
    grad_diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: the op's q/k/v gradients differ "
                             f"from chunked_attention's by {grad_diff:.3g}")
    del out, got, want
    row = {"case": name, "shape_b_h_hkv_sq_skv_d": list(shape),
           "forward_max_abs_err": fwd_err["max_abs_err"],
           "grads_equal_plain": True,
           "kernel_ms": graph_ms(lambda: ops.attention(*x, **kw),
                                 *ATTN_WINDOW),
           "sdpa": sd, "bound_ms": fwd_bound, "bound_by": fwd_by,
           "bound_cuda_cores_ms": attention_bound(case, True)[0],
           "plain_backward_ms": cuda_ms(plain_backward, TRAIN_ATTN_ITERS, 3),
           "train_call_ms": cuda_ms(kernel_train_call, TRAIN_ATTN_ITERS, 3),
           "backward_bound_ms": backward_bound(case)}
    backend = sd["fastest_within_2e-5"]
    if backend is not None:
        gqa = sd["backends"][backend]["enable_gqa"]
        group = h // hkv
        kk, vv = ((leaves[1], leaves[2]) if gqa else
                  (leaves[1].detach().repeat_interleave(group, 1)
                   .requires_grad_(True),
                   leaves[2].detach().repeat_interleave(group, 1)
                   .requires_grad_(True)))
        args = (leaves[0], kk, vv)

        def sdpa_fwd():
            with sdpa_kernel(getattr(SDPBackend, backend)):
                return F.scaled_dot_product_attention(
                    *args, is_causal=True, scale=d ** -0.5, enable_gqa=gqa)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa_fwd(), args, ct)

        fwd_ms = cuda_ms(sdpa_fwd, TRAIN_ATTN_ITERS, 3)
        both_ms = cuda_ms(sdpa_fwd_bwd, TRAIN_ATTN_ITERS, 3)
        row.update({"sdpa_backend": backend, "sdpa_forward_call_ms": fwd_ms,
                    "sdpa_forward_backward_ms": both_ms,
                    "sdpa_backward_ms": both_ms - fwd_ms})
    print(f"  {name} {tuple(shape)} float32 causal: under grad the "
          f"output within {fwd_err['max_abs_err']:.3g} of attention_ref "
          f"(2e-5), q/k/v gradients equal to chunked_attention's; kernel "
          f"forward {row['kernel_ms']:.4f} ms, SDPA {sd['fastest_ms']} "
          f"({backend}), bound {fwd_bound:.4f} ({fwd_by}; CUDA cores "
          f"{row['bound_cuda_cores_ms']:.4f}); backward: plain recompute + "
          f"backward {row['plain_backward_ms']:.3f} ms, SDPA backward "
          + (f"{row['sdpa_backward_ms']:.3f}" if backend else "n/a")
          + f" ms, bound {row['backward_bound_ms']:.4f}; the op in training "
          f"(kernel forward + plain backward) {row['train_call_ms']:.3f} ms")
    return row


def train_phase(ops, ref, fa, card: str, dev) -> dict:
    """Phase 17: the training card tests, lm100m and qwen2.5-3b trained at
    full width, and the attention op at their training shapes."""
    from repro_torch.configs import get_config
    out = {"card_tests": train_card_phase(),
           "lm100m": train_lm_phase(ops, ref, fa, card, dev),
           "qwen": train_qwen_phase(ops, fa, card, dev)}
    lm, qwen = get_config(TRAIN_ARCH), get_config(LM_ARCH)
    out["calls"] = [
        train_attention_case(
            ops, ref, "lm100m training microbatch",
            (TRAIN_BATCH // TRAIN_MICRO, lm.n_heads, lm.n_kv_heads,
             TRAIN_SEQ, TRAIN_SEQ, lm.head_dim), lm.q_chunk, dev),
        train_attention_case(
            ops, ref, "qwen2.5-3b training",
            (QWEN_TRAIN_BATCH, qwen.n_heads, qwen.n_kv_heads,
             QWEN_TRAIN_SEQ, QWEN_TRAIN_SEQ, qwen.head_dim), qwen.q_chunk,
            dev)]
    out["launches"] = out["lm100m"]["launches"] + out["qwen"]["launches"]
    return out


# ---------------------------------------------------------------------------
# Phase 18: the mesh layer — sharded training and decode over NCCL
# ---------------------------------------------------------------------------

MESH_MAX_RANKS = 4
MESH_STEPS, MESH_CKPT_EVERY, MESH_FAIL_AT = 20, 10, 15
MESH_W1_RTOL = 1e-6        # one rank against phase 17's unsharded losses
MESH_RTOL = 2e-4           # several ranks: tests/test_multidevice.py's
MESH_POD_STEPS = 5
# int8_pod at one pod against the uncompressed run, steps 2-5: a gradient
# element under half a quantum (its leaf's absmax / 254) is sent as 0, so
# AdamW's first, sign-like steps skip it.  Measured on the H100 at most
# 8.48e-5; lm100m's loss itself moves only ~1e-3 over these steps, so this
# gate alone cannot tell a step that drops the compressed gradients: the
# parameters after step 1 are held to an AdamW step on them, bit for bit
MESH_POD_RTOL = 1e-3
MESH_DECODE_BATCH, MESH_DECODE_PROMPT = 4, 128
MESH_DECODE_NEW, MESH_DECODE_MAX_SEQ = 8, 256
MESH_TIMEOUT_S = 600


def compress_replica(partials: np.ndarray) -> np.ndarray:
    """The reference's ``_compress_body`` (``src/repro/train/
    distributed.py:30-37``) in numpy float32 over the pods' partials
    stacked on axis 0, as XLA compiles it (its divisions by the constants
    ``limit`` and ``n_pods`` as multiplications by their float32
    reciprocals)."""
    n = partials.shape[0]
    limit = max(1, 127 // n)
    scale = np.float32(np.max(np.abs(partials.astype(np.float32))))
    scale = np.float32(np.maximum(scale, np.float32(1e-12))
                       * np.float32(1.0 / limit))
    q = np.clip(np.round(partials.astype(np.float32) / scale), -limit,
                limit).astype(np.int8)
    s = q.sum(axis=0, dtype=np.int8)
    return ((s.astype(np.float32) * scale) * np.float32(1.0 / n)).astype(
        partials.dtype)


def _mesh_heads(h: int, hkv: int, tp: int):
    """(query heads, KV heads) of one rank's attention call at model =
    ``tp`` (``layers.mesh_attention``'s rule)."""
    if h % tp:
        return h, hkv
    return h // tp, (hkv // tp if hkv % tp == 0 else h // tp)


def _mesh_train_cfg():
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig
    return TrainConfig(microbatches=TRAIN_MICRO, opt=adamw.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=max(1, TRAIN_STEPS // 10),
        total_steps=TRAIN_STEPS))


def _median_step(stamps) -> float:
    durations = sorted(t1 - t0 for (s0, t0), (s1, t1)
                       in zip(stamps, stamps[1:]) if s1 == s0 + 1)
    return durations[len(durations) // 2]


def mesh_train_lm(ops, fa, dev, world: int, baseline) -> dict:
    """lm100m at full width through ``launch.train.train`` on mesh
    (1, W): ``MESH_STEPS`` steps of phase 17's configuration, a
    checkpoint every ``MESH_CKPT_EVERY`` written under the mesh, a failure
    before step ``MESH_FAIL_AT`` and one restart onto the mesh."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    cfg = get_config(TRAIN_ARCH)
    mesh = make_mesh((1, world), ("data", "model"))
    h_l, kv_l = _mesh_heads(cfg.n_heads, cfg.n_kv_heads, world)
    call = (TRAIN_BATCH // TRAIN_MICRO, h_l, kv_l, TRAIN_SEQ, TRAIN_SEQ,
            cfg.head_dim)
    per_call = fa.plan(*call, torch.float32,
                       sm_count=fa.device_sm_count(dev)).launches
    forwards = 1 if cfg.remat == "none" else 2
    restored = (MESH_FAIL_AT // MESH_CKPT_EVERY) * MESH_CKPT_EVERY
    steps_run = MESH_STEPS + MESH_FAIL_AT - restored
    planned = forwards * cfg.n_layers * TRAIN_MICRO * steps_run * per_call
    ckpt = ROOT / "build" / "chip_smoke_mesh_ckpt"
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    dist.barrier()
    stamps = []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    report = train(cfg, steps=MESH_STEPS, global_batch=TRAIN_BATCH,
                   seq_len=TRAIN_SEQ, ckpt_dir=str(ckpt),
                   ckpt_every=MESH_CKPT_EVERY, train_cfg=_mesh_train_cfg(),
                   fail_at=[MESH_FAIL_AT], log_every=0, device=dev,
                   mesh=mesh, step_hook=lambda state, step: stamps.append(
                       (step, time.perf_counter())))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, gemm = ops.attention_launches, ops.launches
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    if launches != planned or gemm:
        raise AssertionError(f"mesh lm100m: {launches} attention launches "
                             f"on a rank, planned {planned} (vta_gemm "
                             f"{gemm})")
    hist = report.metrics_history
    first = hist[:MESH_FAIL_AT]
    replay = hist[MESH_FAIL_AT:MESH_FAIL_AT + MESH_FAIL_AT - restored]
    if (report.restarts != 1 or report.final_step != MESH_STEPS
            or [m["step"] for m in replay]
            != list(range(restored + 1, MESH_FAIL_AT + 1))):
        raise AssertionError(f"mesh lm100m: restarts {report.restarts}, "
                             f"steps {[m['step'] for m in hist]}")
    replay_rel = max(abs(r["loss"] - first[r["step"] - 1]["loss"])
                     / abs(first[r["step"] - 1]["loss"]) for r in replay)
    if replay_rel > TRAIN_REPLAY_RTOL:
        raise AssertionError(f"mesh lm100m: a replayed loss is "
                             f"{replay_rel:.3g} from its first pass")
    losses = [m["loss"] for m in first[:restored] + hist[MESH_FAIL_AT:]]
    if not all(np.isfinite(losses)):
        raise AssertionError("mesh lm100m: a loss is not finite")
    limit = MESH_W1_RTOL if world == 1 else MESH_RTOL
    base_rel = [abs(a - b) / abs(b) for a, b in zip(losses, baseline)]
    if len(base_rel) != MESH_STEPS or max(base_rel) > limit:
        raise AssertionError(f"mesh lm100m: losses {losses} against the "
                             f"unsharded {baseline}: {base_rel} (limit "
                             f"{limit})")
    step_s = _median_step(stamps)
    prof = mesh_profile_step(ops, cfg, dev, mesh)
    per_step = planned // steps_run
    if prof["attention_kernels"] not in (0, per_step):
        raise AssertionError(f"mesh lm100m profiled step: "
                             f"{prof['attention_kernels']} attention "
                             f"kernels traced, planned {per_step}")
    return {"mesh": [1, world], "steps": MESH_STEPS,
            "ckpt_every": MESH_CKPT_EVERY, "fail_at": MESH_FAIL_AT,
            "restarts": report.restarts, "launches": launches,
            "planned_launches": planned, "call": list(call),
            "per_call": per_call, "losses": losses,
            "unsharded_losses": list(baseline),
            "max_rel_to_unsharded": max(base_rel),
            "bit_equal_to_unsharded": losses == list(baseline),
            "rtol": limit, "replay_max_rel": replay_rel, "train_s": wall,
            "step_ms_median": step_s * 1e3,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
            "profile_step": prof}


def mesh_profile_step(ops, cfg, dev, mesh) -> dict:
    """One lm100m step on ``mesh`` under ``lm_profile``, after a warm one,
    from a fresh state (phase 17's profiled step, on the mesh)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.device import strict_float32
    from repro_torch.launch.train import build_trainer
    init_state, run_step, _ = build_trainer(
        cfg, _mesh_train_cfg(), DataConfig(cfg.vocab, TRAIN_SEQ,
                                           TRAIN_BATCH), 0, dev, mesh)
    with strict_float32():
        state = run_step(init_state(), 0)
        prof = lm_profile(lambda: run_step(state, 1),
                          ops.PLAIN_BACKWARD_RANGE)
    del state
    torch.cuda.empty_cache()
    return prof


def mesh_int8_pod(ops, dev, world: int, uncompressed) -> dict:
    """lm100m, ``MESH_POD_STEPS`` steps of the same run with
    ``grad_compression="int8_pod"`` on a (1, 1, W) pod mesh: every
    compressed gradient against ``compress_replica`` of its input with
    n_pods = 1, bit for bit; the parameters after step 1 against an AdamW
    step from the initial state on step 1's compressed gradients, bit for
    bit (the step applies what the all-reduce returned); the losses
    against the uncompressed run's."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.device import strict_float32
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_trainer, train
    from repro_torch.models.params import tensors
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    cfg = get_config(TRAIN_ARCH)
    mesh = make_mesh((1, 1, world), ("pod", "data", "model"))
    tc = dc.replace(_mesh_train_cfg(), grad_compression="int8_pod")
    real = ts.compressed_pod_allreduce
    seen = {"calls": 0, "leaves": 0, "elements": 0, "differing": 0}
    first = {}

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def snapshot(tree):
        return [t.detach().clone() for t in tensors(tree)]

    def checked(grads, m):
        out = real(grads, m)
        seen["calls"] += 1
        if "grads" not in first:
            first["grads"] = snapshot(out)
        for g, o in zip(tensors(grads), tensors(out)):
            want = compress_replica(full(g).float().cpu().numpy()[None])
            got = full(o).cpu().numpy()
            seen["leaves"] += 1
            seen["elements"] += got.size
            seen["differing"] += int(np.sum(want.view(np.int32)
                                            != got.view(np.int32)))
        return out

    def after(state, step):          # ``step`` counts from 0
        if step == 0:
            first["params"] = snapshot(state.params)

    ops.reset_launches()
    ts.compressed_pod_allreduce = checked
    try:
        report = train(cfg, steps=MESH_POD_STEPS, global_batch=TRAIN_BATCH,
                       seq_len=TRAIN_SEQ, ckpt_every=10 * MESH_POD_STEPS,
                       train_cfg=tc, log_every=0, device=dev, mesh=mesh,
                       step_hook=after)
    finally:
        ts.compressed_pod_allreduce = real
    launches = ops.attention_launches
    losses = [m["loss"] for m in report.metrics_history]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, uncompressed)]
    if seen["calls"] != MESH_POD_STEPS or seen["differing"]:
        raise AssertionError(f"int8_pod: {seen} against the numpy replica")
    # step 1 again from the run's initial state, on a copy of its
    # compressed gradients as the all-reduce returned them
    init_state, _, _ = build_trainer(
        cfg, tc, DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH), 0, dev, mesh)
    state = init_state()
    with strict_float32():
        params, _, _ = adamw.apply_updates(tc.opt, state.params,
                                           first["grads"], state.opt_state)
    params_off = sum(int((full(a) != full(b)).sum()) for a, b in zip(
        tensors(params), first["params"]))
    if params_off:
        raise AssertionError(f"int8_pod: {params_off} parameters after "
                             f"step 1 differ from an AdamW step on the "
                             f"compressed gradients")
    if rel[0] > MESH_W1_RTOL or max(rel) > MESH_POD_RTOL:
        raise AssertionError(f"int8_pod: losses {losses} against the "
                             f"uncompressed {uncompressed}: {rel}")
    return {"mesh": [1, 1, world], "steps": MESH_POD_STEPS,
            "replica": seen, "losses": losses,
            "uncompressed_losses": list(uncompressed), "loss_rel": rel,
            "rtol": MESH_POD_RTOL, "step1_params_off": params_off,
            "launches": launches}


def mesh_decode(ops, fa, dev, world: int) -> dict:
    """qwen2.5-3b at full width in float32: a prefill of
    ``MESH_DECODE_PROMPT`` tokens and ``MESH_DECODE_NEW`` - 1 greedy
    decode steps through ``serving.engine`` unsharded (phase 15's path),
    then the same tokens on mesh (1, W) with the ``cache_pack``-placed
    cache, each after a warm prefill; every step's logits within ``LM_TOL`` × max |logit| of the
    unsharded ones; the mesh run's attention launches against the plans."""
    from repro_torch.configs import get_config
    from repro_torch.device import strict_float32
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import init_params, shard_params
    from repro_torch.models.transformer import model_defs
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import decode_step, prefill
    cfg = get_config(LM_ARCH)
    defs = model_defs(cfg)
    b, plen = MESH_DECODE_BATCH, MESH_DECODE_PROMPT
    toks = torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab, (b, plen)).astype(np.int32)).to(dev)
    sms = fa.device_sm_count(dev)
    h_l, kv_l = _mesh_heads(cfg.n_heads, cfg.n_kv_heads, world)
    planned = cfg.n_layers * fa.plan(b, h_l, kv_l, plen, plen, cfg.head_dim,
                                     torch.float32, sm_count=sms).launches
    for t in range(MESH_DECODE_NEW - 1):
        planned += cfg.n_layers * fa.plan(
            b, cfg.n_heads, cfg.n_kv_heads, 1, MESH_DECODE_MAX_SEQ,
            cfg.head_dim, torch.float32, q_offset=plen + t,
            sm_count=sms).launches

    def run(params, cache, chosen=None):
        """(logits, tokens, seconds a call, cache, the last token)."""
        times, logits, picked = [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(params, cfg, toks, cache)
        for t in range(MESH_DECODE_NEW):
            lg = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            logits.append(lg[:, :cfg.vocab].float().cpu())
            tok = (chosen[t] if chosen is not None
                   else torch.argmax(lg[:, :cfg.vocab], -1))
            picked.append(tok)
            if t == MESH_DECODE_NEW - 1:
                break
            t0 = time.perf_counter()
            lg, cache = decode_step(params, cfg, cache, tok, plen + t)
        return logits, picked, times, cache, tok

    last = plen + MESH_DECODE_NEW - 1         # one more step, profiled


    with strict_float32(), torch.no_grad():
        params = init_params(defs, seed=0, dtype=torch.float32, device=dev)
        # warm: one prefill on each path before the timed ones
        prefill(params, cfg, toks, init_cache(
            cfg, b, MESH_DECODE_MAX_SEQ, torch.float32, dev))
        cache = init_cache(cfg, b, MESH_DECODE_MAX_SEQ, torch.float32, dev)
        want, chosen, plain_times, cache, tok = run(params, cache)
        plain_prof = lm_profile(
            lambda: decode_step(params, cfg, cache, tok, last))
        del cache
        mesh = make_mesh((1, world), ("data", "model"))
        dparams = shard_params(params, defs, mesh)
        prefill(dparams, cfg, toks, init_cache(
            cfg, b, MESH_DECODE_MAX_SEQ, torch.float32, dev, mesh=mesh))
        cache = init_cache(cfg, b, MESH_DECODE_MAX_SEQ, torch.float32, dev,
                           mesh=mesh)
        ops.reset_launches()
        got, _, mesh_times, cache, _ = run(dparams, cache, chosen)
        torch.cuda.synchronize()
        launches = ops.attention_launches
        mesh_prof = lm_profile(
            lambda: decode_step(dparams, cfg, cache, tok, last))
        del cache, dparams, params
    torch.cuda.empty_cache()
    rel = [float((g - w).abs().max() / w.abs().max())
           for g, w in zip(got, want)]
    if launches != planned or max(rel) > LM_TOL:
        raise AssertionError(f"mesh decode: launches {launches} (planned "
                             f"{planned}), logits {rel} of max |logit| "
                             f"(limit {LM_TOL})")
    med = lambda xs: sorted(xs)[len(xs) // 2]
    return {"arch": LM_ARCH, "mesh": [1, world], "batch": b,
            "prompt": plen, "new_tokens": MESH_DECODE_NEW,
            "max_seq": MESH_DECODE_MAX_SEQ, "launches": launches,
            "planned_launches": planned, "logit_rel": rel,
            "max_logit_rel": max(rel), "tol": LM_TOL,
            "prefill_ms": mesh_times[0] * 1e3,
            "decode_ms_median": med(mesh_times[1:]) * 1e3,
            "unsharded_prefill_ms": plain_times[0] * 1e3,
            "unsharded_decode_ms_median": med(plain_times[1:]) * 1e3,
            "profile_decode": mesh_prof, "unsharded_profile_decode":
            plain_prof}


def mesh_rank(rank: int, world: int, store: str, out_path: str,
              baseline) -> None:
    """One rank of phase 18 (spawned): the process group over NCCL, then
    lm100m on (1, W), int8_pod on (1, 1, W) and the qwen2.5-3b decode on
    (1, W); rank 0 writes the results to ``out_path``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed
    dev = init_distributed(torch.device("cuda", rank),
                           init_method=f"file://{store}", rank=rank,
                           world_size=world, timeout_s=MESH_TIMEOUT_S)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"phase 18 runs {dist.get_backend()}")
    if baseline is None:            # a run of this phase alone
        from repro_torch.configs import get_config
        from repro_torch.launch.train import train
        report = train(get_config(TRAIN_ARCH), steps=MESH_STEPS,
                       global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       ckpt_every=10 * MESH_STEPS,
                       train_cfg=_mesh_train_cfg(), log_every=0, device=dev)
        baseline = [m["loss"] for m in report.metrics_history]
    out = {"world": world, "backend": dist.get_backend()}
    out["lm100m"] = mesh_train_lm(ops, fa, dev, world, baseline)
    out["int8_pod"] = mesh_int8_pod(
        ops, dev, world, out["lm100m"]["losses"][:MESH_POD_STEPS])
    out["decode"] = mesh_decode(ops, fa, dev, world)
    if rank == 0:
        pathlib.Path(out_path).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def mesh_phase(card: str, unsharded: Optional[dict] = None) -> dict:
    """Phase 18: the mesh layer at full width, one rank a visible card
    (W = ``torch.cuda.device_count()``, at most ``MESH_MAX_RANKS``),
    spawned from here over NCCL.  ``unsharded``: phase 17's lm100m record
    (its first ``MESH_STEPS`` losses the baseline, its median step and
    tokens/s printed beside the mesh's; the ranks compute the baseline
    when None)."""
    import gc
    import torch.multiprocessing as mp
    baseline = unsharded["first_losses"] if unsharded else None
    world = min(torch.cuda.device_count(), MESH_MAX_RANKS)
    print(f"phase 18: W = {world} rank{'s' if world > 1 else ''} over NCCL "
          f"({card})")
    gc.collect()
    torch.cuda.empty_cache()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    store = build / f"chip_smoke_mesh_store_{os.getpid()}"
    result = build / f"chip_smoke_mesh_{os.getpid()}.json"
    for f in (store, result):
        f.unlink(missing_ok=True)
    t0 = time.perf_counter()
    try:
        mp.spawn(mesh_rank, args=(world, str(store), str(result), baseline),
                 nprocs=world, join=True)
        out = json.loads(result.read_text())
    finally:
        for f in (store, result):
            f.unlink(missing_ok=True)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card
    lm, pod, dec = out["lm100m"], out["int8_pod"], out["decode"]
    if unsharded:
        lm["phase17_step_ms_median"] = unsharded["step_ms_median"]
        lm["phase17_tokens_per_s"] = unsharded["tokens_per_s"]
    print(f"  lm100m on mesh {lm['mesh']} ({card}): {lm['steps']} steps, "
          f"restarts {lm['restarts']}, replayed steps within "
          f"{lm['replay_max_rel']:.3g} of their first pass; attention "
          f"launches {lm['launches']} a rank = planned "
          f"{lm['planned_launches']} (local call {lm['call']}, "
          f"{lm['per_call']} a call); losses against phase 17's unsharded "
          f"run: max rel {lm['max_rel_to_unsharded']:.3g} (gate "
          f"{lm['rtol']}), bit-equal {lm['bit_equal_to_unsharded']}; "
          f"median step {lm['step_ms_median']:.1f} ms, "
          f"{lm['tokens_per_s']:.0f} tokens/s (phase 17 unsharded: "
          + (f"{unsharded['step_ms_median']:.1f} ms, "
             f"{unsharded['tokens_per_s']:.0f} tokens/s)" if unsharded
             else "not run)"))
    lp = lm["profile_step"]
    p17 = unsharded["profile_step"] if unsharded else None
    print(f"  lm100m profiled step on mesh {lm['mesh']} ({card}): device "
          f"{lp['device_busy_ms']:.1f} ms of {lp['traced_wall_ms']:.1f} ms "
          f"(idle share {lp['idle_share']:.3f}, {lp['device_events']} "
          f"device events; phase 17 unsharded: "
          + (f"{p17['device_busy_ms']:.1f} ms of "
             f"{p17['traced_wall_ms']:.1f} ms, idle "
             f"{p17['idle_share']:.3f}, {p17['device_events']} events)"
             if p17 else "not run)"))
    print(f"  int8_pod on mesh {pod['mesh']}: {pod['replica']['calls']} "
          f"calls, {pod['replica']['leaves']} gradients, "
          f"{pod['replica']['differing']} of {pod['replica']['elements']} "
          f"values off the numpy replica; {pod['step1_params_off']} "
          f"parameters after step 1 off an AdamW step on the compressed "
          f"gradients; losses against the uncompressed "
          f"run " + ", ".join(f"{r:.3g}" for r in pod["loss_rel"])
          + f" (gate {pod['rtol']}; step 1 {MESH_W1_RTOL})")
    print(f"  qwen2.5-3b decode on mesh {dec['mesh']}: launches "
          f"{dec['launches']} = planned {dec['planned_launches']}; logits "
          f"within {dec['max_logit_rel']:.3g} of max |logit| of the "
          f"unsharded path (limit {dec['tol']}); prefill "
          f"{dec['prefill_ms']:.1f} ms (unsharded "
          f"{dec['unsharded_prefill_ms']:.1f}), decode step median "
          f"{dec['decode_ms_median']:.1f} ms (unsharded "
          f"{dec['unsharded_decode_ms_median']:.1f})")
    mp_, up_ = dec["profile_decode"], dec["unsharded_profile_decode"]
    print(f"  qwen2.5-3b profiled decode step: mesh device "
          f"{mp_['device_busy_ms']:.2f} ms of {mp_['traced_wall_ms']:.1f} ms "
          f"(idle {mp_['idle_share']:.3f}, {mp_['device_events']} events), "
          f"unsharded {up_['device_busy_ms']:.2f} ms of "
          f"{up_['traced_wall_ms']:.1f} ms (idle {up_['idle_share']:.3f}, "
          f"{up_['device_events']} events)")
    out["launches"] = lm["launches"] + pod["launches"] + dec["launches"]
    return out


# ---------------------------------------------------------------------------
# Phase 19: the dry run — the meta trace against the real step
# ---------------------------------------------------------------------------

DRY_CELLS = (("qwen2.5-3b", "decode_32k"), ("qwen2.5-3b", "train_4k"))
DRY_STEPS = ("lm100m_train", "qwen_decode")
DRY_TIMEOUT_S = 900


def dry_lowerables(mesh, device) -> dict:
    """The two steps phase 19 holds against their meta trace, on
    ``mesh``: lm100m's training step in phase 17's configuration (32 ×
    256, 2 microbatches, remat ``dots``, float32) and qwen2.5-3b's decode
    step over phase 18's cache (batch 4, 256 slots, float32) at its last
    slot; on ``meta`` or for real on ``device``."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.specs import build_decode, build_train
    train = ShapeSpec("phase17_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    decode = ShapeSpec("phase18_decode", MESH_DECODE_MAX_SEQ,
                       MESH_DECODE_BATCH, "decode")
    return {"lm100m_train": lambda: build_train(
                TRAIN_ARCH, train, mesh, cfg=get_config(TRAIN_ARCH),
                train_cfg=_mesh_train_cfg(), dtype=torch.float32,
                device=device),
            "qwen_decode": lambda: build_decode(
                LM_ARCH, decode, mesh, dtype=torch.float32, device=device)}


def dry_meta(out_path: str) -> None:
    """Phase 19's process without a card (a fake process group, every
    tensor on ``meta``): the meta traces of ``dry_lowerables`` at mesh
    (1, 1), then the two production cells ``DRY_CELLS`` on 16×16 through
    ``launch.dryrun.run_cell``; written to ``out_path``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis.op_cost import analyze_trace
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake, make_mesh
    init_fake(1)
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for name, make in dry_lowerables(mesh, "meta").items():
        low = make()
        tr = low.lower()
        out[name] = {"keys": [r.key() for r in tr.records],
                     "cost": analyze_trace(tr, 1),
                     "arg_bytes": low.arg_bytes_per_device,
                     "local_arg_bytes": low.local_arg_bytes(),
                     "trace_s": tr.seconds}
    for arch, shape in DRY_CELLS:
        t0 = time.perf_counter()
        res = dryrun.run_cell(arch, shape, multi_pod=False)
        res["cell_s"] = time.perf_counter() - t0
        out[f"{arch}_{shape}_16x16"] = res
    torch.save(out, out_path)


def dry_rank(rank: int, world: int, store: str, out_path: str) -> None:
    """Phase 19's rank on the card (spawned, one rank over NCCL at mesh
    (1, 1), as phase 18 runs it): each step of ``dry_lowerables`` placed
    for real, run once under the op counter inside ``plain_attention``,
    then once on the kernel path (attention launches, peak memory) and
    once profiled."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.analysis.op_cost import analyze_trace
    from repro_torch.device import strict_float32
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models.layers import plain_attention
    dev = init_distributed(torch.device("cuda", rank),
                           init_method=f"file://{store}", rank=rank,
                           world_size=world, timeout_s=MESH_TIMEOUT_S)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"phase 19 runs {dist.get_backend()}")
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    with strict_float32():
        for name, make in dry_lowerables(mesh, dev).items():
            low = make()
            torch.cuda.synchronize()
            rec = {"arg_bytes": low.arg_bytes_per_device,
                   "local_arg_bytes": low.local_arg_bytes(),
                   "allocated_before": torch.cuda.memory_allocated(dev)}
            torch.cuda.reset_peak_memory_stats(dev)
            with plain_attention():
                tr = low.lower()
            torch.cuda.synchronize()
            rec.update(keys=[r.key() for r in tr.records],
                       cost=analyze_trace(tr, 1), traced_s=tr.seconds,
                       plain_max_allocated=torch.cuda.max_memory_allocated(
                           dev))
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launches()
            t0 = time.perf_counter()
            low.fn(*low.args)
            torch.cuda.synchronize()
            rec["kernel_path_s"] = time.perf_counter() - t0
            rec["launches"] = ops.attention_launches
            rec["max_allocated"] = torch.cuda.max_memory_allocated(dev)
            rec["profile"] = lm_profile(lambda: low.fn(*low.args),
                                        "attention_plain_backward")
            rec["launches_total"] = ops.attention_launches
            out[name] = rec
            del low, tr
            torch.cuda.empty_cache()
    if rank == 0:
        torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


def dry_planned(fa, dev) -> dict:
    """The attention kernel launches each step of ``dry_lowerables`` plans
    on the kernel path."""
    from repro_torch.configs import get_config
    sms = fa.device_sm_count(dev)
    cfg = get_config(TRAIN_ARCH)
    call = fa.plan(TRAIN_BATCH // TRAIN_MICRO, cfg.n_heads, cfg.n_kv_heads,
                   TRAIN_SEQ, TRAIN_SEQ, cfg.head_dim, torch.float32,
                   sm_count=sms).launches
    forwards = 1 if cfg.remat == "none" else 2      # + the remat recompute
    qcfg = get_config(LM_ARCH)
    dec = fa.plan(MESH_DECODE_BATCH, qcfg.n_heads, qcfg.n_kv_heads, 1,
                  MESH_DECODE_MAX_SEQ, qcfg.head_dim, torch.float32,
                  q_offset=MESH_DECODE_MAX_SEQ - 1, sm_count=sms).launches
    return {"lm100m_train": forwards * cfg.n_layers * TRAIN_MICRO * call,
            "qwen_decode": qcfg.n_layers * dec}


def start_dry_meta() -> dict:
    """Phase 19's process without the card (``dry_meta``), started before
    phase 17: it needs no card, so its traces run on the host beside the
    card's phases.  Its output goes to a file under ``build/``."""
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tag = os.getpid()
    job = {"path": build / f"chip_smoke_dry_meta_{tag}.pt",
           "log": build / f"chip_smoke_dry_meta_{tag}.log",
           "t0": time.perf_counter()}
    for key in ("path", "log"):
        job[key].unlink(missing_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.dry_meta({str(job['path'])!r})")
    with open(job["log"], "w") as log:
        job["proc"] = subprocess.Popen([sys.executable, "-c", code],
                                       cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT)
    return job


def stop_dry_meta(job: dict) -> None:
    """End phase 19's card-less process if it still runs, and remove its
    files."""
    if job["proc"].poll() is None:
        job["proc"].kill()
        job["proc"].wait()
    for key in ("path", "log"):
        job[key].unlink(missing_ok=True)


def dry_phase(fa, card: str, dev, job: Optional[dict] = None) -> dict:
    """Phase 19: the dry run.  A process without the card traces the two
    production cells and the meta traces of ``dry_lowerables``
    (``start_dry_meta``, ``job``: started before phase 17) while a rank
    over NCCL runs the same steps for real (``dry_rank``); every op of
    each real plain-path step must equal its meta trace's (op, operand
    shapes and dtypes, FLOPs, bytes, fused bytes, collectives), the
    argument bytes the placed trees' local bytes, and the kernel path's
    attention launches the plans' sum."""
    import gc
    import torch.multiprocessing as mp
    print(f"phase 19: the dry run ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    job = job or start_dry_meta()
    build = ROOT / "build"
    tag = os.getpid()
    store = build / f"chip_smoke_dry_store_{tag}"
    real_path = build / f"chip_smoke_dry_real_{tag}.pt"
    files = (store, real_path)
    for f in files:
        f.unlink(missing_ok=True)
    t0 = time.perf_counter()
    try:
        mp.spawn(dry_rank, args=(1, str(store), str(real_path)), nprocs=1,
                 join=True)
        real = torch.load(real_path, weights_only=False)
        job["proc"].wait(timeout=DRY_TIMEOUT_S)
        if job["proc"].returncode:
            raise AssertionError(f"phase 19's meta process failed:\n"
                                 f"{job['log'].read_text()[-4000:]}")
        meta = torch.load(job["path"], weights_only=False)
        meta_s = time.perf_counter() - job["t0"]
    finally:
        stop_dry_meta(job)
        for f in files:
            f.unlink(missing_ok=True)
    planned = dry_planned(fa, dev)
    out = {"card": card, "seconds": time.perf_counter() - t0,
           "meta_process_s": meta_s, "steps": {}, "cells": {}}
    failures = []
    for name in DRY_STEPS:
        m, r = meta[name], real[name]
        diffs = [f"op {i}: meta {a} != {card} {b}" for i, (a, b) in
                 enumerate(zip(m["keys"], r["keys"])) if a != b]
        if len(m["keys"]) != len(r["keys"]):
            diffs.append(f"{len(m['keys'])} ops on meta, "
                         f"{len(r['keys'])} on the card")
        mc, rc = m["cost"], r["cost"]
        terms = ("flops_per_device", "bytes_per_device",
                 "bytes_fused_per_device", "collective_bytes",
                 "collective_wire_per_device")
        differing = [t for t in terms if mc[t] != rc[t]]
        predicted = r["local_arg_bytes"] + mc["peak_temp_bytes_estimate"]
        step = {
            "ops": len(r["keys"]), "differing_ops": diffs[:20],
            "differing_terms": differing,
            "flops": rc["flops_per_device"],
            "matmul_flops": rc["matmul_flops_per_device"],
            "bytes": rc["bytes_per_device"],
            "bytes_fused": rc["bytes_fused_per_device"],
            "collective_bytes": rc["collective_bytes"],
            "arg_bytes_per_device": r["arg_bytes"],
            "local_arg_bytes": r["local_arg_bytes"],
            "meta_arg_bytes": m["arg_bytes"],
            "launches": r["launches"], "planned_launches": planned[name],
            "launches_with_profile": r["launches_total"],
            "flops_term_ms": rc["flops_per_device"] / F32_OPS_PER_S * 1e3,
            "bytes_term_ms": rc["bytes_per_device"] / HBM_BYTES_PER_S * 1e3,
            "bytes_fused_term_ms": (rc["bytes_fused_per_device"]
                                    / HBM_BYTES_PER_S * 1e3),
            "device_busy_ms": r["profile"]["device_busy_ms"],
            "traced_wall_ms": r["profile"]["traced_wall_ms"],
            "idle_share": r["profile"]["idle_share"],
            "top_device_ops": r["profile"]["top_device_ops"],
            "kernel_path_s": r["kernel_path_s"],
            "predicted_peak_bytes": predicted,
            "max_memory_allocated": r["max_allocated"],
            "plain_max_memory_allocated": r["plain_max_allocated"],
            "meta_trace_s": m["trace_s"], "card_traced_s": r["traced_s"]}
        out["steps"][name] = step
        if diffs or differing:
            failures.append(f"{name}: the meta trace parts from the card's "
                            f"step: " + "; ".join(diffs[:20] + differing))
        if not r["arg_bytes"] == r["local_arg_bytes"] == m["arg_bytes"]:
            failures.append(f"{name}: argument bytes {r['arg_bytes']} "
                            f"(specs), {r['local_arg_bytes']} (placed), "
                            f"{m['arg_bytes']} (meta)")
        if r["launches"] != planned[name]:
            failures.append(f"{name}: attention launches {r['launches']}, "
                            f"planned {planned[name]}")
        print(f"  {name} at mesh (1, 1) ({card}): {step['ops']} ops, the "
              f"meta trace's {len(m['keys'])}, {len(diffs)} differing; "
              f"flops {step['flops']:.4e} (matmul "
              f"{step['matmul_flops']:.4e}), bytes {step['bytes']:.4e}, "
              f"bytes_fused {step['bytes_fused']:.4e}, collectives "
              f"{sum(step['collective_bytes'].values()):.4e}; arguments "
              f"{step['arg_bytes_per_device']} B = placed "
              f"{step['local_arg_bytes']} B; attention launches "
              f"{step['launches']} = planned {step['planned_launches']}")
        print(f"    kernel path: device {step['device_busy_ms']:.2f} ms of "
              f"{step['traced_wall_ms']:.1f} ms (idle "
              f"{step['idle_share']:.3f}) against flops / 67 TFLOP/s "
              f"{step['flops_term_ms']:.2f} ms, bytes / 3.35 TB/s "
              f"{step['bytes_term_ms']:.2f} ms (fused "
              f"{step['bytes_fused_term_ms']:.2f} ms); peak memory "
              f"predicted {predicted / 1e9:.3f} GB, max allocated "
              f"{step['max_memory_allocated'] / 1e9:.3f} GB (plain path "
              f"{step['plain_max_memory_allocated'] / 1e9:.3f} GB)")
    for arch, shape in DRY_CELLS:
        tag = f"{arch}_{shape}_16x16"
        res = meta[tag]
        out["cells"][tag] = res
        c = res["cost"]
        print(f"  OK  {tag}: flops/dev={c['flops_per_device']:.3e} "
              f"bytes/dev={c['bytes_per_device']:.3e} "
              f"wire/dev={c['collective_wire_per_device']:.3e} "
              f"args/dev={res['arg_bytes_per_device']:.3e} "
              f"trace={res['lower_s']}s (cell {res['cell_s']:.1f} s)")
        print("  " + json.dumps(res))
    print(f"  phase 19: {out['seconds']:.1f} s (its card-less process "
          f"{meta_s:.1f} s from its start)")
    if failures:
        raise AssertionError("phase 19: " + " | ".join(failures))
    out["launches"] = sum(real[n]["launches_total"] for n in DRY_STEPS)
    return out


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


def only_phases(argv) -> set:
    """``--only 3,18,19``: the phases a development run takes (after the
    build); none without the option."""
    if not argv:
        return set()
    if len(argv) != 2 or argv[0] != "--only":
        raise SystemExit("usage: chip_smoke.py [--only 3,18,19]")
    phases = {int(x) for x in argv[1].split(",")}
    if not phases <= {3, 18, 19}:
        raise SystemExit("--only takes phases 3, 18 and 19")
    return phases


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

    only = only_phases(sys.argv[1:])
    if only:                        # a development run of some phases
        if 3 in only:
            record["grid_worst"] = check_kernel_grid(ops, ref, dev)
            record["vta_gemm_repeat"] = repeat_check(ref, dev)
        if 18 in only:
            record["mesh"] = mesh_phase(card)
        if 19 in only:
            record["dryrun"] = dry_phase(attn_kernel, card, dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_only.json").write_text(
            json.dumps(record, indent=1))
        print(f"phases {sorted(only)} passed (a partial run: no kernel "
              f"line)")
        return 0

    # -- 3. kernel vs plain ----------------------------------------------
    worst = check_kernel_grid(ops, ref, dev)
    record["vta_gemm_repeat"] = repeat_check(ref, dev)

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
                "after a split too, and adds phase 15's LM serve: "
                "launches_by_path; the LM path's two calls timed alone are "
                "lm_calls); ms = device time (CUDA-graph replay, "
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
    # -- 15. the LM server at full width -----------------------------------
    record["lm_serve"] = lm_phase(ops, ref, attn_kernel, card, dev)
    attn_entry = record["kernels"][1]
    attn_entry["launches_by_path"] = {
        "attention_path": attn_entry["launches"],
        "lm_serve": record["lm_serve"]["launches"]}
    attn_entry["launches"] += record["lm_serve"]["launches"]
    attn_entry["lm_calls"] = record["lm_serve"]["calls"]
    # -- 16. the quickstart; the LM smoke configs; MoE and RWKV-6 at full
    # width ------------------------------------------------------------------
    record["quickstart"] = quickstart_phase(ops, dev)
    entry["launches"] += record["quickstart"]["launches"]
    entry["launches_by_path"]["quickstart"] = record["quickstart"]["launches"]
    record["lm_smoke_card"] = smoke_card_phase()
    record["moe_serve"] = moe_phase(ops, ref, attn_kernel, card, dev)
    attn_entry["launches_by_path"]["moe_serve"] = \
        record["moe_serve"]["launches"]
    attn_entry["launches"] += record["moe_serve"]["launches"]
    attn_entry["lm_calls"] += record["moe_serve"]["calls"]
    record["rwkv_serve"] = rwkv_phase(ops, card, dev)
    # -- 17. training at full width -----------------------------------------
    dry_job = start_dry_meta()          # phase 19's host traces, from here
    try:
        record["train"] = train_phase(ops, ref, attn_kernel, card, dev)
        for key in ("lm100m", "qwen"):
            attn_entry["launches_by_path"][f"train_{key}"] = \
                record["train"][key]["launches"]
        attn_entry["launches"] += record["train"]["launches"]
        attn_entry["train_calls"] = record["train"]["calls"]
        # -- 18. the mesh layer: sharded training and decode over NCCL ------
        record["mesh"] = mesh_phase(card, record["train"]["lm100m"])
        attn_entry["launches_by_path"]["mesh"] = record["mesh"]["launches"]
        attn_entry["launches"] += record["mesh"]["launches"]
        # -- 19. the dry run: the meta trace against the real step -----------
        record["dryrun"] = dry_phase(attn_kernel, card, dev, dry_job)
    finally:
        stop_dry_meta(dry_job)
    attn_entry["launches_by_path"]["dryrun"] = record["dryrun"]["launches"]
    attn_entry["launches"] += record["dryrun"]["launches"]

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
