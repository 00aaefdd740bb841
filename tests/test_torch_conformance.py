"""The ``cuda`` and ``batched`` legs of the batched conformance draws, on
the CPU.

``tests/test_batched_conformance.py`` holds the reference's batched
runtime bit-identical to looping its per-image oracle over a DRAM stack's
rows.  Here the same seeded draws — random ``compile_matmul`` programs at
batch sizes 1–16, rows with varied weights, multi-chunk plans, streamed
UOP waves, padded conv/pool layers, stride-2 convs and global-average-pool
reductions — are compiled by both packages and run on the port's
``BatchCudaSimulator(device="cpu")`` (``vta_gemm``'s plain version), whose
OUT bytes must equal, row for row, the reference's ``run_batch`` and its
per-image oracle loop, and on the port's batched torch interpreter
(``BatchFastSimulator(device="cpu")``), whose whole DRAM stack and report
must equal the reference's ``run_batch``.

The engine pads a formed batch by repeating its last request and slices
the pad rows off; that is sound only if the ``cuda`` backend treats stack
rows independently.  The last draws serve padded batches and hold the real
rows equal to their unpadded serve.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.gemm_compiler as jgc                           # noqa: E402
import repro.core.hwconfig as jhw                                # noqa: E402
import repro.core.isa as jisa                                    # noqa: E402
import repro.core.layer_compiler as jlc                          # noqa: E402
import repro_torch.core.gemm_compiler as tgc                     # noqa: E402
import repro_torch.core.hwconfig as thw                          # noqa: E402
import repro_torch.core.isa as tisa                              # noqa: E402
import repro_torch.core.fast_simulator as tfs                    # noqa: E402
import repro_torch.core.layer_compiler as tlc                    # noqa: E402
from repro.core.fast_simulator import plan_for, run_batch        # noqa: E402
from repro.core.simulator import FunctionalSimulator             # noqa: E402
from repro_torch.core.cuda_backend import BatchCudaSimulator     # noqa: E402
from repro_torch.kernels import ops as tops                      # noqa: E402
from repro_torch.serving.vta import pad_ladder, padded_size      # noqa: E402

PORT = types.SimpleNamespace(gc=tgc, hw=thw, isa=tisa, lc=tlc)
REF = types.SimpleNamespace(gc=jgc, hw=jhw, isa=jisa, lc=jlc)


def _out_rows(prog, stack: np.ndarray) -> np.ndarray:
    region = prog.regions["out"]
    start = region.phys_addr - prog.allocator.offset
    return np.atleast_2d(stack)[:, start:start + region.nbytes]


def varied_stack(prog, rng, batch, vary=("inp", "acc")):
    """Row 0 keeps the compiled image; rows 1.. get random bytes in the
    ``vary`` regions (as ``test_batched_conformance.varied_stack``)."""
    base = prog.dram_image()
    stack = np.broadcast_to(base, (batch, base.size)).copy()
    for b in range(1, batch):
        for name in vary:
            if name not in prog.regions:
                continue
            region = prog.regions[name]
            start = region.phys_addr - prog.allocator.offset
            stack[b, start:start + region.nbytes] = rng.integers(
                0, 256, region.nbytes, dtype=np.uint8)
    return stack


def assert_cuda_leg(build, rng, batch, vary=("inp", "acc")) -> None:
    """Compile ``build(pkg)`` with both packages, run one varied stack on
    the port's batch simulators, the reference's ``run_batch`` and its
    per-image oracle loop, and require identical OUT bytes in every row —
    and, on the port's batched interpreter, the reference's whole stack
    and batch-total report."""
    tprog, jprog = build(PORT), build(REF)
    np.testing.assert_array_equal(tprog.dram_image(), jprog.dram_image())
    stack = varied_stack(jprog, rng, batch, vary)
    want, want_report = run_batch(jprog.config, stack, jprog.instructions,
                                  plan=plan_for(jprog), trace=True)
    got, got_report = tfs.run_batch(tprog.config, stack, tprog.instructions,
                                    plan=tfs.plan_for(tprog), trace=True,
                                    device="cpu")
    np.testing.assert_array_equal(got.numpy(), want,
                                  err_msg="batched interpreter leg")
    assert dataclasses.asdict(got_report) == dataclasses.asdict(want_report)
    for b in range(batch):
        oracle = FunctionalSimulator(jprog.config, stack[b].copy())
        oracle.run(jprog.instructions)
        np.testing.assert_array_equal(
            _out_rows(jprog, want)[b], _out_rows(jprog, oracle.dram)[0],
            err_msg=f"reference batch row {b} != its oracle")
    before = tops.launches
    sim = BatchCudaSimulator(tprog.config, stack.copy(), device="cpu")
    report = sim.run_program(tprog)
    assert tops.launches == before            # CPU tensors: plain version
    np.testing.assert_array_equal(_out_rows(tprog, sim.dram.numpy()),
                                  _out_rows(jprog, want))
    assert report.gemm_loops == batch * tprog.gemm_loops()


def _alu_draw(rng):
    """Random ALU post-ops (as the reference's draws pick them), returned
    as ``build(pkg)`` so both packages compile the same ops."""
    spec = []
    if rng.random() < 0.5:
        spec.append(("MAX", 0))                   # relu
    if rng.random() < 0.5:
        spec.append(("ADD", int(rng.integers(-200, 200))))
    if rng.random() < 0.4:
        spec.append(("MIN", int(rng.integers(0, 128))))
    if rng.random() < 0.5:
        spec.append(("SHR", int(rng.integers(1, 8))))
    return lambda pkg: [pkg.gc.AluImmOp(getattr(pkg.isa.AluOp, op), imm)
                        for op, imm in spec]


_SMALL = dict(inp_buff_vectors=64, wgt_buff_matrices=4, acc_buff_vectors=64,
              out_buff_vectors=64, uop_buff_entries=32)


def test_random_programs_random_batch_sizes():
    """Random shapes, ALU post-ops and X preloads × batch sizes 1–16."""
    rng = np.random.default_rng(303)
    for batch in [1, 16] + [int(b) for b in rng.integers(1, 17, 6)]:
        m, k, n = (int(rng.integers(1, 50)) for _ in range(3))
        A = rng.integers(-128, 128, (m, k)).astype(np.int8)
        B = rng.integers(-128, 128, (k, n)).astype(np.int8)
        X = (rng.integers(-10 ** 6, 10 ** 6, (m, n)).astype(np.int32)
             if rng.random() < 0.4 else None)
        ops = _alu_draw(rng)
        assert_cuda_leg(lambda pkg: pkg.gc.compile_matmul(
            A, B, X=X, alu_ops=ops(pkg)), rng, batch)


def test_varied_weights_drive_per_row_gemm():
    """Rows with different WGT bytes take the port's per-row launches."""
    rng = np.random.default_rng(304)
    for _ in range(4):
        m, k, n = (int(rng.integers(4, 40)) for _ in range(3))
        A = rng.integers(-128, 128, (m, k)).astype(np.int8)
        B = rng.integers(-128, 128, (k, n)).astype(np.int8)
        ops = _alu_draw(rng)
        assert_cuda_leg(lambda pkg: pkg.gc.compile_matmul(
            A, B, alu_ops=ops(pkg)), rng, int(rng.integers(2, 9)),
            vary=("inp", "acc", "wgt"))


@pytest.mark.parametrize("uop_entries", [None, 8, 16],
                         ids=["multi_chunk", "uop_waves_8", "uop_waves_16"])
def test_multi_chunk_and_uop_wave_programs(uop_entries):
    """A tiny SRAM forces §3.3 multi-chunk plans; a tiny UOP buffer
    streams LOAD_UOP waves mid-program (with an indexed ALU op)."""
    rng = np.random.default_rng(305 if uop_entries is None else 306)
    for _ in range(3 if uop_entries is None else 1):
        m = int(rng.integers(30, 80))
        k = int(rng.integers(20, 60))
        n = int(rng.integers(17, 50))
        A = rng.integers(-64, 64, (m, k)).astype(np.int8)
        B = rng.integers(-64, 64, (k, n)).astype(np.int8)
        if uop_entries is None:
            cfg = dict(_SMALL)
            ops = _alu_draw(rng)
        else:
            cfg = dict(_SMALL, uop_buff_entries=uop_entries)
            n_vec = -(-m // 16) * -(-n // 16) * 16
            idx = tuple(int(v) for v in rng.choice(n_vec, size=n_vec // 2,
                                                   replace=False))
            ops = lambda pkg: [pkg.gc.AluImmOp.relu(), pkg.gc.AluIndexedImmOp(
                pkg.isa.AluOp.ADD, 3, idx)]
        progs = []

        def build(pkg):
            prog = pkg.gc.compile_matmul(A, B, alu_ops=ops(pkg),
                                         cfg=pkg.hw.VTAConfig(**cfg))
            progs.append(prog)
            return prog
        assert_cuda_leg(build, rng, int(rng.integers(2, 7)))
        if uop_entries is None:
            assert progs[0].chunk_plan.n_chunks > 1
        else:
            assert sum(1 for i in progs[0].instructions
                       if isinstance(i, tisa.MemInsn)
                       and i.memory_type == tisa.MemId.UOP) > 1


@pytest.mark.parametrize("pool", ["max2x2", "avg2x2"])
def test_padded_conv_and_pool_layers(pool):
    """Same-padded conv + 2×2 max/avg pooling, multi-chunk: the pair and
    indexed ALU programs."""
    rng = np.random.default_rng(307 + (pool == "avg2x2"))
    w = rng.integers(-8, 8, (8, 3, 3, 3)).astype(np.int8)
    bias = rng.integers(-100, 100, (8,)).astype(np.int32)
    inp = rng.integers(-32, 64, (1, 3, 12, 12)).astype(np.int8)
    cfg = dict(inp_buff_vectors=256, wgt_buff_matrices=64,
               acc_buff_vectors=128, out_buff_vectors=128,
               uop_buff_entries=256)

    def build(pkg):
        spec = pkg.lc.LayerSpec(name=f"c_{pool}", kind="conv", weights=w,
                                bias=bias, padding=1, relu=True, pool=pool)
        layer = pkg.lc.compile_layer(spec, inp, cfg=pkg.hw.VTAConfig(**cfg))
        assert layer.n_chunks > 1
        return layer.program
    assert_cuda_leg(build, rng, 5)


def test_strided_conv_layers():
    """Stride-2 downsampling convs (k3/s2/p1 and k2/s2) drawn at random."""
    rng = np.random.default_rng(308)
    for case in range(6):
        c = int(rng.integers(1, 5))
        f = int(rng.integers(1, 9))
        hw = int(rng.choice([8, 12, 16]))
        k, pad = (3, 1) if rng.random() < 0.5 else (2, 0)
        w = rng.integers(-8, 8, (f, c, k, k)).astype(np.int8)
        bias = rng.integers(-100, 100, (f,)).astype(np.int32)
        relu = bool(rng.integers(2))
        inp = rng.integers(-32, 64, (1, c, hw, hw)).astype(np.int8)

        def build(pkg):
            layer = pkg.lc.compile_layer(pkg.lc.LayerSpec(
                f"s2_{case}", "conv", w, bias, stride=2, padding=pad,
                relu=relu), inp)
            assert (layer.out_h, layer.out_w) == (hw // 2, hw // 2)
            return layer.program
        assert_cuda_leg(build, rng, int(rng.integers(2, 7)))


def test_gap_reduction_layers():
    """Global-average-pool tree reductions, one β-chunked under a tiny ACC
    whose pair uops stream in LOAD_UOP waves."""
    rng = np.random.default_rng(309)
    small = dict(inp_buff_vectors=256, wgt_buff_matrices=64,
                 acc_buff_vectors=64, out_buff_vectors=64,
                 uop_buff_entries=32)
    for case in range(6):
        c = int(rng.integers(1, 5))
        if case % 2 == 0:
            f, hw = int(rng.integers(1, 9)), int(rng.choice([4, 8]))
        else:
            f, hw = int(rng.integers(60, 90)), 4
        w = rng.integers(-6, 7, (f, c, 1, 1)).astype(np.int8)
        bias = rng.integers(-50, 50, (f,)).astype(np.int32)
        relu = bool(rng.integers(2))
        inp = rng.integers(-32, 64, (1, c, hw, hw)).astype(np.int8)

        def build(pkg):
            cfg = (pkg.hw.vta_default() if case % 2 == 0
                   else pkg.hw.VTAConfig(**small))
            layer = pkg.lc.compile_layer(pkg.lc.LayerSpec(
                f"gap_{case}", "conv", w, bias, relu=relu, pool="gap"),
                inp, cfg=cfg)
            assert layer.keep_rows == (0,)
            assert (layer.n_chunks > 1) == (case % 2 == 1)
            return layer.program
        assert_cuda_leg(build, rng, int(rng.integers(2, 7)))


# ---------------------------------------------------------------------------
# Padding: the engine's pad rows leave the real rows' answers unchanged
# ---------------------------------------------------------------------------

def test_padded_stack_rows_are_independent():
    """A drawn program over a stack with its last row repeated up to the
    next ladder rung: the real rows' OUT bytes equal the unpadded stack's."""
    rng = np.random.default_rng(310)
    ladder = pad_ladder(16)
    for _ in range(6):
        m, k, n = (int(rng.integers(2, 40)) for _ in range(3))
        A = rng.integers(-128, 128, (m, k)).astype(np.int8)
        B = rng.integers(-128, 128, (k, n)).astype(np.int8)
        prog = tgc.compile_matmul(A, B, alu_ops=_alu_draw(rng)(PORT))
        real = int(rng.integers(1, 16))
        stack = varied_stack(prog, rng, real)
        rung = padded_size(real, ladder)
        padded = np.concatenate([stack] + [stack[-1:]] * (rung - real))
        outs = []
        for s in (stack, padded):
            sim = BatchCudaSimulator(prog.config, s.copy(), device="cpu")
            sim.run_program(prog)
            outs.append(_out_rows(prog, sim.dram.numpy()))
        np.testing.assert_array_equal(outs[1][:real], outs[0])


@pytest.mark.parametrize("model", ["lenet5", "resnet8"])
def test_padded_serve_matches_unpadded(model):
    """Served batches padded as the engine pads them (last request
    repeated up the ladder): the real rows equal their unpadded serve."""
    if model == "lenet5":
        from repro_torch.lenet5_e2e import compile_lenet5, request_images
        net = compile_lenet5()[1]
    else:
        from repro_torch.models.resnet8 import compile_resnet8
        from repro_torch.resnet8_e2e import request_images
        net = compile_resnet8()[0]
    rng = np.random.default_rng(311)
    ladder = net.padded_batch_sizes(8)
    images = request_images(8)
    for real in sorted({int(v) for v in rng.integers(1, 8, 3)} | {3}):
        batch = list(images[:real])
        rung = padded_size(real, ladder)
        assert rung > real or real in ladder
        want, _ = net.serve(batch, device="cpu")
        got, _ = net.serve(batch + [batch[-1]] * (rung - real),
                           device="cpu")
        assert got.shape[0] == rung
        np.testing.assert_array_equal(got[:real], want)
