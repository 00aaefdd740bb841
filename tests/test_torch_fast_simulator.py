"""The port's torch interpreters against the reference's, on the CPU.

``repro_torch.core.fast_simulator`` copies the reference's plan compiler
and writes ``FastSimulator``, ``BatchFastSimulator`` and ``run_batch`` in
torch on an explicit device.  Here both packages compile the same programs
(the seeded draws of ``tests/test_fast_simulator.py`` and
``tests/test_batched_conformance.py``) and run them on the reference's
numpy interpreters and on the port's with ``device="cpu"``; tolerance 0:

* ``compile_plan``'s steps are equal, array for array;
* DRAM bytes, every SRAM buffer and every ``SimReport`` field (loop counts,
  DRAM traffic, ``insn_executed``, ``insn_trace``, the two overflow
  counters, the dependency-token counts) are equal, on random GEMM/ALU
  programs, multi-chunk plans, UOP waves, read-after-write ALU lattices
  (the sequential path), per-row UOP/WGT stacks (the general paths),
  float32-exactness boundary cases and ``count_overflows`` on and off;
* the batched interpreter's uniformity latches and its refusals match.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.fast_simulator as jfs                          # noqa: E402
import repro.core.gemm_compiler as jgc                           # noqa: E402
import repro.core.hwconfig as jhw                                # noqa: E402
import repro.core.isa as jisa                                    # noqa: E402
import repro.core.layer_compiler as jlc                          # noqa: E402
import repro.core.simulator as jsim                              # noqa: E402
import repro_torch.core.fast_simulator as tfs                    # noqa: E402
import repro_torch.core.gemm_compiler as tgc                     # noqa: E402
import repro_torch.core.hwconfig as thw                          # noqa: E402
import repro_torch.core.isa as tisa                              # noqa: E402
import repro_torch.core.layer_compiler as tlc                    # noqa: E402
import repro_torch.core.simulator as tsim                        # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402

PORT = types.SimpleNamespace(gc=tgc, hw=thw, isa=tisa, lc=tlc, fs=tfs)
REF = types.SimpleNamespace(gc=jgc, hw=jhw, isa=jisa, lc=jlc, fs=jfs)

REPORT_FIELDS = [f.name for f in dataclasses.fields(jsim.SimReport)]
BUFFERS = ("uop_buf", "inp_buf", "wgt_buf", "acc_buf", "out_buf")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def assert_same_run(jsim_, tsim_, jrep, trep):
    np.testing.assert_array_equal(_np(tsim_.dram), jsim_.dram,
                                  err_msg="DRAM diverged")
    for name in BUFFERS:
        np.testing.assert_array_equal(_np(getattr(tsim_, name)),
                                      getattr(jsim_, name), err_msg=name)
    for field in REPORT_FIELDS:
        assert getattr(trep, field) == getattr(jrep, field), field


def run_both(jprog, tprog, *, stack=None, count_overflows=False):
    """Run one program on both packages' single-image interpreter (or, with
    ``stack``, their batch interpreter) and require every observable
    equal.  Returns the reference's report."""
    assert tisa.encode_stream(tprog.instructions) == \
        jisa.encode_stream(jprog.instructions)
    kw = dict(trace=True, count_overflows=count_overflows)
    if stack is None:
        image = jprog.dram_image()
        np.testing.assert_array_equal(tprog.dram_image(), image)
        js = jfs.FastSimulator(jprog.config, image, **kw)
        ts = tfs.FastSimulator(tprog.config, image, device="cpu", **kw)
    else:
        js = jfs.BatchFastSimulator(jprog.config, stack, **kw)
        ts = tfs.BatchFastSimulator(tprog.config, stack, device="cpu", **kw)
    jrep = js.run(jprog.instructions, plan=jfs.plan_for(jprog))
    trep = ts.run(tprog.instructions, plan=tfs.plan_for(tprog))
    assert_same_run(js, ts, jrep, trep)
    if stack is not None:
        assert ts._uniform == js._uniform
    return jrep


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


def both(build, rng, *, batches=(3,), vary=("inp", "acc")):
    """Compile ``build(pkg)`` with both packages and hold the single-image
    and batch interpreters equal, with the overflow counters off and on."""
    jprog, tprog = build(REF), build(PORT)
    for co in (False, True):
        run_both(jprog, tprog, count_overflows=co)
        for batch in batches:
            run_both(jprog, tprog, stack=varied_stack(jprog, rng, batch,
                                                      vary),
                     count_overflows=co)
    return jprog


def _alu_draw(rng, min_p=0.5):
    """Random immediate post-ops as the reference's draws pick them,
    returned as ``build(pkg)`` for both packages."""
    spec = []
    if rng.random() < 0.5:
        spec.append(("MAX", 0))
    if rng.random() < 0.5:
        spec.append(("ADD", int(rng.integers(-200, 200))))
    if rng.random() < min_p:
        spec.append(("MIN", int(rng.integers(0, 128))))
    if rng.random() < 0.5:
        spec.append(("SHR", int(rng.integers(1, 8))))
    return lambda pkg: [pkg.gc.AluImmOp(getattr(pkg.isa.AluOp, op), imm)
                        for op, imm in spec]


_SMALL = dict(inp_buff_vectors=64, wgt_buff_matrices=4, acc_buff_vectors=64,
              out_buff_vectors=64, uop_buff_entries=32)


# ---------------------------------------------------------------------------
# Plan compilation
# ---------------------------------------------------------------------------

def _steps_equal(js, ts):
    assert type(js).__name__ == type(ts).__name__
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("case", range(4))
def test_compile_plan_steps_equal(case):
    rng = np.random.default_rng(900 + case)
    m, k, n = (int(rng.integers(1, 70)) for _ in range(3))
    A = rng.integers(-128, 128, (m, k)).astype(np.int8)
    B = rng.integers(-128, 128, (k, n)).astype(np.int8)
    ops = _alu_draw(rng)
    cfg = _SMALL if case % 2 else {}
    progs = [pkg.gc.compile_matmul(A, B, alu_ops=ops(pkg),
                                   cfg=pkg.hw.VTAConfig(**cfg))
             for pkg in (REF, PORT)]
    plans = [jfs.compile_plan(progs[0].config, progs[0].instructions),
             tfs.compile_plan(progs[1].config, progs[1].instructions)]
    assert plans[0].n_insns == plans[1].n_insns
    for (_, js), (_, ts) in zip(plans[0].steps, plans[1].steps):
        _steps_equal(js, ts)
    # the cached plan is reused, and replacing an instruction recompiles
    prog = progs[1]
    assert tfs.plan_for(prog) is tfs.plan_for(prog)
    first = tfs.plan_for(prog)
    prog.instructions[-1] = tisa.FinishInsn()
    assert tfs.plan_for(prog) is not first
    tfs.invalidate_plan(prog)
    assert not hasattr(prog, "_fast_plan")


def test_compile_plan_padding_and_overlap_steps():
    cfg_j, cfg_t = jhw.vta_default(), thw.vta_default()
    mk = lambda isa: [
        isa.MemInsn(isa.Opcode.LOAD, isa.MemId.INP, sram_base=3, dram_base=2,
                    y_size=3, x_size=4, x_stride=6, y_pad_0=1, y_pad_1=2,
                    x_pad_0=1, x_pad_1=2),
        isa.MemInsn(isa.Opcode.STORE, isa.MemId.OUT, sram_base=0,
                    dram_base=100, y_size=3, x_size=4, x_stride=2),
        isa.MemInsn(isa.Opcode.STORE, isa.MemId.OUT, sram_base=0,
                    dram_base=100, y_size=0, x_size=4, x_stride=4),
        isa.FinishInsn()]
    pj = jfs.compile_plan(cfg_j, mk(jisa))
    pt = tfs.compile_plan(cfg_t, mk(tisa))
    for (_, js), (_, ts) in zip(pj.steps, pt.steps):
        _steps_equal(js, ts)
    with pytest.raises(ValueError, match="STORE UOP"):
        tfs.compile_plan(cfg_t, [tisa.MemInsn(
            tisa.Opcode.STORE, tisa.MemId.UOP, sram_base=0, dram_base=0,
            y_size=1, x_size=1, x_stride=1)])


# ---------------------------------------------------------------------------
# Programs: the reference's seeded draws
# ---------------------------------------------------------------------------

def test_fuzz_matmul_programs():
    """Random shapes / X preloads / ALU post-ops (seed 2026 draws)."""
    rng = np.random.default_rng(2026)
    for _ in range(8):
        m, k, n = (int(rng.integers(1, 70)) for _ in range(3))
        A = rng.integers(-128, 128, (m, k)).astype(np.int8)
        B = rng.integers(-128, 128, (k, n)).astype(np.int8)
        X = (rng.integers(-10 ** 6, 10 ** 6, (m, n)).astype(np.int32)
             if rng.random() < 0.4 else None)
        ops = _alu_draw(rng)
        both(lambda pkg: pkg.gc.compile_matmul(A, B, X=X, alu_ops=ops(pkg)),
             rng, batches=(1, int(rng.integers(2, 9))))


def test_fuzz_multi_chunk_programs():
    """Tiny SRAM forces multi-chunk plans (§3.3 repetition)."""
    rng = np.random.default_rng(7)
    for _ in range(3):
        m, k, n = (int(rng.integers(20, 100)), int(rng.integers(20, 100)),
                   int(rng.integers(20, 80)))
        A = rng.integers(-128, 128, (m, k)).astype(np.int8)
        B = rng.integers(-128, 128, (k, n)).astype(np.int8)
        ops = _alu_draw(rng)
        jprog = both(lambda pkg: pkg.gc.compile_matmul(
            A, B, alu_ops=ops(pkg), cfg=pkg.hw.VTAConfig(**_SMALL)), rng)
        assert jprog.chunk_plan.n_chunks > 1


def test_tpu_profile_block_128():
    """block_size=128: the chunked product path at a wider block."""
    rng = np.random.default_rng(3)
    A = rng.integers(-16, 16, (130, 200)).astype(np.int8)
    B = rng.integers(-16, 16, (200, 140)).astype(np.int8)
    both(lambda pkg: pkg.gc.compile_matmul(A, B, alu_ops=[
        pkg.gc.AluImmOp.relu()], cfg=pkg.hw.vta_tpu()), rng, batches=(2,))


def test_alu_vector_pair_shr_and_indexed():
    """Vector-pair SHR, ADD pairs into a base row + indexed SHR, and MIN /
    MAX pairs: the ``index_add_`` / ``scatter_reduce_`` merges."""
    rng = np.random.default_rng(17)
    A = rng.integers(0, 8, (16, 16)).astype(np.int8)
    B = rng.integers(0, 8, (16, 16)).astype(np.int8)
    both(lambda pkg: pkg.gc.compile_matmul(A, B, alu_ops=[
        pkg.gc.AluPairOp(pkg.isa.AluOp.SHR, ((0, 1), (2, 3), (5, 4)))]),
        rng)
    rng = np.random.default_rng(23)
    A = rng.integers(-16, 16, (32, 16)).astype(np.int8)
    B = rng.integers(-16, 16, (16, 16)).astype(np.int8)
    pairs = tuple((dst, src) for dst in (0, 4, 8)
                  for src in (dst + 1, dst + 2, dst + 3))
    for op in ("ADD", "MIN", "MAX", "SHR"):
        both(lambda pkg: pkg.gc.compile_matmul(A, B, alu_ops=[
            pkg.gc.AluPairOp(getattr(pkg.isa.AluOp, op), pairs),
            pkg.gc.AluIndexedImmOp(pkg.isa.AluOp.SHR, 2, (0, 4, 8))]), rng)


def test_alu_pair_read_after_write_takes_sequential_path():
    """acc[1] += acc[2]; acc[0] += acc[1] — the second pair reads the
    first's destination: the host loop in oracle order."""
    rng = np.random.default_rng(31)
    A = rng.integers(-8, 8, (16, 16)).astype(np.int8)
    B = rng.integers(-8, 8, (16, 16)).astype(np.int8)
    for op in ("ADD", "MAX", "SHR"):
        both(lambda pkg: pkg.gc.compile_matmul(A, B, alu_ops=[
            pkg.gc.AluPairOp(getattr(pkg.isa.AluOp, op), ((1, 2), (0, 1)))]),
            rng)


def test_fuzz_multi_chunk_indexed_and_pair_programs():
    rng = np.random.default_rng(2027)
    for _ in range(3):
        m, k, n = (int(rng.integers(40, 100)), int(rng.integers(20, 80)),
                   int(rng.integers(17, 60)))
        A = rng.integers(-64, 64, (m, k)).astype(np.int8)
        B = rng.integers(-64, 64, (k, n)).astype(np.int8)
        rh, alpha, beta = 16, -(-m // 16), -(-n // 16)
        n_vec = alpha * beta * rh
        idx = tuple(int(v) for v in
                    rng.choice(n_vec, size=min(n_vec, 40), replace=False))
        pairs = []
        for _ in range(10):
            br, bc = int(rng.integers(0, alpha)), int(rng.integers(0, beta))
            w0, w1 = rng.choice(rh, size=2, replace=False)
            base = (br * beta + bc) * rh
            pairs.append((base + int(w0), base + int(w1)))
        jprog = both(lambda pkg: pkg.gc.compile_matmul(
            A, B, cfg=pkg.hw.VTAConfig(**_SMALL),
            alu_ops=[pkg.gc.AluImmOp.relu(),
                     pkg.gc.AluPairOp(pkg.isa.AluOp.ADD, tuple(pairs)),
                     pkg.gc.AluIndexedImmOp(pkg.isa.AluOp.SHR, 2, idx)]),
            rng)
        assert jprog.chunk_plan.n_chunks > 1


@pytest.mark.parametrize("uop_entries", [8, 12, 20])
def test_fuzz_uop_wave_streaming(uop_entries):
    """Uop lists past the buffer stream LOAD_UOP waves mid-program."""
    rng = np.random.default_rng(2028 + uop_entries)
    m, k, n = (int(rng.integers(40, 90)), int(rng.integers(20, 60)),
               int(rng.integers(10, 40)))
    A = rng.integers(-64, 64, (m, k)).astype(np.int8)
    B = rng.integers(-64, 64, (k, n)).astype(np.int8)
    n_vec = -(-m // 16) * -(-n // 16) * 16
    idx = tuple(int(v) for v in rng.choice(n_vec, size=n_vec // 2,
                                           replace=False))
    jprog = both(lambda pkg: pkg.gc.compile_matmul(
        A, B, cfg=pkg.hw.VTAConfig(**dict(_SMALL,
                                          uop_buff_entries=uop_entries)),
        alu_ops=[pkg.gc.AluImmOp.relu(),
                 pkg.gc.AluIndexedImmOp(pkg.isa.AluOp.ADD, 3, idx)]), rng)
    assert sum(1 for i in jprog.instructions
               if isinstance(i, jisa.MemInsn)
               and i.memory_type == jisa.MemId.UOP) > 1


@pytest.mark.parametrize("pool", ["max2x2", "avg2x2", "gap"])
def test_padded_conv_pool_layers(pool):
    """Same-padded conv + max/avg pooling (multi-chunk) and a global
    average pool: the pair/indexed ALU programs of the CNNs."""
    rng = np.random.default_rng(44)
    w = rng.integers(-8, 8, (8, 3, 3 if pool != "gap" else 1,
                             3 if pool != "gap" else 1)).astype(np.int8)
    bias = rng.integers(-100, 100, (8,)).astype(np.int32)
    hw = 12 if pool != "gap" else 8          # a power-of-two GAP map
    inp = rng.integers(-32, 64, (1, 3, hw, hw)).astype(np.int8)
    cfg = dict(inp_buff_vectors=256, wgt_buff_matrices=64,
               acc_buff_vectors=128, out_buff_vectors=128,
               uop_buff_entries=256)

    def build(pkg):
        spec = pkg.lc.LayerSpec(name=f"c_{pool}", kind="conv", weights=w,
                                bias=bias, padding=1 if pool != "gap" else 0,
                                relu=True, pool=pool)
        return pkg.lc.compile_layer(spec, inp,
                                    cfg=pkg.hw.VTAConfig(**cfg)).program
    both(build, rng, batches=(4,))


def test_strided_conv_layers():
    rng = np.random.default_rng(308)
    for case in range(3):
        c, f = int(rng.integers(1, 5)), int(rng.integers(1, 9))
        hw = int(rng.choice([8, 12, 16]))
        k, pad = (3, 1) if rng.random() < 0.5 else (2, 0)
        w = rng.integers(-8, 8, (f, c, k, k)).astype(np.int8)
        bias = rng.integers(-100, 100, (f,)).astype(np.int32)
        inp = rng.integers(-32, 64, (1, c, hw, hw)).astype(np.int8)
        both(lambda pkg: pkg.lc.compile_layer(pkg.lc.LayerSpec(
            f"s2_{case}", "conv", w, bias, stride=2, padding=pad,
            relu=True), inp).program, rng)


def test_pipelined_schedule_program():
    rng = np.random.default_rng(305)
    A = rng.integers(-64, 64, (60, 40)).astype(np.int8)
    B = rng.integers(-64, 64, (40, 30)).astype(np.int8)
    jprog = both(lambda pkg: pkg.gc.compile_matmul(
        A, B, alu_ops=[pkg.gc.AluImmOp.relu()],
        cfg=pkg.hw.VTAConfig(**_SMALL), schedule="pipelined"), rng)
    assert jprog.schedule == "pipelined"


def test_extreme_values_at_f32_exactness_boundary():
    """(-128)·(-128) products with contractions at and past the float32
    exactness limit (c·bs = 1024 and 1040): the fused matmul at its bound,
    the chunked path beyond it."""
    rng = np.random.default_rng(404)
    for k in (1024, 1040):
        A = np.full((16, k), -128, dtype=np.int8)
        B = np.full((k, 16), -128, dtype=np.int8)
        A[0, :7] = 127
        B[:5, 3] = 127
        both(lambda pkg: pkg.gc.compile_matmul(A, B), rng, batches=(3,))


def test_int64_dots_match_float_dots():
    """The int64 product-sum (dots longer than the float32 limit) and the
    float32 matmul agree exactly where both apply."""
    rng = np.random.default_rng(5)
    W = torch.from_numpy(rng.integers(-128, 128, (7, 16, 16), dtype=np.int8))
    A = torch.from_numpy(rng.integers(-128, 128, (7, 16), dtype=np.int8))
    want = np.einsum("lij,lj->li", W.numpy().astype(np.int64),
                     A.numpy().astype(np.int64))
    np.testing.assert_array_equal(tfs._dots(W, A).numpy(), want)
    wide = (W.to(torch.int64) * A.to(torch.int64).unsqueeze(-2)).sum(-1)
    np.testing.assert_array_equal(wide.numpy(), want)
    Ab = torch.from_numpy(rng.integers(-128, 128, (3, 7, 16), dtype=np.int8))
    np.testing.assert_array_equal(
        tfs._dots_shared(W, Ab).numpy(),
        np.einsum("lij,blj->bli", W.numpy().astype(np.int64),
                  Ab.numpy().astype(np.int64)))


# ---------------------------------------------------------------------------
# Overflow counters
# ---------------------------------------------------------------------------

def test_saturation_and_overflow_counters():
    rng = np.random.default_rng(0)
    A = rng.integers(-128, 128, (8, 32)).astype(np.int8)
    B = rng.integers(-128, 128, (32, 8)).astype(np.int8)
    both(lambda pkg: pkg.gc.compile_matmul(A, B), rng)
    A = np.full((1, 16), 127, dtype=np.int8)
    B = np.full((16, 16), 127, dtype=np.int8)
    X = np.full((1, 16), 2 ** 31 - 1, dtype=np.int32)
    prog = tgc.compile_matmul(A, B, X=X)
    for backend in ("oracle", "fast", "batched"):
        _, rep = tsim.run_program(prog, backend=backend, device="cpu",
                                  count_overflows=True)
        assert rep.acc_overflow_lanes > 0, backend
        _, jrep = jsim.run_program(jgc.compile_matmul(A, B, X=X),
                                   backend=backend, count_overflows=True)
        assert rep.acc_overflow_lanes == jrep.acc_overflow_lanes
        assert rep.acc_saturation_lanes == jrep.acc_saturation_lanes


# ---------------------------------------------------------------------------
# Hand-crafted streams: padding, degenerate stores, per-row divergence
# ---------------------------------------------------------------------------

def _handcrafted_stream(isa, nu):
    """``test_batched_conformance._handcrafted_stream``: LOAD UOP/INP/WGT/ACC
    → GEMM reset → GEMM → ALU imm → ALU pair (overlapping: the sequential
    path) → STORE OUT."""
    return [
        isa.MemInsn(isa.Opcode.LOAD, isa.MemId.UOP, sram_base=0,
                    dram_base=0, y_size=1, x_size=nu, x_stride=nu),
        isa.MemInsn(isa.Opcode.LOAD, isa.MemId.INP, sram_base=0,
                    dram_base=64, y_size=2, x_size=4, x_stride=6,
                    x_pad_0=1, y_pad_1=1),
        isa.MemInsn(isa.Opcode.LOAD, isa.MemId.WGT, sram_base=0,
                    dram_base=8, y_size=1, x_size=2, x_stride=2),
        isa.MemInsn(isa.Opcode.LOAD, isa.MemId.ACC, sram_base=0,
                    dram_base=64, y_size=2, x_size=8, x_stride=20),
        isa.GemInsn(reset=1, uop_bgn=0, uop_end=nu, iter_out=1, iter_in=2,
                    acc_factor_in=4),
        isa.GemInsn(uop_bgn=0, uop_end=nu, iter_out=2, iter_in=2,
                    acc_factor_out=8, acc_factor_in=4,
                    inp_factor_out=2, inp_factor_in=1, wgt_factor_out=1),
        isa.AluInsn(alu_opcode=isa.AluOp.ADD, uop_bgn=0, uop_end=nu,
                    iter_out=2, iter_in=1, dst_factor_out=8,
                    use_imm=1, imm=5),
        isa.AluInsn(alu_opcode=isa.AluOp.ADD, uop_bgn=0, uop_end=nu,
                    iter_out=1, iter_in=1),
        isa.MemInsn(isa.Opcode.STORE, isa.MemId.OUT, sram_base=0,
                    dram_base=512, y_size=1, x_size=16, x_stride=16),
        isa.FinishInsn(),
    ]


def _handcrafted_stack(rng, batch, nu, *, vary_uops, vary_wgt):
    stack = np.zeros((batch, 16384), dtype=np.uint8)
    for b in range(batch):
        salt = b if vary_uops else 0
        words = np.array([((k + salt) % 16) | (((k * 3 + salt) % 8) << 11)
                          | (((k + salt) % 2) << 22) for k in range(nu)],
                         dtype="<u4")
        stack[b, :nu * 4] = words.view(np.uint8)
        wsalt = rng.integers(0, 256, 2 * 256, dtype=np.uint8)
        stack[b, 2048:2048 + 2 * 256] = wsalt if vary_wgt else 0
        stack[b, 1024:1024 + 256] = rng.integers(0, 256, 256, dtype=np.uint8)
        stack[b, 4096:4096 + 28 * 64] = rng.integers(0, 256, 28 * 64,
                                                     dtype=np.uint8)
    if not vary_wgt:
        stack[:, 2048:2048 + 2 * 256] = rng.integers(
            0, 256, 2 * 256, dtype=np.uint8)[None]
    return stack


@pytest.mark.parametrize("vary_uops,vary_wgt", [
    (True, True), (False, True), (False, False)],
    ids=["general", "shared_lattice_per_row_wgt", "uniform"])
@pytest.mark.parametrize("count_overflows", [False, True],
                         ids=["plain", "counted"])
def test_handcrafted_per_row_uop_wgt_divergence(vary_uops, vary_wgt,
                                                count_overflows):
    """Per-row UOP/WGT bytes drive the general (non-uniform) paths; the
    latch, DRAM, buffers and reports equal the reference's, and row by
    row the single-image interpreter's."""
    rng = np.random.default_rng(99)
    nu = 24
    stack = _handcrafted_stack(rng, 6, nu, vary_uops=vary_uops,
                               vary_wgt=vary_wgt)
    cfg_j, cfg_t = jhw.vta_default(), thw.vta_default()
    kw = dict(trace=True, count_overflows=count_overflows)
    js = jfs.BatchFastSimulator(cfg_j, stack, **kw)
    ts = tfs.BatchFastSimulator(cfg_t, stack, device="cpu", **kw)
    jrep = js.run(_handcrafted_stream(jisa, nu))
    trep = ts.run(_handcrafted_stream(tisa, nu))
    assert_same_run(js, ts, jrep, trep)
    assert ts._uniform == js._uniform == {"uop": not vary_uops,
                                          "wgt": not vary_wgt}
    assert trep.gemm_loops == 6 * 2 * 2 * nu
    for b in (0, 5):
        j1 = jfs.FastSimulator(cfg_j, stack[b], **kw)
        t1 = tfs.FastSimulator(cfg_t, stack[b], device="cpu", **kw)
        assert_same_run(j1, t1, j1.run(_handcrafted_stream(jisa, nu)),
                        t1.run(_handcrafted_stream(tisa, nu)))


def test_load_padding_and_degenerate_store():
    cfg_j, cfg_t = jhw.vta_default(), thw.vta_default()
    dram = np.random.default_rng(5).integers(0, 256, 4096).astype(np.uint8)
    mk = lambda isa: [
        isa.MemInsn(isa.Opcode.LOAD, isa.MemId.INP, sram_base=3, dram_base=2,
                    y_size=3, x_size=4, x_stride=6, y_pad_0=1, y_pad_1=2,
                    x_pad_0=1, x_pad_1=2),
        isa.MemInsn(isa.Opcode.LOAD, isa.MemId.ACC, sram_base=1, dram_base=3,
                    y_size=2, x_size=3, x_stride=2),
        isa.MemInsn(isa.Opcode.STORE, isa.MemId.OUT, sram_base=0,
                    dram_base=100, y_size=3, x_size=4, x_stride=2),
        isa.MemInsn(isa.Opcode.STORE, isa.MemId.OUT, sram_base=0,
                    dram_base=100, y_size=0, x_size=4, x_stride=4),
        isa.FinishInsn()]
    js, ts = jfs.FastSimulator(cfg_j, dram), tfs.FastSimulator(
        cfg_t, dram, device="cpu")
    assert_same_run(js, ts, js.run(mk(jisa)), ts.run(mk(tisa)))
    stack = np.stack([dram, dram[::-1].copy()])
    js, ts = jfs.BatchFastSimulator(cfg_j, stack), tfs.BatchFastSimulator(
        cfg_t, stack, device="cpu")
    assert_same_run(js, ts, js.run(mk(jisa)), ts.run(mk(tisa)))


def test_hazards_detected_on_both():
    rng = np.random.default_rng(1)
    A = rng.integers(-64, 64, (16, 16)).astype(np.int8)
    B = rng.integers(-64, 64, (16, 16)).astype(np.int8)
    prog = tgc.compile_matmul(A, B)
    for i in prog.instructions:
        if isinstance(i, tisa.MemInsn) and i.memory_type == tisa.MemId.WGT:
            i.dep.push_next = 0
    for sim in (tfs.FastSimulator(prog.config, prog.dram_image(),
                                  device="cpu"),
                tfs.BatchFastSimulator(prog.config, prog.dram_image()[None],
                                       device="cpu")):
        with pytest.raises(tsim.VTAHazardError):
            sim.run(prog.instructions)


# ---------------------------------------------------------------------------
# run_batch, the simulator plumbing, the refusals
# ---------------------------------------------------------------------------

def test_run_batch_and_backends():
    rng = np.random.default_rng(11)
    A = rng.integers(-64, 64, (24, 24)).astype(np.int8)
    B = rng.integers(-64, 64, (24, 24)).astype(np.int8)
    jprog = jgc.compile_matmul(A, B, alu_ops=[jgc.AluImmOp.relu()])
    tprog = tgc.compile_matmul(A, B, alu_ops=[tgc.AluImmOp.relu()])
    stack = varied_stack(jprog, rng, 3)
    jout, jrep = jfs.run_batch(jprog.config, stack, jprog.instructions,
                               plan=jfs.plan_for(jprog))
    tout, trep = tfs.run_batch(tprog.config, stack, tprog.instructions,
                               plan=tfs.plan_for(tprog), device="cpu")
    assert isinstance(tout, torch.Tensor) and tout.device.type == "cpu"
    np.testing.assert_array_equal(tout.numpy(), jout)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert isinstance(tsim.make_simulator(tprog.config, tprog.dram_image(),
                                          backend="fast", device="cpu"),
                      tfs.FastSimulator)
    assert isinstance(tsim.make_simulator(tprog.config, stack,
                                          backend="batched", device="cpu"),
                      tfs.BatchFastSimulator)
    for backend in ("fast", "batched"):
        out, rep = tsim.run_program(tprog, backend=backend, device="cpu")
        jo, jr = jsim.run_program(jprog, backend=backend)
        np.testing.assert_array_equal(out, jo)
        assert rep.gemm_loops == jr.gemm_loops
        tsim.verify_program(tprog, backend=backend, device="cpu")
    outs, rep = tsim.run_program_batch(tprog, dram_stack=stack,
                                       backend="batched", device="cpu")
    jouts, jr = jsim.run_program_batch(jprog, dram_stack=stack)
    np.testing.assert_array_equal(outs, jouts)
    assert rep.gemm_loops == jr.gemm_loops


def test_batched_rejects_bad_stacks():
    cfg = thw.vta_default()
    with pytest.raises(ValueError):
        tfs.BatchFastSimulator(cfg, np.zeros(64, dtype=np.uint8),
                               device="cpu")
    with pytest.raises(TypeError):
        tfs.BatchFastSimulator(cfg, np.zeros((2, 64), dtype=np.int8),
                               device="cpu")
    with pytest.raises(TypeError):
        tfs.FastSimulator(cfg, torch.zeros(64, dtype=torch.int8),
                          device="cpu")
    with pytest.raises(ValueError, match="plan does not match"):
        sim = tfs.FastSimulator(cfg, np.zeros(64, np.uint8), device="cpu")
        sim.run([tisa.FinishInsn()], plan=tfs.compile_plan(cfg, []))


def test_copy_dram_false_runs_in_place():
    """The serve loop hands its device stack over without a copy."""
    rng = np.random.default_rng(12)
    A = rng.integers(-64, 64, (20, 20)).astype(np.int8)
    B = rng.integers(-64, 64, (20, 20)).astype(np.int8)
    prog = tgc.compile_matmul(A, B)
    stack = torch.from_numpy(varied_stack(prog, rng, 2))
    before = stack.clone()
    sim = tfs.BatchFastSimulator(prog.config, stack, copy_dram=False,
                                 device="cpu")
    assert sim.dram is stack
    sim.run(prog.instructions)
    assert not torch.equal(stack, before)
    copied = tfs.BatchFastSimulator(prog.config, before, device="cpu")
    assert copied.dram is not before


def test_interpreters_launch_no_gemm_kernel(monkeypatch):
    """The interpreters run torch operations only: neither ``vta_gemm``
    nor its plain version is called by an interpreter serve."""
    from repro_torch.lenet5_e2e import compile_lenet5, request_images
    from repro_torch.kernels import ops as tops
    _, net = compile_lenet5()
    images = request_images(3)
    calls = []
    real = tref.vta_gemm_ref
    monkeypatch.setattr(tref, "vta_gemm_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    before = tops.launches
    want, _ = net.serve(images, device="cpu")
    assert len(calls) == 5
    calls.clear()
    got, _ = net.serve(images, backend="batched", device="cpu")
    one = net.serve_one(images[0], backend="fast", device="cpu")
    assert calls == [] and tops.launches == before
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(one, want[0])


def test_sync_counter_counts_host_reads():
    """A batched serve reads the device back once per UOP load and once
    per WGT load (its uniformity flag) and nowhere else on LeNet-5."""
    from repro_torch.lenet5_e2e import compile_lenet5, request_images
    _, net = compile_lenet5()
    images = request_images(4)
    loads = {mem: sum(1 for layer in net.layers
                      for i in layer.program.instructions
                      if isinstance(i, tisa.MemInsn)
                      and i.opcode == tisa.Opcode.LOAD
                      and i.memory_type == mem)
             for mem in (tisa.MemId.UOP, tisa.MemId.WGT)}
    tfs.reset_syncs()
    net.serve(images, backend="batched", device="cpu")
    assert tfs.syncs == loads[tisa.MemId.UOP] + loads[tisa.MemId.WGT]
    tfs.reset_syncs()
    net.serve_one(images[0], backend="fast", device="cpu")
    assert tfs.syncs == loads[tisa.MemId.UOP]      # no flag on one image


def test_strict_float32_scopes_overlapping_across_threads():
    """Interpreters in several serving threads open overlapping
    ``strict_float32`` scopes: every scope sees the strict flags for its
    whole life, and the flags found before the first return after the
    last (one thread restoring while another still runs would break
    both)."""
    import sys
    import threading

    from repro_torch.device import strict_float32
    b = torch.backends
    flags = lambda: (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
                     b.cudnn.benchmark, b.cudnn.deterministic)
    before = flags()
    bad, barrier = [], threading.Barrier(8)

    def worker():
        barrier.wait(timeout=30)
        for _ in range(300):
            with strict_float32():
                if flags() != (False, False, False, True):
                    bad.append(flags())
                with strict_float32():
                    pass
                if flags() != (False, False, False, True):
                    bad.append(flags())

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and flags() == before
