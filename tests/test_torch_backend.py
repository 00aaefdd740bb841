"""The port's CUDA backend against the reference's backends, on the CPU.

``plan_cuda`` must lower a program exactly as the reference's
``plan_pallas`` does, and the DRAM the port's backend leaves behind
(device ``cpu``: the kernel's plain version) must equal byte for byte
what the reference's oracle interpreter leaves behind on the same
program.  The TensorAlu epilogue is also held op for op against the
reference's numpy epilogue, including the sequential fallback for
overlapping pair lattices.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.gemm_compiler as jgc                           # noqa: E402
import repro.core.hwconfig as jhw                                # noqa: E402
import repro.core.isa as jisa                                    # noqa: E402
import repro.core.pallas_backend as jpb                          # noqa: E402
import repro.core.simulator as jsim                              # noqa: E402
import repro_torch.core.cuda_backend as tcb                      # noqa: E402
import repro_torch.core.gemm_compiler as tgc                     # noqa: E402
import repro_torch.core.hwconfig as thw                          # noqa: E402
import repro_torch.core.isa as tisa                              # noqa: E402
from repro_torch.core import staging                             # noqa: E402
from repro_torch.core.dram import DramAllocator                  # noqa: E402
from repro_torch.core.errors import CompileError                 # noqa: E402
from repro_torch.core.program import VTAProgram                  # noqa: E402
from repro_torch.kernels import ops as tops                      # noqa: E402
from test_torch_compiler import PROGRAMS, build_programs         # noqa: E402
from torch_alu_cases import alu_cases as _alu_cases              # noqa: E402
from torch_alu_cases import alu_ops as _alu_ops                  # noqa: E402


@pytest.fixture(scope="module")
def programs():
    return (build_programs(tgc, tisa, thw), build_programs(jgc, jisa, jhw))


def _oracle_dram(prog):
    sim = jsim.make_simulator(prog.config, prog.dram_image(),
                              backend="oracle")
    jsim.run_instructions(sim, prog.instructions, program=prog)
    return sim.dram


@pytest.mark.parametrize("name", PROGRAMS)
def test_plan_matches_plan_pallas(programs, name):
    tplan = tcb.plan_cuda(programs[0][name])
    jplan = jpb.plan_pallas(programs[1][name])
    t_fields = [f.name for f in dataclasses.fields(tplan)]
    assert t_fields == [f.name for f in dataclasses.fields(jplan)]
    for field in t_fields:
        tv, jv = getattr(tplan, field), getattr(jplan, field)
        if field == "alu_ops":
            assert repr(tv) == repr(jv)
        else:
            assert tv == jv, field
    assert tplan.padded_shape == jplan.padded_shape
    assert tcb.plan_cuda(programs[0][name]) is tplan       # cached
    assert tplan.fused == (name != "general")


@pytest.mark.parametrize("name", PROGRAMS)
def test_dram_matches_oracle(programs, name):
    tprog, jprog = programs[0][name], programs[1][name]
    sim = tcb.CudaSimulator(tprog.config, tprog.dram_image(), device="cpu")
    before = tops.launches
    report = sim.run_program(tprog)
    assert tops.launches == before          # CPU tensors: the plain version
    np.testing.assert_array_equal(sim.dram.numpy(), _oracle_dram(jprog))
    assert report.gemm_loops == tprog.gemm_loops()
    out, _ = tcb.run_program_cuda(tprog, device="cpu")
    m, n = tprog.output_meta.valid_shape
    np.testing.assert_array_equal(out, jprog.expected_out[:m, :n])


def test_saturate_upgrade_clips_requant_acc(programs):
    """``saturate=True`` == clip of the requant ACC, and differs from
    truncation on this overflowing program."""
    tprog = programs[0]["saturate"]
    rng = np.random.default_rng(813)
    a = rng.integers(-128, 128, (8, 128)).astype(np.int8)
    b = rng.integers(-128, 128, (128, 8)).astype(np.int8)
    acc = jgc._wrap_int32(a.astype(np.int64) @ b.astype(np.int64))
    acc = jgc._wrap_int32(acc.astype(np.int64) >> 2)
    out_sat, _ = tcb.run_program_cuda(tprog, device="cpu", saturate=True)
    np.testing.assert_array_equal(out_sat, np.clip(acc, -128, 127))
    out_trunc, _ = tcb.run_program_cuda(tprog, device="cpu")
    np.testing.assert_array_equal(out_trunc, acc.astype(np.uint8).view(
        np.int8))
    assert not np.array_equal(out_sat, out_trunc)


@pytest.mark.parametrize("vary", ["inp", "wgt"])
def test_batch_stack_matches_batched_simulator(vary):
    """Per-row INP variation (one stacked launch) and per-row WGT
    variation (the per-row fallback) both match the reference's batched
    interpreter row for row."""
    rng = np.random.default_rng(814)
    A = rng.integers(-64, 64, (24, 20)).astype(np.int8)
    B = rng.integers(-64, 64, (20, 17)).astype(np.int8)
    progs = [gc.compile_matmul(A, B, alu_ops=[gc.AluImmOp.relu(),
                                              gc.AluImmOp.shr(1)])
             for gc in (tgc, jgc)]
    base = progs[1].dram_image()
    stack = np.broadcast_to(base, (4, base.size)).copy()
    region = progs[1].regions[vary]
    start = region.phys_addr - progs[1].allocator.offset
    for r in range(1, 4):
        stack[r, start:start + region.nbytes] = rng.integers(
            0, 256, region.nbytes, dtype=np.uint8)
    want, _ = jsim.run_program_batch(progs[1], dram_stack=stack.copy())
    sim = tcb.BatchCudaSimulator(progs[0].config, stack.copy(), device="cpu")
    report = sim.run_program(progs[0])
    got = staging.decode_out_region_batch(progs[0], sim.dram).numpy()
    np.testing.assert_array_equal(got, want)
    assert report.gemm_loops == 4 * progs[0].gemm_loops()


@pytest.mark.parametrize("case", range(len(_alu_cases())),
                         ids=[name for name, _ in _alu_cases()])
def test_alu_epilogue_matches_reference(case):
    _, ops = _alu_cases()[case]
    rng = np.random.default_rng(900 + case)
    vec = rng.integers(-(2 ** 31), 2 ** 31, (3, 16, 16)).astype(np.int32)
    res = rng.integers(-(2 ** 31), 2 ** 31, (3, 16, 16)).astype(np.int32)
    want = jpb.apply_alu_epilogue(vec, _alu_ops(jgc, jisa, ops), res)
    t_ops = _alu_ops(tgc, tisa, ops)
    got = tcb.apply_alu_epilogue(torch.from_numpy(vec), t_ops,
                                 torch.from_numpy(res),
                                 tcb.lower_alu(t_ops, torch.device("cpu")))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_refusals():
    cfg = thw.vta_default()
    rng = np.random.default_rng(816)
    A = rng.integers(-8, 8, (4, 4)).astype(np.int8)
    prog = tgc.compile_matmul(A, A, cfg=cfg)
    image = prog.dram_image()
    with pytest.raises(ValueError, match="trace"):
        tcb.CudaSimulator(cfg, image, device="cpu", trace=True)
    with pytest.raises(ValueError, match="trace"):
        tcb.CudaSimulator(cfg, image, device="cpu", count_overflows=True)
    sim = tcb.CudaSimulator(cfg, image, device="cpu")
    with pytest.raises(ValueError, match="fault_hook"):
        sim.run_program(prog, fault_hook=lambda s, i: None)
    bsim = tcb.BatchCudaSimulator(cfg, np.stack([image, image]),
                                  device="cpu")
    assert bsim.is_batch and not sim.is_batch
    with pytest.raises(ValueError, match="fault_hook"):
        bsim.run_program(prog, fault_hook=lambda s, i: None)
    bare = VTAProgram(config=cfg, allocator=DramAllocator())
    with pytest.raises(CompileError) as exc:
        sim.run_program(bare)
    assert exc.value.constraint == "cuda-program-metadata"
    with pytest.raises(CompileError) as exc:
        sim.run([tisa.FinishInsn()])
    assert exc.value.constraint == "cuda-program-metadata"
