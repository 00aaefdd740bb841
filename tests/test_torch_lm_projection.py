"""The port's functional simulator (the oracle) and the projection driver.

* the port's ``run_program`` against the reference's, on the GQA
  projection of ``examples/vta_lm_projection.py`` and on compiled GEMMs
  of the driver's ``MATMUL_CASES`` (a K that is not a multiple of 16, a
  multi-chunk program on a small SRAM profile): the same decoded outputs
  and every :class:`SimReport` field, the instruction trace and the
  overflow counters included;
* the port's ``cuda`` backend (its plain version on ``device="cpu"``)
  equals the oracle through ``run_program`` and ``run_program_batch``;
* the driver ``python -m repro_torch.vta_lm_projection --device cpu``, and
  each of ``MATMUL_CASES`` through ``run_matmul_case`` (truncating and
  saturating int8, int32 out).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.gemm_compiler as jgc                           # noqa: E402
import repro.core.hwconfig as jhw                                # noqa: E402
import repro.core.simulator as jsim                              # noqa: E402
import repro_torch.core.gemm_compiler as tgc                     # noqa: E402
import repro_torch.core.hwconfig as thw                          # noqa: E402
import repro_torch.core.simulator as tsim                        # noqa: E402
from repro_torch import vta_lm_projection as proj                # noqa: E402


def _programs(gc, hw):
    """The projection and two compiled GEMMs, by one package's compiler."""
    x, w, bias = proj.projection_operands()
    progs = {"kv_proj": gc.compile_matmul(
        x, w, bias=bias, alu_ops=[gc.AluImmOp.relu(),
                                  gc.AluImmOp.shr(proj.SHIFT)],
        name="kv_proj")}
    rng = np.random.default_rng(11)
    a = rng.integers(-128, 128, (40, 75), dtype=np.int64).astype(np.int8)
    b = rng.integers(-128, 128, (75, 24), dtype=np.int64).astype(np.int8)
    c = rng.integers(-5000, 5000, (24,), dtype=np.int64).astype(np.int32)
    progs["k75"] = gc.compile_matmul(
        a, b, bias=c, alu_ops=[gc.AluImmOp.relu(), gc.AluImmOp.shr(4)])
    cfg = hw.VTAConfig(inp_buff_vectors=64, wgt_buff_matrices=4,
                       acc_buff_vectors=64, out_buff_vectors=64,
                       uop_buff_entries=32)
    rng = np.random.default_rng(812)
    a = rng.integers(-64, 64, (50, 40)).astype(np.int8)
    b = rng.integers(-64, 64, (40, 33)).astype(np.int8)
    progs["multi_chunk"] = gc.compile_matmul(
        a, b, alu_ops=[gc.AluImmOp.relu(), gc.AluImmOp.shr(2)], cfg=cfg)
    return progs


PROGRAMS = ["kv_proj", "k75", "multi_chunk"]


@pytest.mark.parametrize("name", PROGRAMS)
def test_run_program_matches_reference(name):
    tprog = _programs(tgc, thw)[name]
    jprog = _programs(jgc, jhw)[name]
    tout, trep = tsim.run_program(tprog, trace=True, count_overflows=True)
    jout, jrep = jsim.run_program(jprog, trace=True, count_overflows=True)
    assert tout.dtype == jout.dtype == np.int8
    np.testing.assert_array_equal(tout, jout)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.dram_bytes_total == jrep.dram_bytes_total
    assert trep.gemm_loops > 0 and trep.insn_trace
    if name == "multi_chunk":
        assert tprog.chunk_plan.n_chunks > 1
    tsim.verify_program(tprog)


@pytest.mark.parametrize("name", PROGRAMS)
def test_cuda_backend_equals_oracle(name):
    prog = _programs(tgc, thw)[name]
    want, _ = tsim.run_program(prog)
    got, _ = tsim.run_program(prog, backend="cuda", device="cpu")
    np.testing.assert_array_equal(got, want)
    stack, _ = tsim.run_program_batch(prog, batch=3, device="cpu")
    assert stack.shape == (3, *want.shape)
    for row in stack:
        np.testing.assert_array_equal(row, want)


def test_backends_refused():
    prog = _programs(tgc, thw)["k75"]
    with pytest.raises(ValueError, match="unknown simulator backend"):
        tsim.run_program(prog, backend="fast")
    with pytest.raises(ValueError, match="run_program_batch supports"):
        tsim.run_program_batch(prog, batch=2, backend="batched")
    with pytest.raises(ValueError, match="pass either"):
        tsim.run_program_batch(prog, device="cpu")
    sim = tsim.make_simulator(prog.config, prog.dram_image(),
                              backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="program="):
        tsim.run_instructions(sim, prog.instructions)
    with pytest.raises(TypeError, match="uint8"):
        tsim.FunctionalSimulator(prog.config,
                                 prog.dram_image().astype(np.int8))


def test_projection_driver_on_cpu(capsys):
    assert proj.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "VTA path: 1536 GeMM loops" in out
    assert "(bit-exact)" in out
    res = proj.run_projection("cpu")
    jprog = _programs(jgc, jhw)["kv_proj"]
    want, _ = jsim.run_program(jprog)
    for key in ("oracle", "kernel", "plain"):
        np.testing.assert_array_equal(res[key], want)


@pytest.mark.parametrize("case", proj.MATMUL_CASES, ids=lambda c: c[0])
def test_matmul_cases_on_cpu(case):
    res = proj.run_matmul_case(case, "cpu")
    assert res["checks"] and all(res["checks"].values()), res["checks"]
    assert res["saturated"] > 0          # saturate and wrap differ here
    assert res["shape"] == case[1:4] and res["report"].gemm_loops > 0
