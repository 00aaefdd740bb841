"""The port's compiler copy against the reference compiler, byte for byte.

``repro_torch`` keeps its own copy of the numpy compiler modules instead
of importing ``repro``'s.  This file is what keeps the copy honest: the
same inputs compiled by both packages must give the same shifts, the
same encoded instruction and UOP bytes, the same data segments and
region placement and the same DRAM image.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.gemm_compiler as jgc                           # noqa: E402
import repro.core.hwconfig as jhw                                # noqa: E402
import repro.core.isa as jisa                                    # noqa: E402
import repro.core.network_compiler as jnc                        # noqa: E402
import repro.models.cifar_cnn as jcifar                          # noqa: E402
import repro.models.lenet as jlenet                              # noqa: E402
import repro.models.resnet8 as j8                                # noqa: E402
import repro.models.resnet_tiny as jtiny                         # noqa: E402
import repro_torch.core.gemm_compiler as tgc                     # noqa: E402
import repro_torch.core.hwconfig as thw                          # noqa: E402
import repro_torch.core.isa as tisa                              # noqa: E402
import repro_torch.core.network_compiler as tnc                  # noqa: E402
import repro_torch.models.cifar_cnn as tcifar                    # noqa: E402
import repro_torch.models.lenet as tlenet                        # noqa: E402
import repro_torch.models.resnet8 as t8                          # noqa: E402
import repro_torch.models.resnet_tiny as ttiny                   # noqa: E402


def _cal_images(n=8):
    rng = np.random.default_rng(7)
    return [rng.integers(0, 128, (1, 1, 32, 32)).astype(np.int8)
            for _ in range(n)]


def assert_programs_identical(tp, jp):
    """Every artefact a program carries, compared across the packages."""
    assert tisa.encode_stream(tp.instructions) == \
        jisa.encode_stream(jp.instructions), tp.name
    assert tisa.encode_uops(tp.uops) == jisa.encode_uops(jp.uops)
    assert tp.segments.keys() == jp.segments.keys()
    for key in jp.segments:
        assert tp.segments[key] == jp.segments[key], (tp.name, key)
    assert tp.segment_crcs == jp.segment_crcs
    assert {k: (r.phys_addr, r.nbytes) for k, r in tp.regions.items()} == \
        {k: (r.phys_addr, r.nbytes) for k, r in jp.regions.items()}
    assert dataclasses.asdict(tp.output_meta) == \
        dataclasses.asdict(jp.output_meta)
    assert repr(tp.alu_ops) == repr(jp.alu_ops)
    assert tp.schedule == jp.schedule
    assert tp.gemm_loops() == jp.gemm_loops()
    assert tp.alu_loops() == jp.alu_loops()
    np.testing.assert_array_equal(tp.expected_out, jp.expected_out)
    np.testing.assert_array_equal(tp.dram_image(), jp.dram_image())


def _compile_lenet(nc, lenet, schedule):
    weights = lenet.lenet5_random_weights(seed=0)
    shifts = lenet.calibrate_shifts(weights, _cal_images())
    net = nc.compile_network(lenet.lenet5_specs(weights, shifts),
                             np.zeros((1, 1, 32, 32), np.int8),
                             schedule=schedule)
    return shifts, net


@pytest.mark.parametrize("schedule", ["serialized", "pipelined"])
def test_lenet5_compiles_identically(schedule):
    t_shifts, tnet = _compile_lenet(tnc, tlenet, schedule)
    j_shifts, jnet = _compile_lenet(jnc, jlenet, schedule)
    assert t_shifts == j_shifts
    assert [l.requant_shift for l in tnet.layers] == \
        [l.requant_shift for l in jnet.layers]
    for tl, jl in zip(tnet.layers, jnet.layers):
        assert_programs_identical(tl.program, jl.program)
        assert tl.keep_rows == jl.keep_rows
        assert (tl.out_h, tl.out_w) == (jl.out_h, jl.out_w)
        np.testing.assert_array_equal(tl.input_matrix, jl.input_matrix)
        np.testing.assert_array_equal(tl.ref_output_matrix,
                                      jl.ref_output_matrix)
    np.testing.assert_array_equal(tnet.dram_image(), jnet.dram_image())
    assert tnet.gemm_loops() == jnet.gemm_loops()
    assert dataclasses.asdict(tnet.cycle_report()) == \
        dataclasses.asdict(jnet.cycle_report())
    if schedule == "serialized":
        assert tnet.gemm_loops() == 2942
        assert tnet.cycle_report().tensor_gemm_cycles == 2972


def test_calibration_traces_identical():
    specs_t = tlenet.lenet5_specs(tlenet.lenet5_random_weights(seed=3))
    specs_j = jlenet.lenet5_specs(jlenet.lenet5_random_weights(seed=3))
    cal = _cal_images(4)
    t_shifts, t_traces = tnc.calibrate_network(specs_t, cal, saturate=True)
    j_shifts, j_traces = jnc.calibrate_network(specs_j, cal, saturate=True)
    assert t_shifts == j_shifts
    for tt, jt in zip(t_traces, j_traces):
        for a, b in zip(tt, jt):
            np.testing.assert_array_equal(a, b)


def build_programs(gc, isa, hw):
    """The fused, general, multi-chunk and saturate programs of the
    reference's backend tests, compiled by one package's modules."""
    progs = {}
    rng = np.random.default_rng(810)
    A = rng.integers(-128, 128, (21, 34)).astype(np.int8)
    B = rng.integers(-128, 128, (34, 19)).astype(np.int8)
    X = np.broadcast_to(
        rng.integers(-1000, 1000, (1, 19)).astype(np.int32), (21, 19)).copy()
    progs["fused"] = gc.compile_matmul(
        A, B, X=X, alu_ops=[gc.AluImmOp.relu(), gc.AluImmOp.shr(4)])

    rng = np.random.default_rng(811)
    A = rng.integers(-128, 128, (16, 16)).astype(np.int8)
    B = rng.integers(-128, 128, (16, 16)).astype(np.int8)
    X = rng.integers(-(10 ** 6), 10 ** 6, (16, 16)).astype(np.int32)
    pairs = tuple((d, d + 8) for d in range(8))
    progs["general"] = gc.compile_matmul(
        A, B, X=X, alu_ops=[gc.AluImmOp.relu(),
                            gc.AluPairOp(isa.AluOp.ADD, pairs),
                            gc.AluIndexedImmOp(isa.AluOp.SHR, 3,
                                               tuple(range(8)))])

    cfg = hw.VTAConfig(inp_buff_vectors=64, wgt_buff_matrices=4,
                       acc_buff_vectors=64, out_buff_vectors=64,
                       uop_buff_entries=32)
    rng = np.random.default_rng(812)
    A = rng.integers(-64, 64, (50, 40)).astype(np.int8)
    B = rng.integers(-64, 64, (40, 33)).astype(np.int8)
    progs["multi_chunk"] = gc.compile_matmul(
        A, B, alu_ops=[gc.AluImmOp.relu(), gc.AluImmOp.shr(2)], cfg=cfg)

    rng = np.random.default_rng(813)
    A = rng.integers(-128, 128, (8, 128)).astype(np.int8)
    B = rng.integers(-128, 128, (128, 8)).astype(np.int8)
    progs["saturate"] = gc.compile_matmul(A, B, alu_ops=[gc.AluImmOp.shr(2)])
    return progs


PROGRAMS = ["fused", "general", "multi_chunk", "saturate"]


@pytest.mark.parametrize("name", PROGRAMS)
def test_backend_programs_compile_identically(name):
    tprog = build_programs(tgc, tisa, thw)[name]
    jprog = build_programs(jgc, jisa, jhw)[name]
    assert_programs_identical(tprog, jprog)
    if name == "multi_chunk":
        assert tprog.chunk_plan.n_chunks > 1
        assert tprog.chunk_plan.n_chunks == jprog.chunk_plan.n_chunks


def compile_cifar_reference():
    """The reference's CIFAR CNN as ``examples/cifar10_cnn_e2e.py`` builds
    it: ``(weights, shifts, net)``, the counterpart of the port's
    ``compile_cifar_cnn``."""
    w = jcifar.cifar_cnn_random_weights(seed=0)
    shifts = jcifar.calibrate_shifts(
        w, [jcifar.synthetic_cifar_image(s) for s in range(1, 9)])
    return w, shifts, jnc.compile_network(jcifar.cifar_cnn_specs(w, shifts),
                                          jcifar.synthetic_cifar_image(0))


CNNS = {
    "resnet8-serialized": (lambda: t8.compile_resnet8()[0],
                           lambda: j8.compile_resnet8()[0]),
    "resnet8-pipelined": (
        lambda: t8.compile_resnet8(schedule="pipelined")[0],
        lambda: j8.compile_resnet8(schedule="pipelined")[0]),
    "resnet_tiny": (lambda: ttiny.compile_resnet_tiny()[0],
                    lambda: jtiny.compile_resnet_tiny()[0]),
    "cifar_cnn": (lambda: tcifar.compile_cifar_cnn()[2],
                  lambda: compile_cifar_reference()[2]),
}


@pytest.mark.parametrize("name", sorted(CNNS))
def test_cnn_compiles_identically(name):
    """resnet8 (both schedules), resnet_tiny and the CIFAR CNN: every
    layer's program byte-identical, the same DAG schedule (input and
    residual sources), the same DRAM image."""
    tnet, jnet = CNNS[name][0](), CNNS[name][1]()
    assert (tnet.input_sources, tnet.residual_sources) == \
        (jnet.input_sources, jnet.residual_sources)
    assert len(tnet.layers) == len(jnet.layers)
    for tl, jl in zip(tnet.layers, jnet.layers):
        assert_programs_identical(tl.program, jl.program)
        assert tl.keep_rows == jl.keep_rows
        assert (tl.out_h, tl.out_w, tl.n_chunks) == \
            (jl.out_h, jl.out_w, jl.n_chunks)
        np.testing.assert_array_equal(tl.input_matrix, jl.input_matrix)
        np.testing.assert_array_equal(tl.ref_output_matrix,
                                      jl.ref_output_matrix)
        if jl.residual_matrix is None:
            assert tl.residual_matrix is None
        else:
            np.testing.assert_array_equal(tl.residual_matrix,
                                          jl.residual_matrix)
    np.testing.assert_array_equal(tnet.dram_image(), jnet.dram_image())
    assert tnet.gemm_loops_per_layer() == jnet.gemm_loops_per_layer()
    assert tnet.chunks_per_layer() == jnet.chunks_per_layer()
    assert dataclasses.asdict(tnet.cycle_report()) == \
        dataclasses.asdict(jnet.cycle_report())
    if name.startswith("resnet8"):
        assert len(tnet.layers) == 11
        assert sum(s is not None for s in tnet.residual_sources) == 3


def test_cifar_shifts_identical():
    assert tcifar.compile_cifar_cnn()[1] == compile_cifar_reference()[1]
