"""Corrupted instructions on the port: rejected or flagged, never served.

The reference's ``tests/test_harden_negative.py`` cases, run on both
packages with the same mutation of the same compiled program:

* every field and every dependency flag of every instruction kind, flipped
  on a live instruction, is rejected by the port's validator with the
  reference's ``constraint``;
* the structural validator rejections carry the reference's constraints;
* out-of-bounds executions raise on the port's ``oracle``, ``fast`` and
  ``batched`` interpreters (``device="cpu"``) the reference's typed error,
  message for message, before any state mutates — on a card the host-side
  check is what keeps an out-of-range gather from reaching the device.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.fast_simulator as jfs                          # noqa: E402
import repro.core.gemm_compiler as jgc                           # noqa: E402
import repro.core.isa as jisa                                    # noqa: E402
import repro.core.simulator as jsim                              # noqa: E402
import repro.harden.guards as jguards                            # noqa: E402
import repro_torch.core.fast_simulator as tfs                    # noqa: E402
import repro_torch.core.gemm_compiler as tgc                     # noqa: E402
import repro_torch.core.isa as tisa                              # noqa: E402
import repro_torch.core.simulator as tsim                        # noqa: E402
import repro_torch.harden.guards as tguards                      # noqa: E402
from repro_torch.core.errors import CompileError                 # noqa: E402

PORT = types.SimpleNamespace(gc=tgc, isa=tisa, fs=tfs, sim=tsim,
                             guards=tguards)
REF = types.SimpleNamespace(gc=jgc, isa=jisa, fs=jfs, sim=jsim,
                            guards=jguards)

MEM_FIELDS = [("sram_base", 2 ** 16 - 1), ("dram_base", 2 ** 32 - 1),
              ("y_size", 2 ** 16 - 1), ("x_size", 2 ** 16 - 1),
              ("x_stride", 2 ** 16 - 1), ("y_pad_0", 15), ("y_pad_1", 15),
              ("x_pad_0", 15), ("x_pad_1", 15)]
GEM_FIELDS = [("reset", 1), ("uop_bgn", 2 ** 13 - 1),
              ("uop_end", 2 ** 14 - 1), ("iter_out", 2 ** 14 - 1),
              ("iter_in", 2 ** 14 - 1), ("acc_factor_out", 2 ** 11 - 1),
              ("acc_factor_in", 2 ** 11 - 1), ("inp_factor_out", 2 ** 11 - 1),
              ("inp_factor_in", 2 ** 11 - 1), ("wgt_factor_out", 2 ** 10 - 1),
              ("wgt_factor_in", 2 ** 10 - 1)]
ALU_FIELDS = [("reset", 1), ("uop_bgn", 2 ** 13 - 1),
              ("uop_end", 2 ** 14 - 1), ("iter_out", 2 ** 14 - 1),
              ("iter_in", 2 ** 14 - 1), ("dst_factor_out", 2 ** 11 - 1),
              ("dst_factor_in", 2 ** 11 - 1), ("src_factor_out", 2 ** 11 - 1),
              ("src_factor_in", 2 ** 11 - 1), ("alu_opcode", 3),
              ("use_imm", 1), ("imm", 2 ** 15 - 1)]
DEP_FIELDS = ["pop_prev", "pop_next", "push_prev", "push_next"]
KIND_FIELDS = {"load": MEM_FIELDS, "store": MEM_FIELDS, "gemm": GEM_FIELDS,
               "alu": ALU_FIELDS, "finish": []}
MEM_KIND = {"UOP": "uop", "INP": "inp", "WGT": "wgt", "ACC": "acc",
            "OUT": "out"}


def _program(pkg):
    rng = np.random.default_rng(5)
    A = rng.integers(-128, 128, (12, 24)).astype(np.int8)
    B = rng.integers(-128, 128, (24, 12)).astype(np.int8)
    return pkg.gc.compile_matmul(A, B, alu_ops=[pkg.gc.AluImmOp.relu()])


def _find(pkg, prog, kind):
    isa = pkg.isa
    for insn in prog.instructions:
        if kind == "load" and isinstance(insn, isa.MemInsn) \
                and insn.opcode == isa.Opcode.LOAD:
            return insn
        if kind == "store" and isinstance(insn, isa.MemInsn) \
                and insn.opcode == isa.Opcode.STORE:
            return insn
        if kind == "gemm" and isinstance(insn, isa.GemInsn):
            return insn
        if kind == "alu" and isinstance(insn, isa.AluInsn):
            return insn
        if kind == "finish" and isinstance(insn, isa.FinishInsn):
            return insn
    raise AssertionError(f"no {kind} instruction in program")


def _constraint(pkg, prog):
    try:
        pkg.guards.validate_program(prog)
    except (CompileError, jguards.CompileError) as exc:
        return exc.constraint
    return None


def both_constraints(mutate, resync=False):
    """Apply ``mutate(pkg, prog)`` to a fresh program of each package and
    return the constraints their validators reject it with."""
    out = []
    for pkg in (REF, PORT):
        prog = _program(pkg)
        mutate(pkg, prog)
        if resync:       # the round-trip passes: the structural checks fire
            prog.segments["insn"] = pkg.isa.encode_stream(prog.instructions)
            prog._harden_validated_segs = None
        out.append(_constraint(pkg, prog))
    return out


# ---------------------------------------------------------------------------
# Field flips: every field of every instruction kind
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
def test_every_field_flip_is_rejected(kind):
    for field, fmax in KIND_FIELDS[kind]:
        def flip(pkg, prog):
            insn = _find(pkg, prog, kind)
            old = getattr(insn, field)
            setattr(insn, field, old + 1 if old < fmax else old - 1)
        want, got = both_constraints(flip)
        assert got == want == "insn-roundtrip", (kind, field)


@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("dep", DEP_FIELDS)
def test_every_dep_flag_flip_is_rejected(kind, dep):
    def flip(pkg, prog):
        insn = _find(pkg, prog, kind)
        setattr(insn.dep, dep, 1 - getattr(insn.dep, dep))
    want, got = both_constraints(flip)
    assert got == want == "insn-roundtrip", (kind, dep)


def test_corrupted_stream_never_serves_wrong_output():
    """After a field flip a guarded serve returns the golden output
    (recovered): the flagged stream never executes."""
    from repro_torch.core.network_compiler import compile_network
    from repro_torch.harden import GuardPolicy
    from repro_torch.models.lenet import (lenet5_random_weights,
                                          lenet5_specs, synthetic_digit)
    net = compile_network(lenet5_specs(lenet5_random_weights(0)),
                          synthetic_digit(0))
    img = synthetic_digit(3)
    golden = net.serve_one(img, device="cpu")
    for field in ("x_size", "sram_base", "dram_base"):
        for backend in ("fast", "oracle"):
            insn = _find(PORT, net.layers[1].program, "load")
            setattr(insn, field, getattr(insn, field) + 1)
            tfs.invalidate_plan(net.layers[1].program)
            out, rep = net.serve_one(img, guard=GuardPolicy(),
                                     backend=backend, device="cpu")
            assert rep.outcome == "recovered" and rep.validation_errors
            np.testing.assert_array_equal(out, golden)


# ---------------------------------------------------------------------------
# Structural validator rejections (stable constraint ids)
# ---------------------------------------------------------------------------

def _cap(pkg, prog, insn):
    return prog.config.buffer_capacity(MEM_KIND[insn.memory_type.name])


STRUCTURAL = {
    "finish-missing": lambda pkg, prog: setattr(
        prog, "instructions", prog.instructions[:-1]),
    "store-memtype": lambda pkg, prog: setattr(
        _find(pkg, prog, "store"), "memory_type", pkg.isa.MemId.UOP),
    "load-sram-bounds": lambda pkg, prog: setattr(
        _find(pkg, prog, "load"), "sram_base",
        _cap(pkg, prog, _find(pkg, prog, "load")) - 1),
    "load-dram-bounds": lambda pkg, prog: setattr(
        _find(pkg, prog, "load"), "dram_base", 2 ** 31),
    "region-straying": lambda pkg, prog: setattr(
        _find(pkg, prog, "load"), "dram_base",
        _find(pkg, prog, "load").dram_base + 2),
    "lattice-footprint": lambda pkg, prog: (
        setattr(_find(pkg, prog, "gemm"), "iter_out", 2 ** 14 - 1),
        setattr(_find(pkg, prog, "gemm"), "iter_in", 2 ** 14 - 1)),
    "uop-range": lambda pkg, prog: setattr(
        _find(pkg, prog, "gemm"), "uop_end",
        prog.config.uop_buff_entries + 7),
    "gemm-acc-bounds": lambda pkg, prog: (
        setattr(_find(pkg, prog, "gemm"), "acc_factor_out", 2 ** 11 - 1),
        setattr(_find(pkg, prog, "gemm"), "iter_out",
                max(_find(pkg, prog, "gemm").iter_out, 8))),
    "dep-token-hazard": lambda pkg, prog: setattr(
        prog.instructions[0].dep, "pop_prev", 1),
}


@pytest.mark.parametrize("case", sorted(STRUCTURAL))
def test_validator_structural_rejections(case):
    want, got = both_constraints(STRUCTURAL[case], resync=True)
    assert got == want
    if case == "region-straying":
        assert got in ("load-region-containment", "load-dram-bounds")
    else:
        assert got == case


def test_validator_accepts_the_clean_program():
    assert both_constraints(lambda pkg, prog: None) == [None, None]


# ---------------------------------------------------------------------------
# Typed pre-mutation out-of-bounds errors on every interpreter
# ---------------------------------------------------------------------------

def _sims(pkg, prog):
    image = prog.dram_image()
    kw = {} if pkg is REF else {"device": "cpu"}
    yield "oracle", pkg.sim.FunctionalSimulator(prog.config, image.copy())
    yield "fast", pkg.fs.FastSimulator(prog.config, image.copy(), **kw)
    yield "batched", pkg.fs.BatchFastSimulator(
        prog.config, np.stack([image, image.copy()]), **kw)


def _state(sim):
    return [np.array(getattr(sim, name).cpu() if isinstance(
        getattr(sim, name), torch.Tensor) else getattr(sim, name))
            for name in ("dram", "acc_buf", "inp_buf", "wgt_buf", "out_buf")]


def assert_raises_everywhere(mutate, exc_types):
    """The mutated program raises on every interpreter of both packages:
    the port raises the reference's error type with its message, and its
    DRAM and data SRAMs hold what the reference's hold after the raise —
    the instructions before the faulty one ran, the faulty one changed
    nothing."""
    results = {}
    for pkg in (REF, PORT):
        for name, sim in _sims(pkg, _program(pkg)):
            prog = _program(pkg)
            mutate(pkg, prog)
            pkg.fs.invalidate_plan(prog)
            with pytest.raises(exc_types(pkg)) as exc:
                sim.run(prog.instructions)
            results[(pkg is PORT, name)] = (type(exc.value).__name__,
                                            str(exc.value), _state(sim))
    for name in ("oracle", "fast", "batched"):
        got, want = results[(True, name)], results[(False, name)]
        assert got[:2] == want[:2], name
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b, err_msg=name)


def _pad_past_end(pkg, prog):
    load = _find(pkg, prog, "load")
    load.sram_base = _cap(pkg, prog, load) - 1
    load.y_pad_1 = 4


def test_load_pad_past_sram_end_raises_everywhere():
    assert_raises_everywhere(_pad_past_end, lambda pkg: pkg.sim.VTABoundsError)


def test_load_dram_overrun_raises_typed_everywhere():
    assert_raises_everywhere(
        lambda pkg, prog: setattr(_find(pkg, prog, "load"), "dram_base",
                                  2 ** 28),
        lambda pkg: pkg.sim.VTABoundsError)


def test_gemm_lattice_overrun_raises_pre_mutation():
    def mutate(pkg, prog):
        gem = _find(pkg, prog, "gemm")
        gem.acc_factor_out = 2 ** 11 - 1
        gem.iter_out = max(gem.iter_out, 8)
    assert_raises_everywhere(mutate, lambda pkg: (pkg.sim.VTABoundsError,
                                                  pkg.sim.VTAHazardError))


def test_alu_lattice_overrun_raises_everywhere():
    def mutate(pkg, prog):
        alu = _find(pkg, prog, "alu")
        alu.dst_factor_out = 2 ** 11 - 1
        alu.iter_out = max(alu.iter_out, 8)
    assert_raises_everywhere(mutate, lambda pkg: pkg.sim.VTABoundsError)


def test_store_uop_rejected_everywhere():
    assert_raises_everywhere(
        lambda pkg, prog: setattr(_find(pkg, prog, "store"), "memory_type",
                                  pkg.isa.MemId.UOP),
        lambda pkg: ValueError)


def test_uop_range_overrun_raises_everywhere():
    assert_raises_everywhere(
        lambda pkg, prog: setattr(_find(pkg, prog, "gemm"), "uop_end",
                                  2 ** 14 - 1),
        lambda pkg: (pkg.sim.VTABoundsError, pkg.sim.VTAHazardError))


def test_load_out_is_refused_everywhere():
    """A LOAD into the OUT scratchpad decodes nowhere: the reference's
    interpreters raise ``ValueError('out')``, and so do the port's."""
    assert_raises_everywhere(
        lambda pkg, prog: setattr(_find(pkg, prog, "load"), "memory_type",
                                  pkg.isa.MemId.OUT),
        lambda pkg: (ValueError, IndexError, pkg.sim.VTAHazardError))
