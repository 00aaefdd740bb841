"""The ``vta_alu`` kernel's op table, on the CPU.

The table is the whole contract between the port and the TensorAlu
epilogue kernel, which runs only on a card.  Here it is read back in two
ways that do not use the port's lowering: decoded word by word into ALU
specs (which must be the program's, in the kernel's canonical form: an
indexed op's indices once each and sorted, a vectorised pair op's pairs
grouped by dst in program order), and run by a numpy model of the
kernel's steps (the ACC preload and the leading element-wise ops as an
element is loaded, the other ops over the image, the trailing ones and
the commit as it is stored), which must equal the plain torch epilogue.
Both over every case of ``torch_alu_cases`` and every unfused layer of
resnet8 and LeNet-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.gemm_compiler as tgc                     # noqa: E402
import repro_torch.core.isa as tisa                              # noqa: E402
from repro_torch.core import cuda_backend as cb                  # noqa: E402
from repro_torch.core.errors import CompileError                 # noqa: E402
from repro_torch.kernels import vta_alu                          # noqa: E402
from torch_alu_cases import alu_cases, alu_ops                   # noqa: E402

CPU = torch.device("cpu")
CASES = alu_cases()
AluOp = tisa.AluOp


def decode(t: vta_alu.AluTable) -> list:
    """The table's words back to ALU specs."""
    w = [int(x) for x in t.words.tolist()]
    specs = []
    for i in range(t.n_ops):
        kind, op, imm, off, count, off2, off3, _ = w[i * vta_alu.ROW:
                                                    (i + 1) * vta_alu.ROW]
        kind, op = vta_alu.KINDS[kind], AluOp(op)
        if kind == "imm":
            specs.append(tgc.AluImmOp(op, imm))
        elif kind == "res":
            specs.append(tgc.AluResidualOp(op, pre_shift=imm))
        elif kind == "indexed":
            specs.append(tgc.AluIndexedImmOp(op, imm,
                                             tuple(w[off:off + count])))
        elif kind == "pair":
            offsets = w[off2:off2 + count + 1]
            srcs = w[off3:off3 + offsets[-1]]
            specs.append(tgc.AluPairOp(op, tuple(
                (d, s) for k, d in enumerate(w[off:off + count])
                for s in srcs[offsets[k]:offsets[k + 1]])))
        else:
            flat = w[off:off + 2 * count]
            specs.append(tgc.AluPairOp(op, tuple(zip(flat[0::2],
                                                     flat[1::2]))))
    return specs


def canonical(ops) -> list:
    out = []
    for spec in ops:
        if isinstance(spec, tgc.AluIndexedImmOp):
            spec = tgc.AluIndexedImmOp(spec.op, spec.imm,
                                       tuple(sorted(set(spec.indices))))
        elif isinstance(spec, tgc.AluPairOp) and not cb._pair_arrays(
                spec.pairs, spec.op)[2]:
            spec = tgc.AluPairOp(spec.op, tuple(sorted(spec.pairs,
                                                       key=lambda p: p[0])))
        out.append(spec)
    return out


def _wrap(x):
    return ((x + 2 ** 31) & (2 ** 32 - 1)) - 2 ** 31


def _shr_imm(a, s):
    return a >> (63 if s < 0 or s > 63 else s)


def _vec_apply(op, a, b):
    return {AluOp.MIN: np.minimum, AluOp.MAX: np.maximum,
            AluOp.ADD: np.add}.get(op, lambda a, b: a >> (b & 31))(a, b)


def run_table(t: vta_alu.AluTable, vec, res, saturate: bool):
    """The kernel's steps over (B, n_vec, bs) int32 vectors, in numpy, from
    the table alone; the committed int8 vectors."""
    w = [int(x) for x in t.words.tolist()]
    x = vec.astype(np.int64)
    r64 = res.astype(np.int64)

    def elementwise(i):
        nonlocal x
        kind, op, imm = w[i * vta_alu.ROW:i * vta_alu.ROW + 3]
        op = AluOp(op)
        if vta_alu.KINDS[kind] == "imm":
            x = _wrap({AluOp.MIN: lambda a: np.minimum(a, imm),
                       AluOp.MAX: lambda a: np.maximum(a, imm),
                       AluOp.ADD: lambda a: a + imm}.get(
                op, lambda a: _shr_imm(a, imm))(x))
        else:
            r = _wrap(_shr_imm(r64, imm)) if imm else r64
            x = _wrap(_vec_apply(op, x, r))

    for i in range(t.lead):
        elementwise(i)
    for i in range(t.lead, t.tail):
        kind, op, imm, off, count, off2, off3, _ = w[i * vta_alu.ROW:
                                                    (i + 1) * vta_alu.ROW]
        kind, op = vta_alu.KINDS[kind], AluOp(op)
        if kind in vta_alu.ELEMENTWISE:
            elementwise(i)
        elif kind == "indexed":
            for v in w[off:off + count]:
                x[:, v] = _wrap(dict(
                    MIN=lambda a: np.minimum(a, imm),
                    MAX=lambda a: np.maximum(a, imm),
                    ADD=lambda a: a + imm,
                    SHR=lambda a: _shr_imm(a, imm))[op.name](x[:, v]))
        elif kind == "pair":
            offsets, before = w[off2:off2 + count + 1], x.copy()
            for k, d in enumerate(w[off:off + count]):
                acc = before[:, d]
                for s in w[off3 + offsets[k]:off3 + offsets[k + 1]]:
                    acc = _vec_apply(op, acc, before[:, s])
                x[:, d] = _wrap(acc)
        else:
            for q in range(count):
                d, s = w[off + 2 * q], w[off + 2 * q + 1]
                x[:, d] = _wrap(_vec_apply(op, x[:, d], x[:, s]))
    for i in range(t.tail, t.n_ops):
        elementwise(i)
    if saturate:
        x = np.clip(x, -128, 127)
    return (x & 0xFF).astype(np.uint8).view(np.int8)


def _plan(ops, alpha, beta, rh):
    """A ``CudaPlan`` of these blocks around ``ops`` (regions unused)."""
    return cb.CudaPlan(alpha=alpha, lam=1, beta=beta, row_height=rh,
                       block_size=16, valid_shape=(alpha * rh, beta * 16),
                       alu_ops=tuple(ops), fused=False, relu=False, shift=0,
                       inp=(0, 0), wgt=(0, 0), out=(0, 0), acc=(0, 0),
                       res=(0, 0))


def _check_against_plain(p, seed: int, batch: int = 3):
    """The numpy model over the table equals ``plain_alu_epilogue``, both
    commits, on full-range int32 result, ACC and RES."""
    n_vec = p.alpha * p.beta * p.row_height
    t = cb.lower_alu_table(p.alu_ops, n_vec, CPU)
    rng = np.random.default_rng(seed)
    mp, np_ = p.padded_shape
    full = lambda: rng.integers(-(2 ** 31), 2 ** 31, (batch, mp, np_),
                                dtype=np.int64).astype(np.int32)
    gemm, x, res = full(), full(), full()
    as_t = torch.from_numpy
    for saturate in (False, True):
        want = cb.plain_alu_epilogue(as_t(gemm), as_t(x), as_t(res), p,
                                     cb.lower_alu(p.alu_ops, CPU), saturate)
        vec = cb._to_vectors(cb._wrap32(as_t(gemm).long() + as_t(x).long()),
                             p).numpy()
        got = run_table(t, vec, cb._to_vectors(as_t(res), p).numpy(),
                        saturate)
        np.testing.assert_array_equal(
            got, cb._to_vectors(want, p).numpy(), err_msg=f"saturate "
            f"{saturate}")


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[name for name, _ in CASES])
def test_case_table_decodes_to_its_program(case):
    ops = alu_ops(tgc, tisa, CASES[case][1])
    t = cb.lower_alu_table(ops, 16, CPU)
    assert t.words.dtype == torch.int64 and t.words.device == CPU
    assert decode(t) == canonical(ops)
    kinds = [vta_alu.KINDS[int(k)] for k in t.words[:t.n_ops * vta_alu.ROW:
                                                    vta_alu.ROW]]
    assert t.streams == all(k in vta_alu.ELEMENTWISE for k in kinds)
    assert t.residual == ("res" in kinds)
    assert ("pair_seq" in kinds) == (CASES[case][0] == "pair_overlap")


@pytest.mark.parametrize("blocks", [(2, 1, 8), (3, 2, 3)],
                         ids=["16_vectors", "18_vectors"])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[name for name, _ in CASES])
def test_case_table_runs_as_the_plain_epilogue(case, blocks):
    p = _plan(alu_ops(tgc, tisa, CASES[case][1]), *blocks)
    _check_against_plain(p, 3100 + case)


@pytest.fixture(scope="module")
def layers():
    """(model, layer name, program) of every unfused layer of resnet8
    and LeNet-5."""
    from repro_torch.lenet5_e2e import compile_lenet5
    from repro_torch.models import resnet8 as t8
    out = []
    for model, net in (("resnet8", t8.compile_resnet8()[0]),
                       ("lenet5", compile_lenet5()[1])):
        out += [(model, l.spec.name, l.program) for l in net.layers
                if not cb.plan_cuda(l.program).fused]
    return out


# the unfused layers, and whether their program streams (element-wise only)
UNFUSED = {("resnet8", "b1b"): True, ("resnet8", "t2b"): True,
           ("resnet8", "t3b"): True, ("resnet8", "head"): False,
           ("lenet5", "l1_conv"): False, ("lenet5", "l2_conv"): False}


def test_layer_tables_decode_and_run_as_the_plain_epilogue(layers):
    assert {(m, name) for m, name, _ in layers} == set(UNFUSED)
    for model, name, prog in layers:
        p = cb.plan_cuda(prog)
        t = cb._alu_table(prog, p, CPU)
        assert decode(t) == canonical(p.alu_ops), (model, name)
        assert t.streams == UNFUSED[(model, name)], (model, name)
        assert t.residual == (p.res is not None), (model, name)
        _check_against_plain(p, 3200 + len(name), batch=2)


def test_table_is_lowered_once_per_program_and_device(layers, monkeypatch):
    calls = []
    real = cb.lower_alu_table

    def spy(alu_ops, n_vec, device):
        calls.append(str(device))
        return real(alu_ops, n_vec, device)

    monkeypatch.setattr(cb, "lower_alu_table", spy)
    _, _, prog = layers[0]
    prog.__dict__.pop("_cuda_alu_table", None)
    p = cb.plan_cuda(prog)
    first = cb._alu_table(prog, p, CPU)
    assert cb._alu_table(prog, p, torch.device("cpu")) is first
    meta = cb._alu_table(prog, p, torch.device("meta"))
    assert meta.words.device.type == "meta"
    assert cb._alu_table(prog, p, torch.device("meta")) is meta
    assert calls == ["cpu", "meta"]


def test_lowering_refuses_what_the_kernel_cannot_run():
    shr = tgc.AluIndexedImmOp(AluOp.SHR, 2, (0, 16))
    with pytest.raises(CompileError) as exc:
        cb.lower_alu_table([shr], 16, CPU)
    assert exc.value.constraint == "cuda-alu-index"
    pair = tgc.AluPairOp(AluOp.ADD, ((0, -1),))
    with pytest.raises(CompileError):
        cb.lower_alu_table([pair], 16, CPU)
    # a program that reads RES is refused at launch where the layer has no
    # RES region, before the operands are looked at
    res = cb.lower_alu_table([tgc.AluResidualOp(AluOp.ADD)], 16, CPU)
    with pytest.raises(ValueError, match="RES"):
        vta_alu.vta_alu(torch.zeros(256, dtype=torch.int32),
                        torch.zeros(1, 2048, dtype=torch.uint8), res,
                        blocks=(2, 1, 8, 16), acc=None, res=None,
                        out=(0, 256), saturate=False,
                        acc_image=torch.zeros(1, 2048, dtype=torch.uint8))


def test_launch_plan_follows_the_table():
    imm = cb.lower_alu_table([tgc.AluImmOp(AluOp.SHR, 3)], 256, CPU)
    pair = cb.lower_alu_table(
        [tgc.AluPairOp(AluOp.ADD, ((0, 1),))], 256, CPU)
    assert vta_alu.plan(imm, 8192, 1024, 16, True) == vta_alu.AluPlan(
        "stream", 4, 0, 8192 * 16)
    assert vta_alu.plan(imm, 3, 18, 16, False) == vta_alu.AluPlan(
        "stream", 1, 0, 3 * 2)
    assert vta_alu.plan(pair, 32768, 784, 16, True) == vta_alu.AluPlan(
        "shared", 4, 784 * 64, 32768)
    assert vta_alu.plan(pair, 4, 4096, 16, True) == vta_alu.AluPlan(
        "global", 4, 0, 4)
    with pytest.raises(ValueError, match="grid limit"):
        vta_alu.plan(imm, 2 ** 27, 1024, 16, True)
