"""resnet8, resnet_tiny and the CIFAR CNN served by the port on the CPU.

Each model is compiled at full width by both packages (random seeded
weights, calibrated shifts).  On ``device="cpu"`` the port runs
``vta_gemm``'s plain version, so these tests hold everything around the
kernel: the DAG schedule, residual staging, the TensorAlu epilogue (pair
lattices, the residual ADD) and the fused-path decision cached per
program.  The kernel itself is held on the card by ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.layout as jlayout                              # noqa: E402
import repro.core.network_compiler as jnc                        # noqa: E402
import repro.models.cifar_cnn as jcifar                          # noqa: E402
import repro.models.resnet8 as j8                                # noqa: E402
import repro.models.resnet_tiny as jtiny                         # noqa: E402
import repro_torch.core.network_compiler as tnc                  # noqa: E402
import repro_torch.models.cifar_cnn as tcifar                    # noqa: E402
import repro_torch.models.resnet8 as t8                          # noqa: E402
import repro_torch.models.resnet_tiny as ttiny                   # noqa: E402
from repro_torch.core import cuda_backend, staging               # noqa: E402
from repro_torch.core.errors import CompileError                 # noqa: E402
from repro_torch.models.weights import WeightsError              # noqa: E402
from test_torch_compiler import compile_cifar_reference          # noqa: E402
from torch_stage_helpers import batch_matrix_to_binary          # noqa: E402

MODELS = ["resnet8", "resnet_tiny", "cifar_cnn"]


@pytest.fixture(scope="module")
def nets():
    """model -> (port net, reference net, port reference(img), reference
    reference(img), image(seed), port weights, reference weights)."""
    out = {}
    tn, tg = t8.compile_resnet8()
    jn, jg = j8.compile_resnet8()
    out["resnet8"] = (tn, jn, lambda i, g=tg: t8.reference_forward_int8(g, i),
                      lambda i, g=jg: j8.reference_forward_int8(g, i),
                      t8.synthetic_image, t8.resnet8_random_weights(),
                      j8.resnet8_random_weights())
    tn, tg = ttiny.compile_resnet_tiny()
    jn, jg = jtiny.compile_resnet_tiny()
    out["resnet_tiny"] = (
        tn, jn, lambda i, g=tg: ttiny.reference_forward_int8(g, i),
        lambda i, g=jg: jtiny.reference_forward_int8(g, i),
        ttiny.synthetic_image, ttiny.resnet_tiny_random_weights(),
        jtiny.resnet_tiny_random_weights())
    tw, ts, tn = tcifar.compile_cifar_cnn()
    jw, js, jn = compile_cifar_reference()
    assert ts == js
    out["cifar_cnn"] = (
        tn, jn, lambda i: tcifar.reference_forward_int8(tw, i, ts)[0],
        lambda i: jcifar.reference_forward_int8(jw, i, js)[0],
        tcifar.synthetic_cifar_image, tw, jw)
    return out


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("model", MODELS)
def test_serve_matches_reference(nets, model, batch):
    """Served logits bit-identical to the reference's batched serve and to
    both packages' integer references, N/N."""
    tn, jn, tref, jref, image, _, _ = nets[model]
    images = np.stack([image(200 + batch + r) for r in range(batch)])
    got, reports = tn.serve(images, device="cpu")
    want, _ = jn.serve(images, backend="batched")
    assert got.dtype == np.int8 and got.shape == (batch, 1, 10)
    np.testing.assert_array_equal(got, want)
    for img, row in zip(images, got):
        np.testing.assert_array_equal(row, tref(img))
        np.testing.assert_array_equal(row, jref(img))
    assert len(reports) == len(tn.layers)
    assert [r.gemm_loops for r in reports] == \
        [batch * g for g in tn.gemm_loops_per_layer()]


@pytest.mark.parametrize("model", MODELS)
def test_schedule_and_run_functional(nets, model):
    """The port's schedule is the reference's; the compile-time input runs
    through with every staged input and residual checked against the
    compiled matrices."""
    tn, jn, tref, _, _, _, _ = nets[model]
    assert (tn.input_sources, tn.residual_sources) == \
        (jn.input_sources, jn.residual_sources)
    assert tn._sources() == jn._sources()
    assert tn._res_sources() == jn._res_sources()
    assert tn.chunks_per_layer() == jn.chunks_per_layer()
    assert tn.gemm_loops_per_layer() == jn.gemm_loops_per_layer()
    out, _ = tn.run_functional(device="cpu")
    want, _ = jn.run_functional(backend="fast")
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, tref(tn.input_tensor))


def test_multi_chunk_layers_are_served():
    """resnet8's multi-chunk layers (reference compile at seed 0) and the
    CIFAR CNN's: b1a/b1b 5 chunks, t2b 3, t2a and t3b 2; c1 3, c2 8."""
    net, _ = t8.compile_resnet8()
    chunks = dict(zip([l.spec.name for l in net.layers],
                      net.chunks_per_layer()))
    assert (chunks["b1a"], chunks["b1b"], chunks["t2b"], chunks["t2a"],
            chunks["t3b"]) == (5, 5, 3, 2, 2)
    _, _, cnet = tcifar.compile_cifar_cnn()
    assert cnet.chunks_per_layer()[:2] == [3, 8]


def _stage_residual(layer, stack: torch.Tensor,
                    sems: torch.Tensor) -> torch.Tensor:
    """The torch staging functions' residual staging (the reference the
    ``vta_stage`` gather's RES tables are built from and held to): the skip
    activations → int32 ``(B, M, N)`` operands → ACC-format bytes in the
    layer's ``res`` region.  Returns the operands."""
    R = staging.residual_operand_batch(layer.spec, sems,
                                       layer.residual_matrix.shape)
    raw = batch_matrix_to_binary(R, 16, torch.int32)
    region = layer.program.regions["res"]
    start = region.phys_addr - layer.program.allocator.offset
    assert raw.shape[1] == region.nbytes
    stack[:, start:start + raw.shape[1]] = raw
    return R


@pytest.mark.parametrize("model", ["resnet8", "resnet_tiny"])
def test_residual_staging_matches_reference(nets, model):
    """Per residual layer: the port's batched residual staging writes the
    bytes the reference's ``_stage_residual_batch`` writes, from the same
    skip activations (seeded int8, the source layer's semantic shape)."""
    tn, jn, _, _, _, _, _ = nets[model]
    rng = np.random.default_rng(31)
    base = jn.dram_image()
    staged = 0
    for k, (layer, src) in enumerate(zip(tn.layers, tn._res_sources())):
        if src is None:
            continue
        shape = ((1,) + tn.input_tensor.shape[1:] if src < 0 else
                 (1, tn.layers[src].spec.weights.shape[0],
                  tn.layers[src].out_h, tn.layers[src].out_w))
        sems = [rng.integers(-128, 128, shape).astype(np.int8)
                for _ in range(3)]
        jstack = np.broadcast_to(base, (3, base.size)).copy()
        jn._stage_residual_batch(jstack, jn.layers[k], sems)
        tstack = torch.from_numpy(base).expand(3, -1).clone()
        R = _stage_residual(layer, tstack,
                            torch.from_numpy(np.concatenate(sems)))
        np.testing.assert_array_equal(tstack.numpy(), jstack)
        assert R.dtype == torch.int32
        staged += 1
        bad = torch.zeros((3,) + shape[1:-1] + (shape[-1] + 1,),
                          dtype=torch.int8)
        with pytest.raises(CompileError) as exc:
            _stage_residual(layer, tstack, bad)
        assert exc.value.constraint == "residual-shape"
    assert staged == (3 if model == "resnet8" else 2)


@pytest.mark.parametrize("shape", [(3, 1, 10), (2, 64, 16), (1, 21, 19),
                                   (4, 33, 40)])
def test_int32_binarise_matches_reference(shape):
    """``batch_matrix_to_binary`` at int32 (the ACC-format residual
    operand): little-endian bytes equal to the reference's, negatives and
    the int32 extremes included."""
    rng = np.random.default_rng(sum(shape))
    mats = rng.integers(-(2 ** 31), 2 ** 31, shape, dtype=np.int64)
    mats[0, 0, 0], mats[-1, -1, -1] = -(2 ** 31), 2 ** 31 - 1
    mats = mats.astype(np.int32)
    got = batch_matrix_to_binary(torch.from_numpy(mats), 16,
                                         torch.int32)
    want = jlayout.batch_matrix_to_binary(mats, 16, np.int32)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("model", MODELS)
def test_no_pair_lattice_is_sequential(nets, model):
    """Every pair op of these models (the GAP head's ADD rounds, max and
    avg pool lattices) has disjoint dst and src, so the epilogue takes the
    vectorised scatter, never the per-pair loop."""
    tn = nets[model][0]
    lattices = 0
    for layer in tn.layers:
        p = cuda_backend.plan_cuda(layer.program)
        for aux in cuda_backend.lower_alu(p.alu_ops, torch.device("cpu")):
            if isinstance(aux, cuda_backend._PairLattice):
                assert not aux.sequential, layer.spec.name
                lattices += 1
    assert lattices > 0


@pytest.mark.parametrize("model", MODELS + ["lenet5"])
def test_cached_form_equals_per_call_checks(nets, model, monkeypatch):
    """Each layer's constants cached on the program equal what
    ``layer_consts`` reads off the served stack, the compiled image in
    every row with the staged operands as INP and the staged RES, on every
    layer; serving passes them for every layer; and the cached fusion
    decision is the plan's."""
    if model == "lenet5":
        from repro_torch.lenet5_e2e import compile_lenet5, request_images
        tn = compile_lenet5()[1]
        images = request_images(3)
    else:
        tn, image = nets[model][0], nets[model][4]
        images = np.stack([image(300 + r) for r in range(3)])
    real = tnc._execute_stack
    seen = []

    def spy(prog, stack, a, consts, *, saturate):
        # the served stack holds only what varies by image: read the
        # constants off the image in every row, with this batch's operands
        # in block order as INP and its RES
        b = stack.shape[0]
        p = cuda_backend.plan_cuda(prog)
        full = consts.image.expand(b, -1).clone()
        lo, n = p.inp
        full[:, lo:lo + n] = staging.matrix_blocks_batch(
            a.view(b, p.alpha * p.row_height, -1), p.row_height,
            16).view(torch.uint8)
        if p.res is not None:
            lo, n = p.res
            full[:, lo:lo + n] = stack[:, lo:lo + n]
        want = cuda_backend.layer_consts(prog, full)
        assert consts.fused == want.fused, prog.name
        assert torch.equal(consts.w, want.w), prog.name
        assert (consts.bias is None) == (want.bias is None), prog.name
        if want.bias is not None:
            assert torch.equal(consts.bias, want.bias), prog.name
        seen.append(prog.name)
        return real(prog, stack, a, consts, saturate=saturate)

    monkeypatch.setattr(tnc, "_execute_stack", spy)
    tn.serve(images, device="cpu")
    assert seen == [l.program.name for l in tn.layers]
    consts = tn.layer_consts("cpu")
    assert tn.layer_consts("cpu") is consts         # read once, cached
    assert [c.fused for c in consts] == [
        cuda_backend.plan_cuda(l.program).fused for l in tn.layers]


_CARRIERS = {"resnet8": (t8.resnet8_weights_from_arrays, "fc_b", "fc_w"),
             "resnet_tiny": (ttiny.resnet_tiny_weights_from_arrays,
                             "head_b", "head_w"),
             "cifar_cnn": (tcifar.cifar_cnn_weights_from_arrays, "fc5_b",
                           "fc4_w")}


@pytest.mark.parametrize("model", MODELS)
def test_weights_from_reference_arrays(nets, model):
    """The reference's weight dataclass, as named numpy arrays, becomes the
    port's; missing, unexpected, misshapen and mistyped entries raise
    ``WeightsError`` with their constraint."""
    carrier, last_b, a_w = _CARRIERS[model]
    _, _, _, _, _, tw, jw = nets[model]
    arrays = dataclasses.asdict(jw)
    weights = carrier(arrays)
    assert type(weights) is type(tw)
    for name, arr in dataclasses.asdict(tw).items():
        np.testing.assert_array_equal(getattr(weights, name), arr)
    bad = dict(arrays)
    del bad[last_b]
    with pytest.raises(WeightsError) as exc:
        carrier(bad)
    assert (exc.value.constraint, exc.value.name) == ("weights-missing",
                                                      last_b)
    first_b = next(n for n in arrays if n.endswith("_b"))
    first_w = next(n for n in arrays if n.endswith("_w"))
    for mutate, constraint in (
            (lambda d: d.update(extra=np.zeros(1)), "weights-unexpected"),
            (lambda d: d.update({a_w: d[a_w][..., :-1]}), "weights-shape"),
            (lambda d: d.update({first_b: d[first_b].astype(np.int64)}),
             "weights-dtype"),
            (lambda d: d.update({first_w: d[first_w].astype(np.float32)}),
             "weights-dtype")):
        bad = dict(arrays)
        mutate(bad)
        with pytest.raises(WeightsError) as exc:
            carrier(bad)
        assert exc.value.constraint == constraint
    assert issubclass(WeightsError, ValueError)
