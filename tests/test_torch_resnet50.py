"""ResNet-50 v1.5's lowerings in the port, on the CPU.

The 1×1/s2 rule of the strided lowering, the 3×3/s2/p1 max pool's plan
(tiled into SRAM chunks) against ``F.max_pool2d``, the GAP's ADD tree over
a count that is not a power of two against a sum, the join → GAP fusion,
and the whole topology at a small size (3×96×96, widths an eighth of the
published) compiled with its stem over several chunks: ``serve`` and
``NetworkProgram.verify`` on every CPU backend against the graph's integer
reference.  The float64 calibration gives the int64 path's shifts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F                                  # noqa: E402

from repro_torch import tracing                                 # noqa: E402
from repro_torch.core import gemm_compiler                      # noqa: E402
from repro_torch.core.conv_lowering import (ConvGeometry,        # noqa: E402
                                            expand_rows,
                                            global_avgpool_plan,
                                            maxpool3x3s2_plan)
from repro_torch.core.errors import CompileError                # noqa: E402
from repro_torch.core.hwconfig import VTAConfig                 # noqa: E402
from repro_torch.core.layer_compiler import check_stride_tiling  # noqa: E402
from repro_torch.core.layout import exact_matmul                # noqa: E402
from repro_torch.graph import (GraphBuilder, compile_graph,      # noqa: E402
                               evaluate_graph, linearize, passes,
                               plan_requant)
from repro_torch.models import resnet50 as r50                  # noqa: E402

SMALL = r50.ResNet50Shape(input_hw=96, stem_width=8, widths=(8, 16, 32, 64))


def _w(rng, *shape):
    return rng.integers(-5, 6, shape, dtype=np.int64).astype(np.int8)


def _b(rng, n):
    return rng.integers(-64, 65, (n,), dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------- stride --

@pytest.mark.parametrize("extent, k, pad", [
    (56, 1, 0), (55, 1, 0), (28, 1, 0), (7, 1, 0), (224, 7, 3), (56, 3, 1),
    (32, 2, 0)])
def test_stride_rule_accepts(extent, k, pad):
    check_stride_tiling(ConvGeometry(4, extent, extent, k, k, 2, pad))


@pytest.mark.parametrize("extent, k, pad", [(8, 3, 0), (56, 3, 0),
                                            (7, 2, 0), (9, 4, 0)])
def test_stride_rule_still_refuses_a_dropped_pixel(extent, k, pad):
    with pytest.raises(CompileError) as exc:
        check_stride_tiling(ConvGeometry(4, extent, extent, k, k, 2, pad))
    assert exc.value.constraint == "conv-stride-tiling"


@pytest.mark.parametrize("hw", [8, 7])
def test_1x1_s2_projection_serves(hw):
    """A 1×1/s2 conv reads every other pixel: the graph's value is the
    strided slice times the weights, and the VTA serves it."""
    rng = np.random.default_rng(hw)
    bld = GraphBuilder("proj")
    x = bld.input("x", shape=(1, 6, hw, hw))
    w, b = _w(rng, 16, 6, 1, 1), _b(rng, 16)
    bld.output(bld.requant("q", bld.conv("p", x, w, b, stride=2)))
    g = bld.build()
    img = rng.integers(-64, 64, (1, 6, hw, hw)).astype(np.int8)
    plan_requant(g, [img])
    vals = evaluate_graph(g, img)
    direct = np.einsum("fc,nchw->nfhw", w[:, :, 0, 0].astype(np.int64),
                       img[:, :, ::2, ::2].astype(np.int64)) \
        + b[None, :, None, None]
    np.testing.assert_array_equal(vals["p"], direct)
    net = compile_graph(g, img)
    out, _ = net.serve(np.stack([img[0], img[0]]), device="cpu")
    for row in out:
        np.testing.assert_array_equal(row, vals["q"].astype(np.int8))


# ------------------------------------------------------------ max pool --

def _run_pool(plan, acc: np.ndarray) -> np.ndarray:
    """The plan's MAX pairs over the result rows, one pair after the
    other, then the kept rows: what the ALU program leaves."""
    vec = expand_rows(acc, plan.input_rows).copy()
    for dst, src in plan.add_pairs:
        vec[dst] = np.maximum(vec[dst], vec[src])
    return vec[list(plan.keep_rows)]


@pytest.mark.parametrize("h, w, max_rows", [
    (112, 112, 192), (48, 48, 192), (48, 48, 64), (9, 7, None), (6, 6, None),
    (2, 3, None), (1, 1, None), (17, 23, 48)])
def test_maxpool_plan_equals_max_pool2d(h, w, max_rows):
    rng = np.random.default_rng(h * 100 + w)
    acc = rng.integers(-(2 ** 20), 2 ** 20, (h * w, 5))   # negatives too
    plan = maxpool3x3s2_plan(h, w, max_rows=max_rows, block=16)
    got = _run_pool(plan, acc)
    t = torch.from_numpy(acc.astype(np.float64).T.reshape(1, 5, h, w))
    want = F.max_pool2d(t, 3, 2, 1)[0].reshape(5, -1).T.numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert (plan.out_h, plan.out_w) == ((h - 1) // 2 + 1, (w - 1) // 2 + 1)
    dst = {d for d, _ in plan.add_pairs}
    assert not dst & {s for _, s in plan.add_pairs}     # no src is a dst
    assert len(set(plan.keep_rows)) == len(plan.keep_rows)


def test_maxpool_tiles_fit_their_chunks():
    """Each tile's windows lie inside its own whole block rows of at most
    ``max_rows`` rows, so a chunk boundary may fall between any two."""
    plan = maxpool3x3s2_plan(112, 112, max_rows=192, block=16)
    rows = np.asarray(plan.input_rows)
    assert len(rows) % 16 == 0 and len(rows) < 1.25 * 112 * 112
    groups = [(min(d, s) // 16, max(d, s) // 16) for d, s in plan.add_pairs]
    starts = sorted({lo for lo, _ in groups})
    cut_ok = np.ones(len(rows) // 16 + 1, bool)
    for lo, hi in groups:
        cut_ok[lo + 1:hi + 1] = False
        assert (hi - lo + 1) * 16 <= 192
    assert cut_ok.sum() > 40 and starts[0] == 0
    # a padding row (-1) is never a window's member
    assert all(rows[s] >= 0 and rows[d] >= 0 for d, s in plan.add_pairs)
    whole = maxpool3x3s2_plan(112, 112)
    assert whole.input_rows is None and len(whole.keep_rows) == 56 * 56


# -------------------------------------------------------------- GAP tree --

@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 8, 9, 13])
def test_gap_tree_sums_any_square(k):
    plan = global_avgpool_plan(k, k)
    n = k * k
    vec = np.random.default_rng(k).integers(-1000, 1000, (n, 4))
    want = vec.sum(axis=0)
    for rnd in plan.rounds:
        touched = [i for pair in rnd for i in pair]
        assert len(touched) == len(set(touched))        # one op a round
        for dst, src in rnd:
            vec[dst] += vec[src]
    np.testing.assert_array_equal(vec[0], want)
    assert plan.keep_rows == (0,) and plan.div_shift == n.bit_length() - 1
    assert len(plan.rounds) == (n - 1).bit_length()


def test_gap_needs_a_square_map():
    with pytest.raises(CompileError) as exc:
        passes.infer_shapes(_gap_graph(np.random.default_rng(0), 3, 4))
    assert exc.value.constraint == "gap-square"


def _gap_graph(rng, h, w, channels=20):
    bld = GraphBuilder("join_gap")
    x = bld.input("x", shape=(1, channels, h, w))
    c = bld.requant("c_q", bld.conv("c", x, _w(rng, channels, channels, 1, 1),
                                    _b(rng, channels)))
    v = bld.relu("r", bld.add("join", c, x))
    v = bld.requant("head_q", bld.global_avg_pool("gap", v))
    v = bld.fc("fc", bld.flatten("flat", v), _w(rng, channels, 10),
               _b(rng, 10))
    bld.output(bld.requant("fc_q", v))
    return bld.build()


@pytest.mark.parametrize("hw", [7, 3, 4])
def test_join_then_gap_fuses_into_one_layer(hw):
    rng = np.random.default_rng(hw)
    g = _gap_graph(rng, hw, hw)
    imgs = [rng.integers(-64, 64, (1, 20, hw, hw)).astype(np.int8)
            for _ in range(3)]
    plan = plan_requant(g, imgs)
    floor = (hw * hw).bit_length() - 1
    assert plan.shifts["head_q"] >= floor
    assert plan.exps["gap"] == plan.exps["r"] + floor
    steps = linearize(g)
    assert [s.name for s in steps] == ["c", "fc"]
    assert steps[0].pool == "gap" and steps[0].residual_source == "x"
    assert steps[0].relu and steps[0].residual_shift == plan.shifts["head_q"]
    net = compile_graph(g, imgs[-1], calib=imgs)
    assert net.layers[0].program.alu_kind == "join+gap"
    assert net.layers[0].keep_rows == (0,)
    out, _ = net.serve(np.stack([i[0] for i in imgs]), device="cpu")
    for img, row in zip(imgs, out):
        want = evaluate_graph(g, img)["fc_q"].astype(np.int8)
        np.testing.assert_array_equal(row, want)
    for backend in ("oracle", "fast", "batched"):
        net.verify(backend=backend, device="cpu")


def test_a_wide_join_gap_takes_fewer_columns_a_chunk():
    """ResNet-50's last layer (1×1 512→2048 on 7×7, join, ReLU, GAP over
    49): the GAP tree holds all four block rows in one chunk, so a chunk
    takes 16 of the 128 block columns, not 32."""
    from repro_torch.core.layer_compiler import LayerSpec, compile_layer
    from repro_torch.core.simulator import verify_program
    rng = np.random.default_rng(4)
    spec = LayerSpec("c", "conv", _w(rng, 2048, 512, 1, 1), _b(rng, 2048),
                     relu=True, pool="gap", residual_add=True,
                     residual_pre_shift=1)
    image = rng.integers(0, 64, (1, 512, 7, 7)).astype(np.int8)
    skip = rng.integers(0, 64, (1, 2048, 7, 7)).astype(np.int8)
    layer = compile_layer(spec, image, residual=skip)
    plan = layer.program.chunk_plan
    assert (plan.alpha_c, plan.beta_c, plan.n_chunks) == (4, 16, 8)
    assert layer.keep_rows == (0,) and layer.ref_output_matrix.shape == \
        (1, 2048)
    verify_program(layer.program, backend="fast", device="cpu")


# ------------------------------------------------------- the small model --

@pytest.fixture(scope="module")
def small():
    weights = r50.resnet50_random_weights(SMALL, seed=5)
    calib = [r50.synthetic_image(s, SMALL) for s in range(1, 5)]
    image = r50.synthetic_image(0, SMALL)
    net, graph = r50.compile_resnet50(weights, calib, image, shape=SMALL)
    return weights, calib, image, net, graph


def test_small_model_compiles_the_published_graph(small):
    _, _, _, net, graph = small
    names = [l.spec.name for l in net.layers]
    assert sorted(names) == sorted(r50.linear_nodes(SMALL))
    stem = net.layers[0]
    assert stem.spec.pool == "max3x3s2" and stem.n_chunks > 1
    assert stem.input_rows is not None and stem.program.alu_kind == \
        "maxpool3x3s2"
    assert (stem.out_h, stem.out_w) == (24, 24)
    kinds = {l.spec.name: l.program.alu_kind for l in net.layers}
    assert kinds["s4b3c"] == "join+gap"
    assert sum(k == "join" for k in kinds.values()) == 15
    projections = [l for l in net.layers if l.spec.name.endswith("p")]
    assert [(l.spec.stride, l.spec.weights.shape[2]) for l in projections] \
        == [(1, 1), (2, 1), (2, 1), (2, 1)]
    assert graph.node("head_gap").kind == "global_avg_pool"


def test_small_model_serves_its_graph(small):
    _, _, _, net, graph = small
    images = np.stack([r50.synthetic_image(100 + s, SMALL)[0]
                       for s in range(3)])
    out, _ = net.serve(images, device="cpu")
    for img, row in zip(images, out):
        want = evaluate_graph(graph, img[None])[graph.outputs[0]]
        np.testing.assert_array_equal(row, want.astype(np.int8))
    assert out.shape == (3, 1, 1000) and np.abs(out.astype(int)).max() > 0
    batched, _ = net.serve(images, backend="batched", device="cpu")
    np.testing.assert_array_equal(batched, out)


@pytest.mark.parametrize("backend", ["oracle", "fast", "batched", "cuda"])
def test_small_model_verifies(small, backend):
    small[3].verify(backend=backend, device="cpu")


def test_small_stem_splits_under_a_smaller_buffer():
    """A VTA whose INP buffer holds half the default's cuts the stem into
    smaller tiles; the served answer is the graph's still."""
    cfg = VTAConfig(inp_buff_vectors=1024)
    weights = r50.resnet50_random_weights(SMALL, seed=6)
    calib = [r50.synthetic_image(s, SMALL) for s in range(1, 3)]
    image = r50.synthetic_image(0, SMALL)
    net, graph = r50.compile_resnet50(weights, calib, image, shape=SMALL,
                                      cfg=cfg)
    assert net.layers[0].n_chunks > 18
    out = net.serve_one(image, backend="fast", device="cpu")
    want = evaluate_graph(graph, image)[graph.outputs[0]]
    np.testing.assert_array_equal(out, want.astype(np.int8))


def test_calibration_in_float64_gives_the_int64_shifts(small, monkeypatch):
    weights, calib, image, _, _ = small
    wexps = r50.calibrate_weight_exps(weights, calib, shape=SMALL)
    fast = plan_requant(r50.build_resnet50(weights, wexps, SMALL),
                        calib + [image])
    monkeypatch.setattr(passes, "exact_matmul",
                        lambda a, b: a.astype(np.int64) @ b.astype(np.int64))
    slow = plan_requant(r50.build_resnet50(weights, wexps, SMALL),
                        calib + [image])
    assert (fast.shifts, fast.pre_shifts, fast.exps) == \
        (slow.shifts, slow.pre_shifts, slow.exps)


def test_exact_matmul_holds_every_integer():
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, (40, 4608))
    b = rng.integers(-128, 128, (4608, 30))
    np.testing.assert_array_equal(exact_matmul(a, b), a @ b)
    big = np.full((2, 3), 2 ** 40)          # past 2**53: the int64 path
    np.testing.assert_array_equal(exact_matmul(big, big.T), big @ big.T)


def test_pair_ops_merge_as_they_run_in_order():
    """``reference_result``'s merged pair ops equal the pairs one by one
    (MAX over a 3×3 window's members, ADD with a wrap)."""
    rng = np.random.default_rng(3)
    vec = rng.integers(-(2 ** 31), 2 ** 31, (40, 16)).astype(np.int32)
    pairs = tuple((int(d), int(s)) for d, s in zip(
        rng.integers(0, 10, 60), rng.integers(10, 40, 60)))
    for op in (gemm_compiler.isa.AluOp.MAX, gemm_compiler.isa.AluOp.ADD):
        spec = gemm_compiler.AluPairOp(op, pairs)
        want = vec
        for d, s in pairs:
            want = gemm_compiler._alu_pair(want, op, d, s)
        np.testing.assert_array_equal(gemm_compiler._alu_pairs(vec, spec),
                                      want)


def test_epilogue_spans_name_the_alu_program(small):
    net = small[3]
    images = np.stack([r50.synthetic_image(7, SMALL)[0]] * 2)
    tracing.clear()
    with torch.profiler.profile():
        net.serve(images, device="cpu")
    kinds = [s["attrs"]["alu"] for s in tracing.snapshot()["spans"]
             if s["name"] == "repro_torch.layer.epilogue"]
    tracing.clear()
    assert kinds.count("maxpool3x3s2") == 1 and kinds[0] == "maxpool3x3s2"
    assert kinds.count("join") == 15 and kinds[-1] == "join+gap"


def test_the_driver_serves_the_small_model(monkeypatch, capsys):
    from repro_torch import resnet50_e2e
    monkeypatch.setattr("sys.argv", ["resnet50_e2e", "--small", "--device",
                                     "cpu", "--requests", "3", "--batch",
                                     "2"])
    resnet50_e2e.main()
    out = capsys.readouterr().out
    assert "54 VTA layers" in out and "bit-exact vs integer reference: 3/3" \
        in out
    assert "max3x3s2" in out and "gap" in out
