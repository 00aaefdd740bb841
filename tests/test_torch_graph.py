"""The port's graph front end against the reference's, pass for pass.

``repro_torch.graph`` is a copy of ``repro.graph`` (imports changed).  The
same seeded graphs are built with each package's ``GraphBuilder`` — a
random DAG generator drawing from one numpy generator per package, so both
draw the same graph — and every pass must agree: ``infer_shapes``,
``plan_requant`` (shifts, pre-shifts, scale exponents), ``linearize``
(every fused step), ``evaluate_graph`` (every value) and ``compile_graph``
(byte-identical programs and the same schedule).  A graph one package
rejects, the other rejects at the same pass with the same
``CompileError`` constraint.  Where the port compiles a graph, it serves
it on the CPU bit-exactly against the graph's integer reference.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.graph as jgraph                                     # noqa: E402
import repro_torch.graph as tgraph                               # noqa: E402
from repro.core.errors import CompileError as JCompileError     # noqa: E402
from repro_torch.core.errors import CompileError as TCompileError  # noqa: E402

from test_torch_compiler import assert_programs_identical        # noqa: E402

PACKAGES = {"reference": (jgraph, JCompileError),
            "port": (tgraph, TCompileError)}


def _w(rng, *shape):
    return rng.integers(-6, 7, shape, dtype=np.int64).astype(np.int8)


def _b(rng, n):
    return rng.integers(-30, 31, (n,), dtype=np.int64).astype(np.int32)


def _random_graph(graph, rng):
    """A random small DAG (residual blocks, pools, stride-2 convs, GAP and
    fc heads), sometimes deliberately broken (channel mismatches, missing
    requants, joins of mismatched shapes, dropped pixels, non-power-of-two
    GAP maps) — the reference's ``tests/test_graph_passes.py`` generator,
    built with ``graph``'s ``GraphBuilder``."""
    bld = graph.GraphBuilder("fuzz")
    c = int(rng.integers(1, 5))
    hw = int(rng.choice([4, 6, 8]))
    bld.input("image", shape=(1, c, hw, hw))
    vals = [("image", c, hw)]
    uid = [0]

    def fresh(prefix):
        uid[0] += 1
        return f"{prefix}{uid[0]}"

    def conv_chain(src, sc, shw, *, relu=True, pool=None, requant=True,
                   breakage=0.0, stride=1):
        f = int(rng.integers(1, 7))
        if stride == 2:
            k, pad = (3, 1) if rng.random() < 0.5 else (2, 0)
        else:
            k = int(rng.choice([1, 3]))
            pad = (k - 1) // 2
        in_c = sc if rng.random() >= breakage else sc + 1
        v = bld.conv(fresh("c"), src, _w(rng, f, in_c, k, k), _b(rng, f),
                     stride=stride, padding=pad)
        shw = (shw + 2 * pad - k) // stride + 1
        if relu:
            v = bld.relu(fresh("r"), v)
        if pool and shw % 2 == 0:
            v = bld.pool(fresh("p"), v, pool)
            shw //= 2
        if requant:
            v = bld.requant(fresh("q"), v)
        return v, f, shw

    for _ in range(int(rng.integers(1, 4))):
        src, sc, shw = vals[int(rng.integers(0, len(vals)))]
        kind = rng.random()
        if kind < 0.3 and shw >= 4:                   # residual block
            a, fa, _ = conv_chain(src, sc, shw, relu=True)
            bvi = bld.conv(fresh("c"), a, _w(rng, sc, fa, 3, 3),
                           _b(rng, sc), padding=1)
            bq = bld.requant(fresh("q"), bvi)
            j = bld.relu(fresh("r"), bld.add(fresh("j"), bq, src))
            vals.append((bld.requant(fresh("q"), j), sc, shw))
        elif kind < 0.4:                               # unfused add
            other, _, _ = vals[int(rng.integers(0, len(vals)))]
            j = bld.add(fresh("j"), src, other)
            vals.append((bld.requant(fresh("q"), j), sc, shw))
        elif kind < 0.55 and shw >= 3:                 # stride-2 downsampling
            v, f, shw2 = conv_chain(src, sc, shw, relu=bool(rng.integers(2)),
                                    stride=2)
            vals.append((v, f, shw2))
        else:                                          # plain conv chain
            pool = rng.choice([None, "max2x2", "avg2x2"])
            v, f, shw2 = conv_chain(src, sc, shw, relu=bool(rng.integers(2)),
                                    pool=pool, requant=rng.random() > 0.1,
                                    breakage=0.15)
            vals.append((v, f, shw2))
    src, sc, shw = vals[int(rng.integers(0, len(vals)))]
    tail = rng.random()
    if tail < 0.25:                                    # GAP head
        v = bld.relu(fresh("r"), bld.conv(fresh("c"), src,
                                          _w(rng, sc, sc, 1, 1), _b(rng, sc)))
        v = bld.requant(fresh("q"), bld.global_avg_pool(fresh("g"), v))
        v = bld.fc(fresh("h"), bld.flatten(fresh("f"), v),
                   _w(rng, sc, 5), _b(rng, 5))
        bld.output(bld.requant(fresh("q"), v))
    elif tail < 0.8:
        v = bld.fc(fresh("h"), bld.flatten(fresh("f"), src),
                   _w(rng, sc * shw * shw, 5), _b(rng, 5))
        bld.output(bld.requant(fresh("q"), v))
    else:
        bld.output(src)
    return bld.build(), (1, c, hw, hw)


def _outcome(fn, error):
    """``("ok", value)`` or ``("error", constraint)``."""
    try:
        return "ok", fn()
    except error as exc:
        return "error", exc.constraint


def _run_passes(pkg, seed):
    """Every pass over the seeded graph with one package; each entry is
    an ``_outcome``.  Stops at the first refusal, as a compile would."""
    graph, error = PACKAGES[pkg]
    rng = np.random.default_rng(1000 + seed)
    built = _outcome(lambda: _random_graph(graph, rng), error)
    out = {"build": built}
    if built[0] == "error":
        return out
    g, in_shape = built[1]
    img = rng.integers(-40, 41, in_shape, dtype=np.int64).astype(np.int8)
    calib = [rng.integers(-40, 41, in_shape, dtype=np.int64).astype(np.int8)
             for _ in range(2)]
    out["img"] = img
    for name, fn in (
            ("infer_shapes", lambda: graph.infer_shapes(g)),
            ("plan_requant", lambda: graph.plan_requant(g, calib + [img])),
            ("linearize", lambda: graph.linearize(g)),
            ("evaluate_graph", lambda: graph.evaluate_graph(g, img)),
            ("compile_graph", lambda: graph.compile_graph(
                g, img, calib=calib + [img]))):
        out[name] = _outcome(fn, error)
        if out[name][0] == "error":
            break
    out["graph"] = g
    return out


def _steps_equal(ts, js):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
        for key in jd:
            if isinstance(jd[key], np.ndarray):
                np.testing.assert_array_equal(td[key], jd[key])
            else:
                assert td[key] == jd[key], (t.name, key)


# refusals of the reference that the port lifts and the seeded graphs can
# reach: a GAP over a square map whose position count is not a power of
# two (ResNet-50's 7×7).  Where the reference stops there, the port goes
# on, and the passes after it are the port's alone.  (The seeded stride-2
# convs all have kernel ≥ stride, whose refusals the port keeps.)
LIFTED = {"gap-pow2"}


def _gap_maps(graph, shapes):
    """(H, W) of every global-avg-pool input in ``graph``."""
    return [shapes[n.inputs[0]][2:] for n in graph.nodes.values()
            if n.kind == "global_avg_pool"]


@pytest.mark.parametrize("seed", range(40))
def test_passes_agree_on_seeded_graphs(seed):
    t, j = _run_passes("port", seed), _run_passes("reference", seed)
    t_keys = [k for k in t if k not in ("img", "graph")]
    j_keys = [k for k in j if k not in ("img", "graph")]
    lifted = j[j_keys[-1]][0] == "error" and j[j_keys[-1]][1] in LIFTED \
        and t[j_keys[-1]][0] == "ok"
    if lifted:
        assert t_keys[:len(j_keys)] == j_keys
        maps = _gap_maps(t["graph"], t["infer_shapes"][1])
        assert maps and all(h == w and (h * w) & (h * w - 1)
                            for h, w in maps), maps
        j_keys = j_keys[:-1]
    else:
        assert t_keys == j_keys
    for key in [k for k in j_keys if k != "build"]:
        (kind, val), (tkind, tval) = j[key], t[key]
        assert tkind == kind, (key, tval, val)
        if kind == "error":
            assert tval == val, key                 # the same constraint
        elif key == "infer_shapes":
            assert tval == val
        elif key == "plan_requant":
            assert (tval.shifts, tval.pre_shifts, tval.exps) == \
                (val.shifts, val.pre_shifts, val.exps)
        elif key == "linearize":
            _steps_equal(tval, val)
        elif key == "evaluate_graph":
            assert tval.keys() == val.keys()
            for name in val:
                np.testing.assert_array_equal(tval[name], val[name])
        elif key == "compile_graph":
            assert (tval.input_sources, tval.residual_sources) == \
                (val.input_sources, val.residual_sources)
            for tl, jl in zip(tval.layers, val.layers, strict=True):
                assert_programs_identical(tl.program, jl.program)
            g = t["graph"]
            want = tgraph.evaluate_graph(g, t["img"])[g.outputs[0]]
            out, _ = tval.serve([t["img"], t["img"]], device="cpu")
            for row in out:
                np.testing.assert_array_equal(row, want.astype(np.int8))
    if j["build"][0] == "error":
        assert t["build"] == j["build"]


def test_seeded_graphs_reach_every_outcome():
    """The population holds graphs that compile and graphs refused at
    different passes, so the agreement above is not vacuous."""
    ends = {}
    for seed in range(40):
        out = _run_passes("port", seed)
        last = [k for k in out if k not in ("img", "graph")][-1]
        ends[(last, out[last][0])] = ends.get((last, out[last][0]), 0) + 1
    assert ends.get(("compile_graph", "ok"), 0) >= 5
    assert sum(n for (_, kind), n in ends.items() if kind == "error") >= 5


def _malformed(graph):
    """Malformed graphs built with ``graph``, each a function that builds
    one and runs the pass that refuses it."""
    rng = np.random.default_rng(8)

    def unknown_ref():
        bld = graph.GraphBuilder("bad")
        bld.input("x", shape=(1, 1, 4, 4))
        bld.relu("r", "nope")

    def duplicate():
        bld = graph.GraphBuilder("bad")
        bld.input("x", shape=(1, 1, 4, 4))
        bld.input("x", shape=(1, 1, 4, 4))

    def pool_mode():
        bld = graph.GraphBuilder("bad")
        bld.input("x", shape=(1, 1, 4, 4))
        bld.pool("p", "x", mode="avg3x3")

    def stride3():
        bld = graph.GraphBuilder("bad")
        x = bld.input("x", shape=(1, 1, 8, 8))
        bld.conv("c", x, _w(rng, 2, 1, 3, 3), stride=3)

    def cycle():
        bld = graph.GraphBuilder("cyc")
        x = bld.input("x", shape=(1, 2, 4, 4))
        v = bld.requant("q", bld.relu("r", bld.conv(
            "c", x, _w(rng, 2, 2, 3, 3), padding=1)), shift=4)
        bld.output(v)
        g = bld.build()
        g.nodes["r"].inputs = ("q",)
        g.verify()

    def add_mismatch():
        bld = graph.GraphBuilder("bad")
        x = bld.input("x", shape=(1, 4, 8, 8))
        a = bld.requant("qa", bld.conv("c1", x, _w(rng, 8, 4, 3, 3),
                                       padding=1))
        d = bld.requant("qd", bld.conv("c2", x, _w(rng, 6, 4, 3, 3),
                                       padding=1))
        bld.output(bld.add("j", a, d))
        graph.infer_shapes(bld.build())

    def channels():
        bld = graph.GraphBuilder("bad")
        x = bld.input("x", shape=(1, 3, 8, 8))
        bld.output(bld.conv("c", x, _w(rng, 8, 4, 3, 3)))
        graph.infer_shapes(bld.build())

    def int8_feed():
        bld = graph.GraphBuilder("bad")
        x = bld.input("x", shape=(1, 2, 6, 6))
        v = bld.conv("c1", x, _w(rng, 4, 2, 3, 3), _b(rng, 4))
        bld.output(bld.conv("c2", v, _w(rng, 4, 4, 3, 3)))
        img = np.random.default_rng(1).integers(
            -40, 41, (1, 2, 6, 6)).astype(np.int8)
        graph.plan_requant(bld.build(), [img])

    def raw_output():
        bld = graph.GraphBuilder("bad")
        x = bld.input("x", shape=(1, 2, 8, 8))
        bld.output(bld.conv("c", x, _w(rng, 4, 2, 3, 3), padding=1))
        graph.linearize(bld.build())

    def relu_twice():
        bld = graph.GraphBuilder("bad")
        x = bld.input("x", shape=(1, 2, 8, 8))
        v = bld.conv("c", x, _w(rng, 4, 2, 3, 3), padding=1)
        v = bld.relu("r2", bld.relu("r1", v))
        bld.output(bld.requant("q", v, shift=8))
        graph.linearize(bld.build())

    def two_outputs():
        bld = graph.GraphBuilder("bad")
        x = bld.input("x", shape=(1, 2, 8, 8))
        v = bld.requant("q", bld.conv("c", x, _w(rng, 4, 2, 3, 3),
                                      padding=1), shift=6)
        bld.output(v)
        bld.output(x)
        g = bld.build()
        graph.compile_graph(g, np.zeros((1, 2, 8, 8), np.int8))

    return [unknown_ref, duplicate, pool_mode, stride3, cycle, add_mismatch,
            channels, int8_feed, raw_output, relu_twice, two_outputs]


@pytest.mark.parametrize("index", range(11))
def test_malformed_graphs_raise_the_same_constraint(index):
    t_fn, j_fn = _malformed(tgraph)[index], _malformed(jgraph)[index]
    t_name = t_fn.__name__
    assert t_name == j_fn.__name__
    with pytest.raises(JCompileError) as jexc:
        j_fn()
    with pytest.raises(TCompileError) as texc:
        t_fn()
    assert texc.value.constraint == jexc.value.constraint, t_name
    assert texc.value.constraint is not None
    # the port's message lists its pool modes, which hold one more
    said = str(texc.value).replace(str(tgraph.ir.POOL_MODES),
                                   str(jgraph.ir.POOL_MODES))
    assert said == str(jexc.value)


@pytest.mark.parametrize("model", ["resnet8", "resnet_tiny"])
def test_model_graphs_pass_for_pass(model):
    """resnet8's and resnet_tiny's planned graphs: the same shapes, plan,
    steps and values in both packages."""
    import importlib
    jm = importlib.import_module(f"repro.models.{model}")
    tm = importlib.import_module(f"repro_torch.models.{model}")
    build = "build_" + model
    rand = model + "_random_weights"
    calib = [jm.synthetic_image(s) for s in range(1, 5)]
    jw, tw = getattr(jm, rand)(), getattr(tm, rand)()
    jexps = jm.calibrate_weight_exps(jw, calib)
    assert tm.calibrate_weight_exps(tw, calib) == jexps
    jg, tg = getattr(jm, build)(jw, jexps), getattr(tm, build)(tw, jexps)
    assert tgraph.infer_shapes(tg) == jgraph.infer_shapes(jg)
    tp, jp = tgraph.plan_requant(tg, calib), jgraph.plan_requant(jg, calib)
    assert (tp.shifts, tp.pre_shifts, tp.exps) == \
        (jp.shifts, jp.pre_shifts, jp.exps)
    _steps_equal(tgraph.linearize(tg), jgraph.linearize(jg))
    tv = tgraph.evaluate_graph(tg, calib[0])
    jv = jgraph.evaluate_graph(jg, calib[0])
    assert tv.keys() == jv.keys()
    for name in jv:
        np.testing.assert_array_equal(tv[name], jv[name])
