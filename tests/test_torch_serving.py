"""The port's async serving engine against the reference's, on the CPU.

``repro_torch.serving.vta`` copies the reference's queue, policy, metrics,
clock and load generator and ports its engine and simulation to a torch
device.  On ``device="cpu"`` the port runs ``vta_gemm``'s plain version,
so these tests hold everything around the kernel:

* the network's serving introspection (input signature, plan shapes, the
  padding ladder) equals the reference's for all four CNNs;
* the copied pure functions agree with the reference's over seeded grids;
* the virtual-clock simulation replays the reference's traces exactly,
  and with a net attached its outputs equal the reference's ``batched``
  outputs;
* the threaded engine, with one and with two ``cuda`` workers, answers
  bit-identically to the reference's direct ``serve(backend="batched")``
  with a clean audit;
* the reference engine's contracts hold with the same typed errors and
  constraints.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.network_compiler as jnc                        # noqa: E402
import repro.models.lenet as jlenet                              # noqa: E402
import repro.serving.vta as jsv                                  # noqa: E402
import repro_torch.core.network_compiler as tnc                  # noqa: E402
import repro_torch.models.lenet as tlenet                        # noqa: E402
import repro_torch.serving.vta as tsv                            # noqa: E402
from repro_torch.core.errors import CompileError                 # noqa: E402
from repro_torch.kernels import flash_attention as tflash        # noqa: E402
from repro_torch.kernels import ops as tops                      # noqa: E402

MODELS = ["lenet5", "resnet8", "resnet_tiny", "cifar_cnn"]
MODEL = (0.004, 0.001)           # ServiceModel(base_s, per_image_s)


def _lenet(nc, lenet):
    return nc.compile_network(lenet.lenet5_specs(lenet.lenet5_random_weights(0)),
                              lenet.synthetic_digit(0))


@pytest.fixture(scope="module")
def nets():
    """model -> (port net, reference net), each compiled at full width."""
    import repro.models.cifar_cnn as jcifar
    import repro.models.resnet8 as j8
    import repro.models.resnet_tiny as jtiny
    import repro_torch.models.cifar_cnn as tcifar
    import repro_torch.models.resnet8 as t8
    import repro_torch.models.resnet_tiny as ttiny
    from test_torch_compiler import compile_cifar_reference
    return {
        "lenet5": (_lenet(tnc, tlenet), _lenet(jnc, jlenet)),
        "resnet8": (t8.compile_resnet8()[0], j8.compile_resnet8()[0]),
        "resnet_tiny": (ttiny.compile_resnet_tiny()[0],
                        jtiny.compile_resnet_tiny()[0]),
        "cifar_cnn": (tcifar.compile_cifar_cnn()[2],
                      compile_cifar_reference()[2]),
    }


# ---------------------------------------------------------------------------
# NetworkProgram's serving introspection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_introspection_matches_reference(nets, model):
    tn, jn = nets[model]
    assert tn.input_signature() == jn.input_signature()
    assert tn.plan_shapes() == jn.plan_shapes()
    for max_batch in range(1, 34):
        assert tn.padded_batch_sizes(max_batch) == \
            jn.padded_batch_sizes(max_batch) == tsv.pad_ladder(max_batch)
    for bad in (0, -3):
        with pytest.raises(CompileError) as exc:
            tn.padded_batch_sizes(bad)
        assert exc.value.constraint == "ladder-max-batch"


# ---------------------------------------------------------------------------
# The copied pure functions against the reference's, over seeded grids
# ---------------------------------------------------------------------------

def _same(fn, *args, **kw):
    """Call ``fn`` of both packages; equal results or the same error."""
    out = []
    for pkg in (tsv, jsv):
        try:
            out.append(("ok", getattr(pkg, fn)(*args, **kw)))
        except ValueError as exc:
            out.append((type(exc).__name__, str(exc)))
    assert out[0] == out[1], (fn, args, kw)
    return out[0]


def _grid_pad_ladder(rng, nets):
    for max_batch in range(-2, 70):
        _same("pad_ladder", max_batch)


def _grid_padded_size(rng, nets):
    for max_batch in (1, 2, 6, 8, 13, 32):
        ladder = tsv.pad_ladder(max_batch)
        for n in range(0, max_batch + 3):
            _same("padded_size", n, ladder)


def _grid_ready_count(rng, nets):
    for _ in range(400):
        policy = (tsv.BatchPolicy, jsv.BatchPolicy)
        kw = dict(max_batch=int(rng.integers(1, 10)),
                  max_wait_s=float(rng.choice([0.0, 0.002, 0.01])))
        args = (int(rng.integers(-1, 12)), float(rng.uniform(0, 1)))
        now = args[1] + float(rng.choice([0.0, kw["max_wait_s"],
                                          rng.uniform(0, 0.02)]))
        closed = bool(rng.integers(2))
        got = tsv.ready_count(*args, now, policy[0](**kw), closed=closed)
        want = jsv.ready_count(*args, now, policy[1](**kw), closed=closed)
        assert got == want


def _grid_poisson_arrival_times(rng, nets):
    for rate in (0.0, 10.0, 333.3, 5000.0):
        for n in (0, 1, 50):
            _same("poisson_arrival_times", rate, n,
                  int(rng.integers(0, 2 ** 31)),
                  start=float(rng.uniform(0, 2)))


def _grid_request_images(rng, nets):
    for tn, jn in nets.values():
        seed = int(rng.integers(0, 2 ** 31))
        got = tsv.request_images(tn, 5, seed)
        want = jsv.request_images(jn, 5, seed)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _grid_nearest_rank(rng, nets):
    _same("nearest_rank", [], 50)
    for size in (1, 2, 10, 99, 1000):
        vals = sorted(rng.uniform(0, 1, size).tolist())
        for q in (0, 1, 25, 50, 95, 99, 99.9, 100, 101, -1):
            _same("nearest_rank", vals, q)


GRIDS = {name[len("_grid_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("_grid_")}


@pytest.mark.parametrize("fn", sorted(GRIDS))
def test_copies_agree_with_reference(nets, fn):
    GRIDS[fn](np.random.default_rng(sum(map(ord, fn))), nets)


def test_batch_policy_validation_matches_reference():
    for kw in (dict(max_batch=0), dict(max_batch=4, max_wait_s=-1.0),
               dict(max_batch=4, max_depth=0)):
        with pytest.raises(ValueError) as got:
            tsv.BatchPolicy(**kw)
        with pytest.raises(ValueError) as want:
            jsv.BatchPolicy(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(CompileError) as exc:
        tsv.BatchPolicy(max_batch=0)
    assert exc.value.constraint == "policy-max-batch"


def _records(pkg, rng, n):
    return [pkg.RequestRecord(
        rid=int(rid), enqueue_t=float(e), dispatch_t=float(e + d),
        complete_t=float(e + d + c), batch_size=int(b), padded_size=int(p),
        backend="cuda", worker=int(w))
        for rid, e, d, c, b, p, w in zip(
            rng.integers(0, n, n), rng.uniform(0, 1, n),
            rng.uniform(-0.01, 0.05, n), rng.uniform(-0.01, 0.05, n),
            rng.integers(0, 5, n), rng.integers(1, 5, n),
            rng.integers(0, 2, n))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_summary_and_audit_match_reference(seed):
    """The same records (some with accounting violations) give the same
    summary, histogram and audit in both packages."""
    metrics = []
    for pkg in (tsv, jsv):
        rng = np.random.default_rng(seed)
        m = pkg.ServingMetrics(slo_s=0.03)
        for _ in range(int(rng.integers(10, 40))):
            m.on_submit()
        m.on_reject()
        m.on_cancel(2)
        m.on_fail()
        for rec in _records(pkg, rng, 25):
            m.observe(rec)
        metrics.append(m)
    t, j = metrics
    assert t.summary() == j.summary()
    assert t.latency_histogram() == j.latency_histogram()
    assert t.audit() == j.audit() and t.audit()
    assert t.drained() == j.drained()


# ---------------------------------------------------------------------------
# Virtual-clock simulation: the reference's traces, replayed
# ---------------------------------------------------------------------------

def _sources(pkg, kind, images=None):
    if kind == "poisson":
        return pkg.PoissonSource(600.0, 80, seed=42, images=images)
    if kind == "overload":
        return pkg.PoissonSource(5000.0, 120, seed=1, images=images)
    return pkg.ClosedLoopSource(3, 40, think_s=0.001, images=images)


def _no_backend(trace):
    return [t[:6] + t[7:] for t in trace]


@pytest.mark.parametrize("kind", ["poisson", "overload", "closed_loop"])
@pytest.mark.parametrize("workers", [1, 2])
def test_simulate_replays_reference_trace(kind, workers):
    results = [pkg.simulate(_sources(pkg, kind),
                            pkg.BatchPolicy(max_batch=4, max_wait_s=0.01,
                                            max_depth=16),
                            pkg.ServiceModel(*MODEL), workers=workers,
                            slo_s=0.05)
               for pkg in (tsv, jsv)]
    t, j = results
    assert {r[6] for r in t.trace()} == {"cuda"}
    assert _no_backend(t.trace()) == _no_backend(j.trace())
    assert t.metrics.summary() == j.metrics.summary()
    assert t.metrics.latency_histogram() == j.metrics.latency_histogram()
    assert t.metrics.audit() == [] and t.outputs is None


@pytest.mark.parametrize("workers", [1, 2])
def test_simulate_with_net_matches_reference_outputs(nets, workers):
    """Every formed batch really executes (padded up the ladder): outputs
    bit-identical to the reference's ``batched`` outputs and to a direct
    serve of the same images."""
    tn, jn = nets["lenet5"]
    results = []
    for pkg, net, kw in ((tsv, tn, dict(device="cpu")),
                         (jsv, jn, dict(backend="batched"))):
        images = pkg.request_images(net, 11, seed=3)   # 4 + 4 + 3 → 4
        results.append(pkg.simulate(
            pkg.PoissonSource(500.0, 11, seed=5, images=images),
            pkg.BatchPolicy(max_batch=4, max_wait_s=0.01),
            pkg.ServiceModel(*MODEL), workers=workers, net=net, **kw))
    t, j = results
    assert _no_backend(t.trace()) == _no_backend(j.trace())
    assert any(r.padded_size > r.batch_size for r in t.records)
    direct, _ = tn.serve(images, device="cpu")
    assert sorted(t.outputs) == list(range(11))
    for rid, out in t.outputs.items():
        np.testing.assert_array_equal(out, j.outputs[rid])
        np.testing.assert_array_equal(out, direct[rid])


def test_service_model_calibration_on_cpu(nets):
    tn, _ = nets["lenet5"]
    before = tops.launches
    model = tsv.calibrate_service_model(tn, device="cpu", batch=4,
                                        repeats=1)
    assert model.base_s > 0 and model.per_image_s >= 0
    assert model.service_s(4) >= model.service_s(1)
    assert tops.launches == before           # CPU tensors: plain version


# ---------------------------------------------------------------------------
# The threaded engine: bit-identity against the reference's direct serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("model,n,max_batch", [("lenet5", 12, 4),
                                               ("resnet8", 5, 2)])
def test_engine_bit_identical_to_reference_serve(nets, model, n, max_batch,
                                                 workers):
    tn, jn = nets[model]
    images = tsv.request_images(tn, n, seed=1)
    policy = tsv.BatchPolicy(max_batch=max_batch, max_wait_s=0.002)
    with tsv.VTAServingEngine(tn, policy=policy, backends=("cuda",) * workers,
                              device="cpu") as engine:
        outs, tickets = tsv.serve_all(engine, images)
    want, _ = jn.serve(images, backend="batched")
    np.testing.assert_array_equal(outs, want)
    direct, _ = tn.serve(images, device="cpu")
    np.testing.assert_array_equal(outs, direct)
    assert engine.metrics.audit() == [] and engine.metrics.drained()
    assert all(t.record.backend == "cuda" and 0 <= t.record.worker < workers
               for t in tickets)


# ---------------------------------------------------------------------------
# The reference engine's contracts, mirrored
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lenet(nets):
    return nets["lenet5"][0]


@pytest.mark.parametrize("policy,expect", [
    # max_wait=0: a lone request never waits for batchmates
    (dict(max_batch=8, max_wait_s=0.0), None),
    # max_batch=1 serves every request alone whatever the queue depth
    (dict(max_batch=1, max_wait_s=0.05), None),
    # a 3-deep queue at max_batch=4 forms one batch padded to 4
    (dict(max_batch=4, max_wait_s=0.2), ([3, 3, 3], [4, 4, 4])),
], ids=["max_wait_zero", "max_batch_one", "pads_up_the_ladder"])
def test_batch_former_edge_cases(lenet, policy, expect):
    images = tsv.request_images(lenet, 3, seed=4)
    engine = tsv.VTAServingEngine(lenet, policy=tsv.BatchPolicy(**policy),
                                  device="cpu")
    if expect is None:                        # serial: one in flight at once
        with engine:
            tickets = []
            for img in images:
                tickets.append(engine.submit(img))
                tickets[-1].result(timeout=60.0)
        expect = ([1, 1, 1], [1, 1, 1])
    else:                                     # queued before start
        tickets = [engine.submit(img) for img in images]
        with engine:
            for t in tickets:
                t.result(timeout=60.0)
    direct, _ = lenet.serve(images, device="cpu")
    np.testing.assert_array_equal(np.stack([t.result() for t in tickets]),
                                  direct)
    assert [t.record.batch_size for t in tickets] == expect[0]
    assert [t.record.padded_size for t in tickets] == expect[1]


def test_backpressure_rejects_with_queue_full(lenet):
    images = tsv.request_images(lenet, 4, seed=7)
    policy = tsv.BatchPolicy(max_batch=2, max_wait_s=0.0, max_depth=2)
    engine = tsv.VTAServingEngine(lenet, policy=policy, device="cpu")
    t0 = engine.submit(images[0])
    t1 = engine.submit(images[1])
    with pytest.raises(tsv.QueueFull) as exc:
        engine.submit(images[2])
    assert exc.value.depth == 2 and exc.value.max_depth == 2
    assert engine.metrics.rejected == 1
    with engine:
        np.testing.assert_array_equal(
            t0.result(timeout=60.0),
            lenet.serve([images[0]], device="cpu")[0][0])
        t1.result(timeout=60.0)
    assert engine.metrics.drained() and engine.metrics.audit() == []


def test_shutdown_drains_in_flight_requests(lenet):
    images = tsv.request_images(lenet, 6, seed=8)
    engine = tsv.VTAServingEngine(
        lenet, policy=tsv.BatchPolicy(max_batch=4, max_wait_s=0.05),
        backends=("cuda", "cuda"), device="cpu")
    tickets = [engine.submit(img) for img in images]
    engine.start()
    engine.shutdown(drain=True)
    assert all(t.done() for t in tickets)
    direct, _ = lenet.serve(images, device="cpu")
    np.testing.assert_array_equal(
        np.stack([t.result() for t in tickets]), direct)
    with pytest.raises(tsv.QueueClosed):
        engine.submit(images[0])
    engine.shutdown()                         # idempotent
    assert not any(t.is_alive() for t in engine._threads)


def test_shutdown_without_drain_cancels_typed(lenet):
    images = tsv.request_images(lenet, 3, seed=9)
    engine = tsv.VTAServingEngine(
        lenet, policy=tsv.BatchPolicy(max_batch=8, max_wait_s=10.0),
        device="cpu")
    tickets = [engine.submit(img) for img in images]
    engine.start()
    engine.shutdown(drain=False, timeout=60.0)
    resolved = 0
    for t in tickets:
        try:
            t.result(timeout=60.0)
            resolved += 1                     # a worker may have grabbed it
        except tsv.QueueClosed:
            pass
    assert engine.metrics.cancelled + resolved == len(tickets)
    assert engine.metrics.drained()


@pytest.mark.parametrize("kw,exc_type,constraint", [
    (dict(backends=("weird",)), CompileError, "serve-backend"),
    (dict(backends=("batched",)), CompileError, "serve-backend"),
    (dict(backends=("cuda", "pallas")), CompileError, "serve-backend"),
    (dict(backends=("fast",)), CompileError, "serve-backend"),
    (dict(backends=()), ValueError, None),
    (dict(guard=object()), CompileError, "serve-guard-backend"),
    (dict(backends=("cuda", "cuda"), guard=object()), CompileError,
     "serve-guard-backend"),
])
def test_engine_refusals_are_typed(lenet, kw, exc_type, constraint):
    with pytest.raises(exc_type) as exc:
        tsv.VTAServingEngine(lenet, device="cpu", **kw)
    assert getattr(exc.value, "constraint", None) == constraint
    if constraint == "serve-guard-backend":
        assert "numpy interpreter" in str(exc.value)


def test_engine_rejects_mis_shaped_request(lenet):
    engine = tsv.VTAServingEngine(lenet, device="cpu")
    with pytest.raises(ValueError, match="signature"):
        engine.submit(np.zeros((1, 3, 32, 32), np.int8))
    assert engine.metrics.submitted == 0


class _ExplodingNet:
    """A NetworkProgram stand-in whose serve always raises — the engine's
    failure path (a kernel error, a sticky device fault) without a net."""

    def input_signature(self):
        return ((1, 8, 8), np.dtype(np.int8))

    def padded_batch_sizes(self, max_batch):
        return tsv.pad_ladder(max_batch)

    def serve(self, images, backend="cuda", device=None):
        raise RuntimeError("boom")


def test_execution_failure_resolves_tickets_typed():
    engine = tsv.VTAServingEngine(
        _ExplodingNet(), policy=tsv.BatchPolicy(max_batch=2, max_wait_s=0.0),
        backends=("cuda", "cuda"), device="cpu", warmup=False)
    with engine:
        tickets = [engine.submit(np.zeros((1, 8, 8), np.int8))
                   for _ in range(3)]
        for ticket in tickets:
            with pytest.raises(tsv.ServingError, match="boom") as exc:
                ticket.result(timeout=60.0)
            assert isinstance(exc.value.__cause__, RuntimeError)
    assert engine.metrics.failed == 3
    assert engine.metrics.drained() and engine.metrics.audit() == []


def test_engine_start_is_single_shot_and_result_times_out(lenet):
    engine = tsv.VTAServingEngine(lenet, device="cpu", warmup=False)
    ticket = engine.submit(tsv.request_images(lenet, 1, seed=13)[0])
    with pytest.raises(TimeoutError):         # no workers started yet
        ticket.result(timeout=0.01)
    engine.start()
    ticket.result(timeout=60.0)
    with pytest.raises(RuntimeError, match="started"):
        engine.start()
    engine.shutdown()


# ---------------------------------------------------------------------------
# The launch counters stay exact when worker threads launch at once
# ---------------------------------------------------------------------------

def test_launch_counters_exact_under_threads():
    """Many threads count at once, with the interpreter switching threads
    as often as it can: no increment is lost."""
    threads, each = 16, 2000
    interval = sys.getswitchinterval()
    tops.reset_launches()

    def work():
        for _ in range(each):
            tops._count_launch()
            tflash._count_launches(2)

    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert tops.launches == threads * each
    assert tops.attention_launches == 2 * threads * each
    tops.reset_launches()
    assert tops.launches == 0 and tops.attention_launches == 0
