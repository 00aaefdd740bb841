"""The port's spans (``repro_torch.tracing``) around ``NetworkProgram.serve``
on the CPU: the tree and its order, the bytes each span wrote, nothing
recorded without a profiler, calls kept apart across threads, and every
span in the profiler's exported trace.  On the card,
``tests/test_torch_tracing_card.py`` holds the spans' device times and the
device operations each encloses."""

import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing                                 # noqa: E402
from repro_torch.core.cuda_backend import plan_cuda             # noqa: E402
from repro_torch.lenet5_e2e import compile_lenet5, request_images  # noqa: E402
from repro_torch.models import resnet8 as t8                    # noqa: E402

BATCH = 3
LEAVES = ("repro_torch.layer.stage", "repro_torch.layer.decode",
          "repro_torch.layer.gemm", "repro_torch.layer.epilogue",
          "repro_torch.layer.encode", "repro_torch.layer.unpack")
# the layers plan_cuda leaves to the TensorAlu epilogue
UNFUSED = {"resnet8": ["b1b", "t2b", "t3b", "head"],
           "lenet5": ["l1_conv", "l2_conv"]}


@pytest.fixture(scope="module")
def nets():
    net8, _ = t8.compile_resnet8()
    images8 = np.stack([t8.synthetic_image(s) for s in range(BATCH)])
    _, net5 = compile_lenet5()
    return {"resnet8": (net8, images8),
            "lenet5": (net5, request_images(BATCH))}


def _traced(net, images, **kw):
    tracing.clear()
    with torch.profiler.profile() as prof:
        out, _ = net.serve(images, device="cpu", **kw)
    return out, tracing.snapshot(), prof


def expected_names(net):
    names = ["repro_torch.serve", "repro_torch.serve.input",
             "repro_torch.serve.stack"]
    for layer in net.layers:
        names.append("repro_torch.layer")
        names += [n for n in LEAVES if n != "repro_torch.layer.epilogue"
                  or not plan_cuda(layer.program).fused]
    return names + ["repro_torch.serve.output"]


@pytest.mark.parametrize("model", ["resnet8", "lenet5"])
def test_span_tree_and_order(nets, model):
    net, images = nets[model]
    out, snap, _ = _traced(net, images)
    spans = snap["spans"]
    assert snap["dropped"] == 0
    assert [s["name"] for s in spans] == expected_names(net)
    assert [l.spec.name for l in net.layers
            if not plan_cuda(l.program).fused] == UNFUSED[model]
    root = spans[0]
    assert root["parent"] is None and root["call"] == root["id"]
    assert root["attrs"] == {"backend": "cuda", "batch": BATCH}
    by_id = {s["id"]: s for s in spans}
    layers = [s for s in spans if s["name"] == "repro_torch.layer"]
    assert [(s["attrs"]["k"], s["attrs"]["name"]) for s in layers] == [
        (k, l.spec.name) for k, l in enumerate(net.layers)]
    for s in spans[1:]:
        parent = by_id[s["parent"]]
        assert s["call"] == root["id"]
        want = ("repro_torch.layer" if s["name"] in LEAVES
                else "repro_torch.serve")
        assert parent["name"] == want, s["name"]
        # a child lies inside its parent on the host clock
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]
        assert s["device_ms"] is None               # no card: no event time
    # the spans leave the answers as they were
    plain, _ = net.serve(images, device="cpu")
    np.testing.assert_array_equal(out, plain)


@pytest.mark.parametrize("model", ["resnet8", "lenet5"])
def test_bytes_are_the_regions_written(nets, model):
    net, images = nets[model]
    _, snap, _ = _traced(net, images)
    spans = snap["spans"]
    got = lambda name: [s["attrs"]["bytes"] for s in spans
                        if s["name"] == name]
    res = [r.get("res") for r in (l.program.regions for l in net.layers)]
    assert got("repro_torch.serve.input") == [images.size]
    assert got("repro_torch.serve.stack") == [
        BATCH * net.allocator.image_size()]
    assert got("repro_torch.layer.stage") == [
        BATCH * (l.program.regions["inp"].nbytes
                 + (r.nbytes if r is not None else 0))
        for l, r in zip(net.layers, res)]
    assert got("repro_torch.layer.encode") == [
        BATCH * l.program.regions["out"].nbytes for l in net.layers]
    last = net.layers[-1].program.output_meta.valid_shape
    assert got("repro_torch.serve.output") == [BATCH * last[0] * last[1]]


@pytest.mark.parametrize("model", ["resnet8", "lenet5"])
def test_nothing_recorded_without_a_profiler(nets, model):
    net, images = nets[model]
    tracing.clear()
    net.serve(images, device="cpu")
    assert tracing.span("repro_torch.serve") is tracing.NOOP
    assert tracing.snapshot() == {"spans": [], "dropped": 0,
                                  "capacity": tracing.CAPACITY}


def test_two_threads_keep_their_calls_apart(nets):
    net, images = nets["lenet5"]
    tracing.clear()
    start = threading.Barrier(2)
    errors = []

    def serve():
        try:
            start.wait(timeout=30)
            for _ in range(3):
                net.serve(images, device="cpu")
        except Exception as e:                      # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with torch.profiler.profile():
            workers = [threading.Thread(target=serve) for _ in range(2)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers) and not errors
    spans = tracing.snapshot()["spans"]
    roots = [s for s in spans if s["name"] == "repro_torch.serve"]
    assert len(roots) == 6 and len({s["call"] for s in roots}) == 6
    assert len({s["thread"] for s in roots}) == 2
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["thread"] == s["thread"]
            assert parent["call"] == s["call"]
    per_call = {}
    for s in spans:
        per_call.setdefault(s["call"], []).append(s["name"])
    assert all(names == expected_names(net) for names in per_call.values())


@pytest.mark.parametrize("model", ["resnet8", "lenet5"])
def test_every_span_is_an_annotation_of_the_trace(nets, model, tmp_path):
    net, images = nets[model]
    _, snap, prof = _traced(net, images)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = [e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith(tracing.PREFIX)]
    names = [s["name"] for s in snap["spans"]]
    assert sorted(marks) == sorted(names)


def test_log_is_bounded_and_read_without_clearing():
    log = tracing.SpanLog(capacity=3)
    with torch.profiler.profile():
        with log.span("repro_torch.serve", batch=1):
            for k in range(4):
                with log.span("repro_torch.layer", k=k) as s:
                    s.set(bytes=k)
    snap = log.snapshot()
    assert [s["name"] for s in snap["spans"]] == [
        "repro_torch.serve", "repro_torch.layer", "repro_torch.layer"]
    assert snap["dropped"] == 2 and snap["capacity"] == 3
    assert [s["attrs"] for s in snap["spans"][1:]] == [
        {"k": 0, "bytes": 0}, {"k": 1, "bytes": 1}]
    assert log.snapshot() == snap
    log.clear()
    assert log.snapshot()["spans"] == []
    with pytest.raises(ValueError, match="repro_torch"):
        with torch.profiler.profile():
            log.span("serve")


def test_attribute_puts_operations_down_to_the_innermost_span():
    x = lambda cat, name, ts, dur, tid=1, **args: {
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
        "tid": tid, "args": args}
    events = [
        x("user_annotation", "repro_torch.serve", 0, 100),
        x("user_annotation", "repro_torch.layer", 10, 50),
        x("user_annotation", "repro_torch.layer.gemm", 20, 10),
        x("user_annotation", "perfbench.serve", 0, 200),
        x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
        x("cuda_runtime", "cudaMemcpyAsync", 150, 1, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 30, 1, tid=2, correlation=4),
        x("kernel", "vta_gemm_kernel", 300, 5, tid=7, correlation=1),
        x("kernel", "elementwise_kernel", 305, 3, tid=7, correlation=2),
        x("gpu_memcpy", "Memcpy DtoH", 310, 2, tid=7, correlation=3),
        x("kernel", "other", 312, 1, tid=7, correlation=4)]
    got = [(o["name"], o["span"], o["span_ts"], o["in_serve"])
           for o in tracing.attribute(events)]
    assert got == [("vta_gemm_kernel", "repro_torch.layer.gemm", 20, True),
                   ("elementwise_kernel", "repro_torch.layer", 10, True),
                   ("Memcpy DtoH", None, None, False),
                   ("other", None, None, False)]
