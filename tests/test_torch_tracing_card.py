"""The port's spans on a card: resnet8 served at 8,192 images under the
profiler.  Every device operation launched inside a ``serve`` call is
launched inside a leaf span, and each leaf kind's event-timed device time
agrees with the device time its spans enclose on the profiler's trace.

A span's events are stamps in its stream.  The opening one passes when
the stream has finished what came before it, or when the host records
it, whichever is later; the closing one when the span's last operation
has finished, or when the host records it.  So a span's event time is
its operations' device time plus the stream's gaps before and between
them (a launch's few microseconds where the host runs ahead, as in every
layer's span) plus the time the host held the device inside the span
(``serve.input``'s pageable copy, which the host readies while the
device waits; ``serve.output``'s synchronising copy, after which the host
records the closing event on an idle device).  The test rebuilds each
span's window so from the trace: the operations it launched, and its
opening and closing on the host.

Every test here is marked ``cuda``: it decides inside the test whether a
CUDA card is present and skips on a host without one.  The module imports
no ``jax``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing_card.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing                                 # noqa: E402
from repro_torch.models import resnet8 as t8                    # noqa: E402

BATCH = 8192
NOT_LEAVES = ("repro_torch.serve", "repro_torch.layer")


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_device_operations_fall_in_leaf_spans(tmp_path):
    dev = _card()
    net, _ = t8.compile_resnet8()
    rng = np.random.default_rng(8192)
    images = rng.integers(-64, 64, (BATCH, 3, 32, 32),
                          dtype=np.int64).astype(np.int8)
    plain, _ = net.serve(images, device=dev)        # builds and warms
    tracing.clear()
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        out, _ = net.serve(images, device=dev)
    np.testing.assert_array_equal(out, plain)
    snap = tracing.snapshot()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ops = tracing.attribute(events)
    inside = [o for o in ops if o["in_serve"]]
    assert len(inside) > 10 * len(net.layers)
    stray = [(o["name"], o["span"]) for o in inside
             if o["span"] is None or o["span"] in NOT_LEAVES]
    assert stray == []
    by_ops = {}
    for o in inside:
        by_ops[o["span"]] = by_ops.get(o["span"], 0.0) + o["dur"] / 1e3
    early, late = windows(events, inside, 0.0), windows(events, inside, 1.0)
    by_events = {}
    for s in snap["spans"]:
        if s["name"] not in NOT_LEAVES:
            by_events[s["name"]] = (by_events.get(s["name"], 0.0)
                                    + s["device_ms"])
    assert set(by_ops) <= set(by_events) == set(early) == set(late)
    for kind, ms in sorted(by_events.items()):
        print(f"{kind}: operations {by_ops.get(kind, 0.0):.4f} ms, window "
              f"{early[kind]:.4f}-{late[kind]:.4f} ms, events {ms:.4f} ms")
    for kind, ms in by_events.items():
        assert 0.95 * early[kind] <= ms <= 1.05 * late[kind], kind


def windows(events, inside, edge):
    """Device ms of each leaf kind as its spans' events would read it,
    rebuilt from the trace: a leaf span's window opens when the stream
    has finished the span before it or when the host has recorded the
    opening event (its first ``cudaEventRecord`` call), whichever is
    later, and closes when its last operation has finished or when the
    host has recorded the closing event (its last such call), whichever
    is later.  The device stamps an event somewhere inside the call that
    records it: ``edge`` 0 takes the call's start, 1 its end."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    tid = next(e["tid"] for e in xs if e.get("cat") == "user_annotation"
               and e["name"] == tracing.ROOT)
    leaves = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in xs
                    if e.get("tid") == tid
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith(tracing.PREFIX)
                    and e["name"] not in NOT_LEAVES)
    records = sorted(float(e["ts"]) + edge * float(e["dur"]) for e in xs
                     if e.get("tid") == tid
                     and e.get("cat") in tracing.RUNTIME_CATS
                     and e["name"].startswith("cudaEventRecord"))
    ends = {}
    for o in inside:
        end = o["ts"] + o["dur"]
        ends[o["span_ts"]] = max(ends.get(o["span_ts"], end), end)
    out, closed = {}, None
    for a, b, name in leaves:
        stamps = [r for r in records if a <= r <= b]
        opened = stamps[0] if closed is None else max(closed, stamps[0])
        closed = max(ends.get(a, opened), stamps[-1])
        out[name] = out.get(name, 0.0) + (closed - opened) / 1e3
    return out
