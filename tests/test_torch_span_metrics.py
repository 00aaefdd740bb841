"""The seven span readers of ``tools/span_metrics.py`` on the CPU: over the
port's own spans of small traced calls (the CPU has no device time, so the
device readers stay silent there), over a span log written by hand, and
silent wherever the record or the log holds nothing to read."""

import pathlib
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

import span_metrics  # noqa: E402
from perfbench.lib import manifest, seeds, trace, traffic  # noqa: E402

SEED = 3_000_000_019
READERS = span_metrics.READERS
DEVICE_READERS = ("copy_device_ms_per_kimg", "stack_clone_device_ms_per_kimg",
                  "stage_device_ms_per_kimg", "codec_device_ms_per_kimg",
                  "epilogue_device_ms_per_kimg")
# INP + RES and OUT an image, read off the compiled regions (the stack is
# allocated, not a copy of the DRAM image)
STACK_BYTES = {"resnet8.offline": 636_992 + 90_128,
               "lenet5.offline": 43_632 + 14_576}


def test_the_seven_readers():
    assert set(READERS) == set(DEVICE_READERS) | {
        "serve_host_ms_per_call", "stack_bytes_per_image"}


def _traced_record(name, calls=2, batch=3):
    """A traced record of ``calls`` small serves on the CPU, with one
    stand-in device operation (the CPU's trace has none)."""
    from repro_torch import tracing
    cell = manifest.load_cell(name, ROOT)
    cfg = cell.config
    program = cell.program().compile(cfg, seeds.weights(cfg, SEED),
                                     traffic.calibration_images(cfg, SEED))
    pool = traffic.pool(cfg, cell.traffic, SEED, batch)
    tracing.clear()
    tr = trace.profile(lambda i: program.serve(pool[i % len(pool)],
                                               device="cpu"), calls)
    assert tr["device"] == []
    tr.update(device=[("kernel", 0.0, 1.0, "kernel")], calls=calls,
              images=calls * batch, launches=0)
    return {"config": cfg, "batch": batch, "trace": tr}


@pytest.mark.parametrize("name", sorted(STACK_BYTES))
def test_readers_over_the_ports_spans(name):
    rec = _traced_record(name)
    read = {m: f(rec) for m, f in READERS.items()}
    assert read["stack_bytes_per_image"] == STACK_BYTES[name]
    assert 0 < read["serve_host_ms_per_call"] < 60_000
    for m in DEVICE_READERS:                        # no event time here
        assert read[m] is None, m
    # a log that holds another number of calls than the record: silent
    rec["trace"]["calls"] += 1
    assert all(f(rec) is None for f in READERS.values())


def _span(i, name, parent, call, t0, t1, ms=None, /, **attrs):
    return {"name": name, "id": i, "call": call, "parent": parent,
            "thread": 1, "start_ns": t0, "end_ns": t1, "device_ms": ms,
            "attrs": attrs}


@pytest.mark.parametrize("decode", [True, False])
def test_readers_by_hand(monkeypatch, decode):
    """Two calls' spans written by hand: with a ``layer.decode`` span (a
    tree from before the operand gather) and without (the gather stages
    the operand, so nothing decodes INP)."""
    from repro_torch import tracing
    log = []
    for c, base in ((1, 0), (20, 10_000_000)):
        at = lambda ms: base + int(ms * 1e6)
        log += [
            _span(c, "repro_torch.serve", None, c, at(0), at(9), 8.0,
                  batch=4, backend="cuda"),
            _span(c + 1, "repro_torch.serve.input", c, c, at(0), at(1), 0.5,
                  bytes=4),
            _span(c + 2, "repro_torch.serve.stack", c, c, at(1), at(2), 1.0,
                  bytes=400),
            _span(c + 3, "repro_torch.layer", c, c, at(2), at(6), 3.0, k=0,
                  name="l"),
            _span(c + 4, "repro_torch.layer.stage", c + 3, c, at(2), at(3),
                  0.25, bytes=40),
            _span(c + 5, "repro_torch.layer.decode", c + 3, c, at(3), at(4),
                  0.5),
            _span(c + 6, "repro_torch.layer.gemm", c + 3, c, at(4), at(5),
                  1.0),
            _span(c + 7, "repro_torch.layer.epilogue", c + 3, c, at(5),
                  at(5.5), 0.75),
            _span(c + 8, "repro_torch.layer.encode", c + 3, c, at(5.5),
                  at(5.7), 0.125, bytes=8),
            _span(c + 9, "repro_torch.layer.unpack", c + 3, c, at(5.7),
                  at(6), 0.375),
            _span(c + 10, "repro_torch.serve.output", c, c, at(6), at(8.5),
                  0.25, bytes=40)]
        if not decode:
            log = [s for s in log if s["name"] != "repro_torch.layer.decode"]
    # a span of another, untraced thread's call outside a serve
    log.append(_span(99, "repro_torch.layer.gemm", None, 99, 0, 1, 7.0))
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: {"spans": log, "dropped": 0,
                                 "capacity": tracing.CAPACITY})
    rec = {"trace": {"spans": [(0.0, 1.0)], "device": [("k", 0, 1, "k")],
                     "waits": [], "host": [], "calls": 3, "images": 8,
                     "launches": 0}}
    assert all(f(rec) is None for f in READERS.values())
    rec["trace"]["calls"] = 2
    read = lambda m: READERS[m](rec)
    kimg = 8 / 1e3
    assert read("copy_device_ms_per_kimg") == pytest.approx(2 * 0.75 / kimg)
    assert read("stack_clone_device_ms_per_kimg") == pytest.approx(2 / kimg)
    assert read("stage_device_ms_per_kimg") == pytest.approx(0.5 / kimg)
    assert read("codec_device_ms_per_kimg") == pytest.approx(
        (2 if decode else 1) / kimg)
    assert read("epilogue_device_ms_per_kimg") == pytest.approx(1.5 / kimg)
    assert read("serve_host_ms_per_call") == pytest.approx(9 - 2.5)
    assert read("stack_bytes_per_image") == (400 + 40 + 8) * 2 / 8


def test_readers_return_nothing_without_a_device_trace():
    """The record of ``perfbench/tests/test_perfbench_arith.py``'s test of
    the same name."""
    rec = {"config": manifest.load_json(
               ROOT / "perfbench" / "configs" / "lenet5.json"),
           "batch": 4, "compile_s": 0.1,
           "window": {"seconds": 1.0, "calls": 3, "images": 12},
           "device": {"kind": "cpu"},
           "trace": {"spans": [(0.0, 1.0)], "device": [], "waits": [],
                     "host": [], "calls": 1, "images": 4, "launches": 0}}
    for name, read in READERS.items():
        assert read(rec) is None, name
    assert READERS["stack_bytes_per_image"]({"trace": None}) is None


def test_readers_are_silent_on_a_port_without_spans(monkeypatch):
    """A port without ``repro_torch.tracing``: the readers then read
    nothing and raise nothing."""
    import repro_torch
    rec = _traced_record("lenet5.offline", calls=1, batch=2)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert span_metrics.traced_spans(rec) is None
    assert all(f(rec) is None for f in READERS.values())
