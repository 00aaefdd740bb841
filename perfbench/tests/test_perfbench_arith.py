"""The yardstick's arithmetic on shapes worked by hand: GEMM shapes and
multiply-accumulates, the roofline bound, ``mfu``, the percentile and the
trace's reduction."""

import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import (check, harness, manifest, peaks, shapes,  # noqa: E402
                           trace)

H100 = "NVIDIA H100 80GB HBM3"


def _config(name):
    return manifest.load_json(ROOT / "perfbench" / "configs" / f"{name}.json")


def _metric(name):
    return manifest.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py")


def test_macs_per_image_by_hand():
    # resnet8: stem 1024·27·16, b1 2 × 1024·144·16, t2a 256·144·32,
    # t2p 256·64·32, t2b 256·288·32, t3a 64·288·64, t3p 64·128·64,
    # t3b 64·576·64, head 64·64·64, fc 64·10
    assert shapes.macs_per_image(_config("resnet8")) == 13_550_208
    # LeNet-5: 784·25·6 + 100·150·16 + 400·120 + 120·84 + 84·10
    assert shapes.macs_per_image(_config("lenet5")) == 416_520


def test_gemm_shapes_by_hand():
    g = {n: (m, k, nn) for n, m, k, nn in shapes.gemms(_config("resnet8"), 8)}
    assert g["stem"] == (8 * 32 * 32, 27, 16)
    assert g["t2p"] == (8 * 16 * 16, 64, 32)
    assert g["t3b"] == (8 * 8 * 8, 576, 64)
    assert g["fc"] == (8, 64, 10)
    g = {n: (m, k, nn) for n, m, k, nn in shapes.gemms(_config("lenet5"), 2)}
    assert g["conv1"] == (2 * 28 * 28, 25, 6)
    assert g["conv3"] == (2, 400, 120)


def test_roofline_bound_by_hand():
    peak = peaks.peak(H100)
    roof = _metric("vta_gemm_roofline")
    # bytes-bound: 1024·32 + 32·16 + 4·16 + 1024·16 bytes at 3.35 TB/s
    assert roof.bound_s(1024, 32, 16, peak) == pytest.approx(
        (32768 + 512 + 64 + 16384) / 3.35e12)
    # operations-bound: 2·4096³ at 1,979 TOP/s
    assert roof.bound_s(4096, 4096, 4096, peak) == pytest.approx(
        2 * 4096 ** 3 / 1.979e15)


def _trace():
    """Two calls: spans [0, 100] and [110, 200] µs; kernels and copies
    on the device; a copy to the host the host waited in."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
         "ts": 110, "dur": 90},
        {"ph": "X", "cat": "cpu_op", "name": "aten::clone", "ts": 2,
         "dur": 6, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 3,
         "dur": 4, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 4, "dur": 1, "tid": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "void vta_gemm_kernel<64, 16>"
         "(signed char const*)", "ts": 10, "dur": 20,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 25,
         "dur": 25},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pageable)", "ts": 90, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 60, "dur": 36, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 55,
         "dur": 42},
        {"ph": "X", "cat": "kernel", "name": "void vta_gemm_kernel<64, 16>"
         "(signed char const*)", "ts": 120, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 150, "dur": 40},
        {"ph": "i", "cat": "kernel", "name": "ignored", "ts": 0},
    ]
    tr = trace.reduce(ev)
    tr.update(calls=2, images=2 * 8, launches=22)
    return tr


def test_trace_reduction_by_hand():
    tr = _trace()
    assert trace.window(tr) == (0.0, 200.0)
    # busy: [10, 50] ∪ [90, 95] ∪ [120, 150] = 40 + 5 + 30
    assert trace.busy_us(tr) == 75.0
    assert trace.device_us(tr, lambda n: "vta_gemm" in n) == 50.0
    gaps = trace.idle_gaps(tr)
    assert [round(s * 1e6) for _, s in gaps] == [50, 40, 25, 10]
    # the longest gap, [150, 200], has cudaStreamSynchronize at its middle
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[1][0] == "cudaMemcpyAsync"      # [50, 90]: inside the copy
    assert gaps[3][0] == "cudaLaunchKernel"     # [0, 10]: the launch at 5
    top = trace.top_device_ops(tr)
    # the first launch is labelled by the outermost op that launched it
    assert top[0][0] == "vta_gemm_kernel" and top[1][0] == "elementwise"
    assert top[0][1] == pytest.approx(30e-6)
    assert top[2] == ["aten::clone > vta_gemm_kernel", pytest.approx(20e-6)]
    assert trace.short_kernel(
        "void at::native::elementwise_kernel<128, 4, f<(signed char)>>"
        "(int, f)") == "at::native::elementwise_kernel"
    assert trace.short_kernel(
        "void (anonymous namespace)::elementwise_kernel_with_index<int, f>"
        "(int, f)") == "(anonymous)::elementwise_kernel_with_index"
    assert trace.short_kernel("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_readers_by_hand():
    tr = _trace()
    rec = {"config": _config("resnet8"), "batch": 8, "compile_s": 1.5,
           "window": {"seconds": 2.0, "calls": 10, "images": 80},
           "device": {"kind": H100}, "trace": tr}
    read = lambda m: _metric(m).read(rec)
    assert read("compile_s") == 1.5
    assert read("idle_share") == pytest.approx(100 * (1 - 75 / 200))
    assert read("vta_gemm_launches_per_call") == 11
    # (100 - 36) + (90 - 40) µs of host time outside the waits, 2 calls
    assert read("host_ms_per_call") == pytest.approx(0.057)
    # 25 + 5 µs of device time that is not vta_gemm, over 16 images
    assert read("staging_device_ms_per_kimg") == pytest.approx(
        0.030 / 0.016)
    bound = sum(_metric("vta_gemm_roofline").bound_s(m, k, n, peaks.peak(H100))
                for _, m, k, n in shapes.gemms(rec["config"], 8))
    assert read("vta_gemm_roofline") == pytest.approx(
        100 * 2 * bound / 50e-6)
    assert read("mfu") == pytest.approx(
        100 * 2 * 13_550_208 * 80 / 2.0 / 1.979e15)


def test_readers_return_nothing_without_a_device_trace():
    rec = {"config": _config("lenet5"), "batch": 4, "compile_s": 0.1,
           "window": {"seconds": 1.0, "calls": 3, "images": 12},
           "device": {"kind": "cpu"},
           "trace": {"spans": [(0.0, 1.0)], "device": [], "waits": [],
                     "host": [], "calls": 1, "images": 4, "launches": 0}}
    for name in ("host_ms_per_call", "staging_device_ms_per_kimg",
                 "vta_gemm_launches_per_call", "vta_gemm_roofline",
                 "idle_share", "mfu"):
        assert _metric(name).read(rec) is None, name


def test_compare_counts_missing_answers_as_wrong():
    ref = np.zeros((4, 10), np.int8)
    good, short = ref.copy(), ref[:2]
    bad = ref.copy()
    bad[1, 3] = 5
    numbers = check.compare([(0, good), (0, bad), (0, short)], [ref])
    assert numbers == {"mismatched_logits": 1 + 40,
                       "max_abs_logit_diff": 255, "failed_images": 1 + 4,
                       "images": 12}
    assert check.judge(numbers, {"mismatched_logits": 0}) == (
        False, {"mismatched_logits": {"value": 41, "limit": 0}})


def test_nearest_rank():
    values = [float(v) for v in range(1, 101)]
    assert harness.nearest_rank(values, 95) == 95.0
    assert harness.nearest_rank(values[:10], 95) == 10.0
    assert harness.nearest_rank([3.0], 95) == 3.0


def _server_rec(tr=None):
    """Four requests due in the window, served in two batches by one
    worker: batch A (3 real rows padded to 4) dispatched at 10.0, batch B
    (1 of 1) at 10.5; times in seconds."""
    req = {"due": np.array([9.000, 9.001, 9.002, 10.400]),
           "enqueue": np.array([9.001, 9.003, 9.002, 10.410]),
           "dispatch": np.array([10.0, 10.0, 10.0, 10.5]),
           "complete": np.array([10.2, 10.2, 10.2, 10.6]),
           "batch": np.array([3, 3, 3, 1]),
           "padded": np.array([4, 4, 4, 1]),
           "worker": np.array([0, 0, 0, 0])}
    return {"config": _config("resnet8"), "batch": None, "compile_s": 0.7,
            "window": {"seconds": 2.0, "calls": 4, "images": 4000},
            "device": {"kind": H100}, "requests": req, "trace": tr}


def test_server_readers_by_hand():
    read = lambda m: _metric(m).read(_server_rec())
    # nearest rank p95 of four values is the largest
    assert read("queue_wait_p95_ms") == pytest.approx(999.0)
    assert read("service_p95_ms") == pytest.approx(200.0)
    assert read("admission_p95_ms") == pytest.approx(10.0)
    # batch A 3/4 and batch B 1/1, each once
    assert read("batch_fill") == pytest.approx(100 * (0.75 + 1.0) / 2)
    assert read("mfu") == pytest.approx(
        100 * 2 * 13_550_208 * 4000 / 2.0 / 1.979e15)
    for name in ("queue_wait_p95_ms", "service_p95_ms", "admission_p95_ms",
                 "batch_fill"):
        assert _metric(name).read({"trace": None}) is None, name


def test_idle_share_reads_a_server_trace():
    """The server's traced stretch is one span on the harness's thread;
    the device operations come from the engine's worker, whose host
    operations the profiler may not record: the share is still the span
    less the union of the device's intervals."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": "vta_gemm_kernel",
           "ts": 100, "dur": 100, "tid": 7, "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 150,
           "dur": 100, "tid": 7},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 990,
           "dur": 50, "tid": 7}]
    tr = trace.reduce(ev)
    assert _metric("idle_share").read(_server_rec(tr)) == pytest.approx(
        100 * (1 - (150 + 10) / 1000))

def test_a_trace_without_kernels_fails_a_run_on_the_card(monkeypatch):
    """A traced stretch on the card always launches kernels: one whose
    trace holds copies and no kernel has lost the device's records, and
    the run fails rather than read an idle share from the copies."""
    import torch
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 990,
           "dur": 50, "tid": 7}]
    lost = trace.reduce(ev)
    monkeypatch.setattr(trace, "profile", lambda call, calls: dict(lost))
    with pytest.raises(RuntimeError, match="no kernel"):
        harness._traced(None, 1, torch.device("cuda"))
    assert harness._traced(None, 1, torch.device("cpu"))["device"]
    kept = trace.reduce(ev + [{"ph": "X", "cat": "kernel", "name": "k",
                               "ts": 100, "dur": 10, "tid": 7}])
    monkeypatch.setattr(trace, "profile", lambda call, calls: dict(kept))
    assert len(harness._traced(None, 1, torch.device("cuda"))["device"]) == 2
