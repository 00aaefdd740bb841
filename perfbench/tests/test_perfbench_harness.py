"""A run of the harness on the CPU, small: sound, it comes out correct;
with the timed path broken underneath, or with the lower-precision control
in the program's place, it comes out not correct.  And a cell is added
with new files and a new entry alone."""

import json
import pathlib
import shutil
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import check, harness, manifest, seeds, traffic  # noqa: E402

SEED = 3_000_000_017


def _run(name, root=ROOT, trace_on=False, batch=6):
    cell = manifest.load_cell(name, root)
    return harness.run_cell(cell, SEED, 0.05, trace_on, "cpu",
                            images_per_call=batch)


@pytest.mark.parametrize("name", ["resnet8.offline", "lenet5.offline"])
def test_sound_run_is_correct(name):
    result, lines = _run(name)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] % 6 == 0 and result["attempted"] >= 6
    assert list(result)[-1] == "check"
    assert set(result["metrics"]) == {"images_per_s", "batch_latency_p95_ms",
                                      "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert lines[-2:] == ["mismatched_logits 0 limit 0",
                          "max_abs_logit_diff 0 limit 0"]
    assert lines[0].startswith("setup_s by step: imports")
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics():
    result, _ = _run("lenet5.offline", trace_on=True)
    assert result["correct"] is True
    # the CPU has no device trace and no peak: only the host's metric
    assert set(result["metrics"]) == {"compile_s"}
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_altered_answer_is_caught(monkeypatch):
    from repro_torch.core import cuda_backend
    real = cuda_backend.kernel_ops.vta_matmul

    def altered(a, b, bias=None, **kw):
        out = real(a, b, bias, **kw)
        if b.shape[1] == 16 and out.shape[0] > 1:     # the fc layer's row
            out = out.clone()
            out[-1, 3] += 1
        return out

    monkeypatch.setattr(cuda_backend.kernel_ops, "vta_matmul", altered)
    result, lines = _run("lenet5.offline")
    assert result["correct"] is False and result["failed"] > 0
    assert result["check"]["mismatched_logits"]["value"] > 0


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.core.network_compiler import NetworkProgram
    real = NetworkProgram.serve

    def half(self, images, **kw):
        n = len(images)
        out, reports = real(self, images[: n // 2], **kw)
        return np.concatenate([out, out[: n - n // 2]]), reports

    monkeypatch.setattr(NetworkProgram, "serve", half)
    result, _ = _run("resnet8.offline")
    assert result["correct"] is False


def _control(cell):
    """The reference at int4 (every GEMM operand at 4 significant bits)
    in the program's place, against the reference, on 16 images."""
    cfg, ref = cell.config, cell.reference()
    weights = seeds.weights(cfg, SEED)
    calib = traffic.calibration_images(cfg, SEED)
    plan = ref.calibrate(cfg, weights, calib)
    pool = traffic.pool(cfg, dict(cell.traffic, pool_images=16), SEED,
                        images_per_call=16)
    refs = [ref.forward(cfg, weights, plan, p, "cpu") for p in pool]
    low = [(b, ref.forward(cfg, weights, plan, p, "cpu", bits=4))
           for b, p in enumerate(pool)]
    numbers = check.compare(low, refs)
    correct, shown = check.judge(numbers, cell.workload["limits"])
    assert not correct
    assert numbers["mismatched_logits"] > 0.5 * numbers["images"] * 10


@pytest.mark.parametrize("name", ["resnet8.offline", "lenet5.offline"])
def test_lower_precision_control_fails(name):
    """The int4 control reads far above the limit 0."""
    _control(manifest.load_cell(name, ROOT))


def test_lower_precision_control_fails_in_a_server_cell(server_root):
    _control(manifest.load_cell("resnet8.server", server_root))


def test_a_cell_is_added_by_files_and_an_entry_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    pb = tmp_path / "perfbench"
    (pb / "traffic" / "offline_4.json").write_text(json.dumps(
        {"kind": "offline", "images_per_call": 4, "pool_batches": 3}))
    entry = {"name": "lenet5.offline_4", "config": "lenet5",
             "traffic": "offline_4", "chips": 1,
             "why": "four digits a call, three batches in turn"}
    work = dict(json.loads(
        (pb / "workloads" / "lenet5.offline.json").read_text()), **entry)
    del work["name"]
    (pb / "workloads" / "lenet5.offline_4.json").write_text(json.dumps(work))
    bench["workloads"].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.load_cell("lenet5.offline_4", tmp_path)
    result, _ = harness.run_cell(cell, SEED, 0.05, False, "cpu")
    assert result["correct"] is True and result["attempted"] % 4 == 0
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "perfbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def _server_cell(root, **mix):
    """resnet8.server (in ``root``, the copy of ``conftest.server_root``) at
    a size the CPU serves: a pool of 16 images, batches of up to 8, a short
    warm-up and trace."""
    cell = manifest.load_cell("resnet8.server", root)
    policy = dict(cell.traffic["policy"], max_batch=8,
                  max_depth=mix.pop("max_depth", 1024))
    cell.traffic = dict(cell.traffic, **dict(
        dict(rate_per_s=60.0, pool_images=16, warmup_s=0.1), **mix),
        policy=policy)
    cell.workload = dict(cell.workload, trace_s=0.2,
                         reference_images_per_block=8)
    return cell


def _serve(cell, trace_on=False, seconds=0.4):
    return harness.run_cell(cell, SEED, seconds, trace_on, "cpu")


def test_same_seed_gives_the_same_schedule():
    a = traffic.arrivals(500.0, SEED, 3.0)
    assert np.array_equal(a, traffic.arrivals(500.0, SEED, 3.0))
    assert not np.array_equal(a[:100], traffic.arrivals(500.0, SEED + 1,
                                                        3.0)[:100])
    # a longer schedule of one seed begins with the shorter one
    longer = traffic.arrivals(500.0, SEED, 300.0)
    assert np.array_equal(longer[:len(a)], a) and longer[len(a)] >= 3.0
    assert np.all(np.diff(a) > 0) and 0 < a[0] and a[-1] < 3.0


def test_mean_rate_is_the_mix_rate():
    rate = 8000.0
    due = traffic.arrivals(rate, SEED, 2.0)[:10_000]
    assert len(due) == 10_000
    assert abs(len(due) / due[-1] / rate - 1) < 0.03


def test_the_generator_process_delivers_every_arrival_in_order():
    gen = traffic.Generator(2000.0, SEED, 0.5)
    try:
        n = gen.ready()
        t0 = time.perf_counter()
        gen.go(t0)
        rows = np.array([r for block in gen.messages() for r in block])
    finally:
        gen.close()
    assert gen.proc.returncode == 0
    due = traffic.arrivals(2000.0, SEED, 0.5)
    assert n == len(due) == len(rows) > 500
    np.testing.assert_array_equal(rows[:, 0], np.arange(n))
    np.testing.assert_allclose(rows[:, 1], due + t0, rtol=0, atol=1e-9)
    assert np.all(rows[:, 2] >= rows[:, 1])        # never sent early


def test_sound_server_run_is_correct(server_root):
    result, lines = _serve(_server_cell(server_root))
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == result["generator"]["sent"] > 10
    assert list(result)[-1] == "check"
    assert set(result["metrics"]) == {"images_per_s", "latency_p95_ms",
                                      "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert lines[-2:] == ["mismatched_logits 0 limit 0",
                          "max_abs_logit_diff 0 limit 0"]
    assert any(line.startswith("generator: ") for line in lines)
    json.dumps(result)


def test_traced_server_run_reports_the_engine_metrics(server_root):
    result, _ = _serve(_server_cell(server_root), trace_on=True)
    assert result["correct"] is True and result["failed"] == 0
    # the CPU has no device trace and no peak
    assert set(result["metrics"]) == {
        "compile_s", "admission_p95_ms", "queue_wait_p95_ms",
        "service_p95_ms", "batch_fill"}
    assert 0 < result["metrics"]["batch_fill"]["value"] <= 100
    assert result["device"]["window_s"] >= 0.2


def test_altered_answer_is_caught_in_a_server_run(monkeypatch, server_root):
    from repro_torch.core import cuda_backend
    real = cuda_backend.kernel_ops.vta_matmul
    cell = _server_cell(server_root)

    def altered(a, b, bias=None, **kw):
        out = real(a, b, bias, **kw)
        if b.shape[1] == 16 and out.shape[0] > 1:
            out = out.clone()
            out[-1, 3] += 1
        return out

    monkeypatch.setattr(cuda_backend.kernel_ops, "vta_matmul", altered)
    result, _ = _serve(cell)
    assert result["correct"] is False and result["failed"] > 0
    assert result["check"]["mismatched_logits"]["value"] > 0


def test_half_the_batch_left_out_is_caught_in_a_server_run(monkeypatch,
                                                           server_root):
    from repro_torch.core.network_compiler import NetworkProgram
    real = NetworkProgram.serve

    def half(self, images, **kw):
        n = len(images)
        out, reports = real(self, images[: max(1, n // 2)], **kw)
        return np.concatenate([out] * 2)[:n], reports

    monkeypatch.setattr(NetworkProgram, "serve", half)
    # arrivals faster than the CPU serves them, so batches hold several
    result, _ = _serve(_server_cell(server_root, rate_per_s=200.0))
    assert result["correct"] is False


def test_rejections_under_a_burst_count_as_failed(server_root):
    result, _ = _serve(_server_cell(server_root, rate_per_s=400.0,
                                    max_depth=1))
    assert result["failed"] > 0
    assert result["attempted"] == result["generator"]["sent"]
    # a rejection is backpressure, not a wrong answer
    assert result["correct"] is True
    assert result["check"]["mismatched_logits"]["value"] == 0
