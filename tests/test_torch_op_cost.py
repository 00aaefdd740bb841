"""The port's op counter (``repro_torch.analysis.op_cost``), the
counterpart of ``tests/test_hlo_cost.py``.

* The analytic cases of the reference's test: one matmul is 2·M·N·K; a
  matmul in a loop of L is L× that; nested loops multiply; bytes scale
  with loops.  On a fake process group of four ranks, a column-parallel
  then row-parallel product on a (1, 4) mesh has the per-device FLOPs of
  a quarter of each product and one all-reduce of the output, whose
  bytes and ring wire bytes are the formulas'; on 2×16×16, a sum over
  the ``pod`` axis is counted inter-pod and one over ``model`` is not.
* The meta trace against a real run: on four gloo ranks at (2, 2), the
  train step and the decode step of a dense (qwen2.5), an MoE with
  sliding windows (mixtral), a Mamba (jamba) and an RWKV-6 smoke config,
  and lm100m's training step with remat ``dots`` (the selective
  checkpoint the card's step runs), run for real on rank 0's CPU
  shards, equal the fake-process-group meta trace of rank 0 op for op:
  op, operand shapes and dtypes, FLOPs, bytes, fused bytes, collective
  kind, payload and group.  Both count every op (``all_devices``): on
  the CPU DTensor's own integer bookkeeping shares the step's device,
  while a meta or card trace leaves it out by device.

Every ``init_process_group`` runs in a subprocess (this file run as a
script).
"""

import os
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import op_cost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 240
TRACE_ARCHS = ["qwen2.5-3b", "mixtral-8x22b", "jamba-1.5-large-398b",
               "rwkv6-7b", "lm100m-dots"]


def _cost(fn, *args):
    _, tr = op_cost.trace(fn, *args)
    return op_cost.analyze_trace(tr, 1)


def test_single_matmul_flops():
    a, b = torch.randn(128, 256), torch.randn(256, 64)
    cost = _cost(lambda x, y: x @ y, a, b)
    assert cost["flops_per_device"] == 2 * 128 * 256 * 64
    assert cost["matmul_flops_per_device"] == 2 * 128 * 256 * 64
    assert cost["bytes_fused_per_device"] == 4 * (128 * 256 + 256 * 64
                                                  + 128 * 64)


def test_looped_matmul_multiplies_by_trip_count():
    x, w = torch.randn(64, 64), torch.randn(12, 64, 64)

    def f(h, ws):
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i])
        return h

    cost = _cost(f, x, w)
    assert cost["matmul_flops_per_device"] == 12 * 2 * 64 ** 3
    assert cost["flops_per_device"] == 12 * (2 * 64 ** 3 + 64 * 64)
    assert cost["unknown_trip_whiles"] == 0


def test_nested_loop_trip_counts():
    def f(h):
        for _ in range(3):
            for _ in range(5):
                h = h @ h
        return h

    cost = _cost(f, torch.randn(32, 32))
    assert cost["matmul_flops_per_device"] == 15 * 2 * 32 ** 3


def test_bytes_scale_with_loops():
    def f(h):
        for _ in range(10):
            h = h + 1.0
        return h

    cost = _cost(f, torch.randn(1024, 1024))
    assert cost["bytes_per_device"] == 10 * 2 * 1024 * 1024 * 4
    assert cost["bytes_fused_per_device"] == 0


def test_views_and_allocations_are_free():
    def f(x):
        y = x.view(64, 16).t().contiguous()
        return torch.empty_like(y)

    cost = _cost(f, torch.randn(1024))
    assert cost["bytes_per_device"] == 2 * 1024 * 4   # the one copy


def test_meta_trace_equals_cpu_trace():
    """The ``meta`` fast path (each op's result rebuilt from its last run
    with the same layouts) counts what a real run counts."""
    def f(x, w):
        h = x
        for _ in range(3):
            h = torch.softmax(h @ w, -1) * 2.0
            h = h + h                          # one operand twice
        return h.sum(0)

    args = (torch.randn(16, 32), torch.randn(32, 32))
    _, cpu = op_cost.trace(f, *args)
    _, meta = op_cost.trace(f, *(a.to("meta") for a in args))
    assert [r.key() for r in cpu.records] == [r.key() for r in meta.records]
    assert cpu.peak_bytes == meta.peak_bytes > 0


# ---------------------------------------------------------------------------
# the subprocesses' side (this file run as a script)
# ---------------------------------------------------------------------------

def _analytic_main(out):
    """Fake groups: the TP pair on (1, 4), and the pod / model sums on
    2×16×16."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import init_fake, make_mesh
    init_fake(4)
    mesh = make_mesh((1, 4), ("data", "model"))
    b, d, f = 8, 64, 256
    x = distribute_tensor(torch.empty(b, d, device="meta"), mesh,
                          [Replicate(), Replicate()], src_data_rank=None)
    w1 = distribute_tensor(torch.empty(d, f, device="meta"), mesh,
                           [Replicate(), Shard(1)], src_data_rank=None)
    w2 = distribute_tensor(torch.empty(f, d, device="meta"), mesh,
                           [Replicate(), Shard(0)], src_data_rank=None)

    def tp(x, w1, w2):
        y = (x @ w1) @ w2
        return y.redistribute(mesh, [Replicate(), Replicate()])

    _, tr = op_cost.trace(tp, x, w1, w2)
    result = {"tp": op_cost.analyze_trace(tr, 4)}
    init_fake(512)
    pods = make_mesh((2, 16, 16), ("pod", "data", "model"))
    t = torch.empty(1000, device="meta")

    def sums(t):
        dist.all_reduce(t, group=pods.get_group("pod"))
        dist.all_reduce(t, group=pods.get_group("model"))

    _, tr = op_cost.trace(sums, t)
    result["sums"] = [(r.collective, r.group, r.payload, r.interpod)
                      for r in tr.records if r.collective]
    torch.save(result, out)


SMALL = {"train": (64, 4), "decode": (32, 4)}


def _cells():
    from repro_torch.configs import ShapeSpec
    return [(arch, ShapeSpec(f"small_{k}", s, b, k))
            for arch in TRACE_ARCHS for k, (s, b) in SMALL.items()]


def _config(arch):
    """A smoke config; ``lm100m-dots``: lm100m's with remat ``dots``, the
    selective checkpoint of the card's training step."""
    import dataclasses
    from repro_torch.configs import get_smoke
    if arch == "lm100m-dots":
        return "lm100m", dataclasses.replace(get_smoke("lm100m"),
                                             remat="dots")
    return arch, get_smoke(arch)


def _traces(mesh, device):
    from repro_torch.launch.specs import build_cell
    out = {}
    for name, shape in _cells():
        arch, cfg = _config(name)
        low = build_cell(arch, shape, mesh, cfg=cfg, dtype=torch.float32,
                         device=device)
        _, tr = op_cost.trace(low.fn, *low.args, all_devices=True)
        out[f"{name}|{shape.kind}"] = [r.key() for r in tr.records]
    return out


def _meta_main(out):
    from repro_torch.launch.mesh import init_fake, make_mesh
    init_fake(4)
    torch.save(_traces(make_mesh((2, 2), ("data", "model")), "meta"), out)


def _rank_main(rank, world, store, out):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("cpu", init_method=f"file://{store}", rank=rank,
                     world_size=world, timeout_s=60)
    traces = _traces(make_mesh((2, 2), ("data", "model")), "cpu")
    if rank == 0:
        torch.save(traces, out)
    import torch.distributed as dist
    dist.destroy_process_group()


def _gloo_main(out):
    import tempfile
    import torch.multiprocessing as mp
    store = tempfile.mktemp(dir=os.path.dirname(out), prefix="store_")
    mp.spawn(_rank_main, args=(4, store, out), nprocs=4)


# ---------------------------------------------------------------------------
# the test's side
# ---------------------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _start(mode, out):
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), mode,
                             str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(),
                            cwd=ROOT)


def _finish(proc, out):
    _, err = proc.communicate(timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, err[-4000:]
    return torch.load(out, weights_only=False)


def test_fake_group_collectives(tmp_path):
    out = tmp_path / "analytic.pt"
    res = _finish(_start("analytic", out), out)
    b, d, f, g = 8, 64, 256, 4
    tp = res["tp"]
    assert tp["matmul_flops_per_device"] == 2 * (2 * b * d * f // g)
    payload = b * d * 4
    assert tp["collective_bytes"]["all-reduce"] == payload
    assert tp["collective_wire_per_device"] == 2 * payload * (g - 1) / g
    assert tp["collective_count"] == 1
    assert tp["collective_wire_interpod"] == 0
    assert res["sums"] == [("all-reduce", 2, 4000.0, True),
                           ("all-reduce", 16, 4000.0, False)]


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    out = tmp_path_factory.mktemp("traces")
    meta = _start("meta", out / "meta.pt")
    gloo = _start("gloo", out / "gloo.pt")
    return (_finish(meta, out / "meta.pt"), _finish(gloo, out / "gloo.pt"))


@pytest.mark.parametrize("cell", [f"{a}|{s.kind}" for a, s in _cells()])
def test_meta_trace_equals_real_run(traces, cell):
    meta, real = traces
    assert len(meta[cell]) > 100
    diff = [f"op {i}: {m} != {r}" for i, (m, r) in
            enumerate(zip(meta[cell], real[cell])) if m != r][:5]
    assert not diff and len(meta[cell]) == len(real[cell]), diff


if __name__ == "__main__":
    mode, target = sys.argv[1], sys.argv[2]
    {"analytic": _analytic_main, "meta": _meta_main,
     "gloo": _gloo_main}[mode](target)
