"""The port's dry run and the mesh paths it needs, on the CPU.

* Argument bytes: ``launch.specs.build_cell(...).arg_bytes_per_device``
  equals the reference's ``build_cell`` (on ``AbstractMesh``) for every
  cell of ``cells()`` on 16×16 and 2×16×16, and equals the local bytes
  of the placed ``meta`` trees (the port's side runs under a fake
  process group of 256 / 512 ranks, in a subprocess).
* The mesh paths: train and decode of the gemma3 (local windows),
  mixtral (SWA + MoE), moonshot (MoE), jamba (Mamba + MoE) and rwkv6
  smoke configs on four gloo ranks at (2, 2) match the unsharded port
  within the reference's sharded-vs-single tolerance (2e-4): two AdamW
  steps' losses, the logits of a 12-token prefill (the windows of 8 wrap)
  and three decode steps, and the placed windowed and recurrent caches
  after them, whole.  Both run in float64: the jamba and gemma3 smoke
  configs are ill-conditioned (their float32 second-step losses lie
  2.5e-3 and 1.0e-3 from float64's on one process, jamba's float32 Mamba
  states reach 1e4), and sums over shards taken in another order move
  float32 results as far, so float32 would hold the mesh to its
  rounding, not to its arithmetic.  The Mamba scan and the WKV state
  stay float32 whatever the cache's dtype (as in the reference), so the
  logits and caches are held within 2e-4 of each tensor's largest value
  (at least 1), the convention of ``tests/test_torch_lm_serving.py``: a
  Mamba state's values reach 7e4.  The grouped MoE dispatch (4096
  tokens: one group a data shard) equals the single-device layer run on
  each group (float32).
* The entry point: ``python -m repro_torch.launch.dryrun --arch
  qwen2.5-3b --shape decode_32k`` at full width on 16×16 prints the
  reference's ``OK`` line and writes its keys (the reference's own
  entry point fails in this container, ``tests/test_multidevice.py::
  test_dryrun_entrypoint_single_cell``; its run with ``jax`` and
  ``repro`` blocked is in ``tests/test_torch_isolation.py``).

Each ``init_process_group``, fake or gloo, runs in a subprocess (this
file run as a script), never in the pytest worker.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 240
TOL = 2e-4
MESH_ARCHS = ["gemma3-1b", "mixtral-8x22b", "moonshot-v1-16b-a3b",
              "jamba-1.5-large-398b", "rwkv6-7b"]
PROMPT, DECODE, MAX_SEQ = 12, 3, 32


# ---------------------------------------------------------------------------
# the subprocesses' side (this file run as a script)
# ---------------------------------------------------------------------------

def _arg_bytes_main(out):
    from repro_torch.configs import cells
    from repro_torch.launch.mesh import init_fake, make_production_mesh
    from repro_torch.launch.specs import build_cell
    result = {}
    for multi_pod in (False, True):
        init_fake(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch, shape, _ in cells():
            low = build_cell(arch, shape, mesh)
            result[f"{arch}|{shape}|{int(multi_pod)}"] = (
                low.arg_bytes_per_device, low.local_arg_bytes())
    with open(out, "w") as f:
        json.dump(result, f)


def _train_cfg():
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig
    return TrainConfig(opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=10))


def _data(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab, (2, PROMPT + DECODE)).astype(
        np.int32)
    return toks, labs, prompt


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _run_arch(arch, mesh):
    """Two train steps' losses, the decode logits and the caches after
    them (whole tensors), on ``mesh`` or (None) one process."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, batch_rows
    from repro_torch.launch.specs import _leaves
    from repro_torch.models.params import init_params, tensors
    from repro_torch.models.transformer import model_defs
    from repro_torch.optim import adamw
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import decode_step, prefill
    from repro_torch.train.train_step import make_train_step, param_mesh
    cfg = get_smoke(arch)
    toks, labs, prompt = _data(cfg)
    tc = _train_cfg()
    pm = param_mesh(mesh)
    params = init_params(model_defs(cfg), seed=0, dtype=torch.float64,
                         device="cpu", mesh=pm)
    for p in tensors(params):
        p.requires_grad_(True)
    opt = adamw.init(tc.opt, params)
    if mesh is None:
        batch = {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labs)}
    else:
        lo, hi = batch_rows(DataConfig(cfg.vocab, 64, 4), mesh)
        places = [Shard(0) if a == "data" else Replicate()
                  for a in pm.mesh_dim_names]
        batch = {k: DTensor.from_local(torch.from_numpy(v[lo:hi]), pm,
                                       places)
                 for k, v in (("tokens", toks), ("labels", labs))}
    step = make_train_step(cfg, tc, mesh)
    losses = []
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    params = init_params(model_defs(cfg), seed=1, dtype=torch.float64,
                         device="cpu", mesh=mesh)
    cache = init_cache(cfg, 2, MAX_SEQ, torch.float64, "cpu", mesh=mesh)
    p_t = torch.from_numpy(prompt)
    logits = []
    with torch.no_grad():
        lg, cache = prefill(params, cfg, p_t[:, :PROMPT], cache)
        logits.append(_whole(lg))
        for t in range(PROMPT, PROMPT + DECODE):
            lg, cache = decode_step(params, cfg, cache, p_t[:, t], t)
            logits.append(_whole(lg))
    caches = [_whole(c).clone() for c in _leaves(cache)]
    return losses, logits, caches


def _grouped_moe(mesh):
    """The MoE layer of mixtral-smoke on 8 × 512 tokens: (on ``mesh``,
    whole) or (None) the single-device layer on each half."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.moe import moe_apply, moe_defs
    from repro_torch.models.params import init_params
    from repro_torch.parallel.sharding import P, distribute
    cfg = get_smoke("mixtral-8x22b")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(8, 512, cfg.d_model)).astype(np.float32))
    p = init_params(moe_defs(cfg), seed=3, dtype=torch.float32,
                    device="cpu", mesh=mesh)
    with torch.no_grad():
        if mesh is None:
            return torch.cat([moe_apply(p, cfg, x[:4])[0],
                              moe_apply(p, cfg, x[4:])[0]])
        out, _ = moe_apply(p, cfg, distribute(x, mesh, P("data")))
        return out.full_tensor()


def _rank_main(rank, world, store, out):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("cpu", init_method=f"file://{store}", rank=rank,
                     world_size=world, timeout_s=60)
    mesh = make_mesh((2, 2), ("data", "model"))
    result = {arch: _run_arch(arch, mesh) for arch in MESH_ARCHS}
    result["grouped_moe"] = _grouped_moe(mesh)
    if rank == 0:
        torch.save(result, os.path.join(out, "mesh.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()


def _spawn(out):
    import tempfile
    import torch.multiprocessing as mp
    store = tempfile.mktemp(dir=out, prefix="store_")
    mp.spawn(_rank_main, args=(4, store, out), nprocs=4)


# ---------------------------------------------------------------------------
# the test's side
# ---------------------------------------------------------------------------

def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", **extra)


def _run_script(*args):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           *map(str, args)], capture_output=True, text=True,
                          env=_env(), timeout=SPAWN_TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]


@pytest.fixture(scope="module")
def port_arg_bytes(tmp_path_factory):
    out = tmp_path_factory.mktemp("argbytes") / "port.json"
    _run_script("arg_bytes", out)
    return json.loads(out.read_text())


def _cells():
    from repro_torch.configs import cells
    return [(a, s, mp) for a, s, _ in cells() for mp in (0, 1)]


@pytest.mark.parametrize("arch,shape,multi_pod", _cells())
def test_arg_bytes_equal_reference(port_arg_bytes, arch, shape, multi_pod):
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh
    from repro.launch.specs import build_cell as jbuild_cell
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model"))
            if multi_pod else AbstractMesh((16, 16), ("data", "model")))
    want = jbuild_cell(arch, shape, mesh).arg_bytes_per_device
    got, local = port_arg_bytes[f"{arch}|{shape}|{multi_pod}"]
    assert got == want
    assert local == got


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    _run_script("mesh", out)
    return torch.load(out / "mesh.pt", weights_only=False)


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_training_matches_unsharded(mesh_runs, arch):
    torch.set_num_threads(1)
    want, _, _ = _run_arch(arch, None)
    got, _, _ = mesh_runs[arch]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_decode_and_caches_match_unsharded(mesh_runs, arch):
    torch.set_num_threads(1)
    _, want_lg, want_c = _run_arch(arch, None)
    _, got_lg, got_c = mesh_runs[arch]
    assert len(got_lg) == len(want_lg) and len(got_c) == len(want_c)
    for got, want in zip(got_lg + got_c, want_lg + want_c):
        assert got.shape == want.shape and got.dtype == want.dtype
        scale = max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=TOL * scale)


def test_grouped_moe_dispatch_is_per_group(mesh_runs):
    torch.set_num_threads(1)
    want = _grouped_moe(None)
    np.testing.assert_allclose(mesh_runs["grouped_moe"].numpy(),
                               want.numpy(), rtol=TOL, atol=TOL)


REF_KEYS = {"arch", "shape", "mesh", "devices", "lower_s", "compile_s",
            "xla_flops_unscaled", "xla_bytes_unscaled",
            "collectives_unscaled", "cost", "arg_bytes_per_device",
            "memory", "variant"}
COST_KEYS = {"flops_per_device", "bytes_per_device",
             "bytes_fused_per_device", "collective_bytes",
             "collective_wire_per_device", "collective_wire_interpod",
             "collective_count", "unknown_trip_whiles", "uncorrected"}


def test_entry_point_single_cell(tmp_path):
    """The passing counterpart of the reference's
    ``test_dryrun_entrypoint_single_cell``, at full width on 16×16."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "OK  qwen2.5-3b_decode_32k_16x16" in proc.stdout
    res = json.loads((tmp_path / "qwen2.5-3b_decode_32k_16x16.json")
                     .read_text())
    assert REF_KEYS <= set(res) and COST_KEYS <= set(res["cost"])
    assert res["devices"] == 256 and res["compile_s"] is None
    assert res["cost"]["unknown_trip_whiles"] == 0
    assert res["cost"]["flops_per_device"] > 0
    assert res["memory"]["argument_bytes"] == res["arg_bytes_per_device"]


if __name__ == "__main__":
    mode, target = sys.argv[1], sys.argv[2]
    if mode == "arg_bytes":
        _arg_bytes_main(target)
    elif mode == "mesh":
        _spawn(target)
    else:
        raise SystemExit(f"unknown mode {mode}")
