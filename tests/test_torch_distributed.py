"""The port's mesh layer across processes on the CPU (gloo), against the
port's single-process path and the JAX package.

Each spawn starts its ranks in a subprocess of its own (this file run as a
script), with a ``file://`` store in ``tmp_path``, a 60 s process-group
timeout and a 180 s subprocess timeout, so a stuck collective fails its
test instead of cutting the suite.  Four spawns, in order, each at most
four ranks (the checkpoint crosses meshes between them):

* ``2x2``: qwen2.5-smoke, 3 AdamW steps on mesh (2, 2); a prefill of 6
  tokens and decode steps at positions 6, 7, 8, 15, 16, 24 and 31 of the
  ``cache_pack``-placed 32-slot cache, with a batch of 2, and again with
  a batch of 1 and the sequence over both axes (``seq_all``); the
  trained state saved (checkpoint A); the same training with 8-bit
  moments and 2 microbatches, its state saved.
* ``1x1``: the same training and decode on a (1, 1) mesh of one
  process; checkpoint A restored; the state saved (checkpoint B).
* ``1x4``: the training and decode on (1, 4) (model > KV heads); the
  int8 pod all-reduce on the reference test's data with 4 pods (a (4, 1,
  1) mesh); checkpoint B restored on (2, 2).
* ``2x1x2``: the training with ``grad_compression="int8_pod"`` on
  (2, 1, 2) and its state saved; the int8 pod all-reduce with 2 pods on
  the reference test's data.

Tolerances: the losses within 2e-4 (rtol and atol) of the port's
single-process step, the reference's own tolerance for sharded against
single-device training (``tests/test_multidevice.py``); the single-process
step is held to the reference's ``make_train_step`` by
``tests/test_torch_train_archs.py``.  The first step's gradients within
1e-4 × each leaf's max |g| (a sum over shards in another order: float32
rounding).  Parameters after 3 steps within 2e-4, leaf by leaf, at every
element but those whose single-process gradient lies at the noise floor
at some step: AdamW's first steps move an element by about ``lr``
whatever its gradient's size, so an element whose gradient is float32
noise (summed in another order) may step the other way.  The floor is
``GRAD_TOL`` × the leaf's max |g| that step (the first-step check's
tolerance); with ``int8_pod`` it is ``COMPRESS_FLOOR`` units of the int8
sum (``scale / n_pods``), where a partial summed in another order that
crosses a rounding boundary changes the sum by one unit, a third or more
of its size.  The decode's logits at every step and its caches after them
within 3e-4 (the reference test's): a dense cache's sequence shards (two
of 16 slots at (2, 2), four of 8 at (1, 4) and under ``seq_all``) see
the position in the first shard only, on each shard boundary and in the
last shard, each rank attending over its own slots and the ranks
combining (``serving.engine``).  The int8 all-reduce and the
checkpoints bit for bit.  The (1, 1) mesh's training and decode equal
the unsharded ones bit for bit: a mesh dim of one rank places every tensor
whole (``parallel.sharding.placements``), so DTensor runs the
single-device operations (the prediction for the card's one rank).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 180
LR = 1e-3
STEPS = 3
LOSS_TOL = 2e-4
GRAD_TOL = 1e-4
PARAM_TOL = 2e-4
COMPRESS_FLOOR = 3
DECODE_TOL = 3e-4


# ---------------------------------------------------------------------------
# the ranks' side (this file run as a script)
# ---------------------------------------------------------------------------

def _train_cfg(compression=None, eightbit=False):
    """3 AdamW steps at lr 1e-3; ``eightbit``: 8-bit moments and 2
    microbatches."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig
    return TrainConfig(opt=adamw.AdamWConfig(lr=LR, warmup_steps=1,
                                             total_steps=10,
                                             eightbit=eightbit),
                       grad_compression=compression,
                       microbatches=2 if eightbit else 1)


def _data():
    from repro_torch.configs import get_smoke
    cfg = get_smoke("qwen2.5-3b")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    return cfg, toks, labs


def _pod_grads():
    """The reference test's per-pod partials (2 pods × 64, seed 0) and a
    4-pod draw of the same stream."""
    return (np.random.default_rng(0).normal(size=(2, 64)).astype(np.float32),
            np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32))


def _rank_train(mesh, compression=None, eightbit=False):
    """3 steps on ``mesh``: (losses, first-step gradients, params, opt),
    full tensors on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.data.pipeline import DataConfig, batch_rows
    from repro_torch.models.params import init_params, tensors
    from repro_torch.models.transformer import model_defs
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (make_grad_fn, make_train_step,
                                             param_mesh)
    cfg, toks, labs = _data()
    tc = _train_cfg(compression, eightbit)
    pm = param_mesh(mesh)
    params = init_params(model_defs(cfg), seed=0, dtype=torch.float32,
                         device="cpu", mesh=pm)
    for p in tensors(params):
        p.requires_grad_(True)
    opt = adamw.init(tc.opt, params)
    lo, hi = batch_rows(DataConfig(cfg.vocab, 32, 8), mesh)
    places = [Shard(0) if a == "data" else Replicate()
              for a in pm.mesh_dim_names]
    batch = {k: DTensor.from_local(torch.from_numpy(v[lo:hi]), pm, places)
             for k, v in (("tokens", toks), ("labels", labs))}
    _, _, g0 = make_grad_fn(cfg, tc)(params, batch)
    g0 = [g.full_tensor() for g in tensors(g0)]
    step = make_train_step(cfg, tc, mesh)
    losses = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return losses, g0, params, opt


def _opt_placements(opt, params, mesh):
    """Whether every moment's placements are those of
    ``launch.specs.opt_pack``'s specs."""
    from repro_torch.launch import specs
    from repro_torch.models.transformer import model_defs
    from repro_torch.parallel.sharding import walk, is_spec, placements
    cfg, _, _ = _data()
    _, abs_p, p_specs = specs.param_pack(cfg, mesh)
    _, o_specs = specs.opt_pack(abs_p, p_specs, mesh, True)
    want = []
    walk(o_specs._replace(step=None), lambda sp: want.append(
        placements(sp, mesh)), is_spec)
    got = [tuple(t.placements) for t in specs._leaves(opt._replace(
        step=None))]
    return got == want and len(got) > 0


def _full(tree):
    from repro_torch.models.params import tensors
    return [t.full_tensor().detach() for t in tensors(tree)]


DECODE_PROMPT, DECODE_SLOTS = 6, 32
# the first shard only (6, 7), the boundaries of two shards of 16 (15,
# 16) and of four of 8 (8, 16, 24), the last shard (24, 31); the slots
# between stay as the prefill left them on both sides
DECODE_AT = (6, 7, 8, 15, 16, 24, 31)


def _rank_decode(mesh, batch=2, seq_all=False):
    """(every step's logits, the caches after them), whole tensors."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import model_defs
    from repro_torch.serving.cache import init_cache
    cfg = get_smoke("qwen2.5-3b")
    params = init_params(model_defs(cfg), seed=0, dtype=torch.float32,
                         device="cpu", mesh=mesh)
    cache = init_cache(cfg, batch, DECODE_SLOTS, torch.float32, "cpu",
                       mesh=mesh, seq_all=seq_all)
    with torch.no_grad():
        return _decode(params, cfg, _decode_tokens(cfg)[:batch], cache)


def _decode_tokens(cfg):
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, DECODE_SLOTS)).astype(np.int32))


def _decode(params, cfg, toks, cache):
    """A prefill of ``DECODE_PROMPT`` tokens and a decode step at each of
    ``DECODE_AT``: (the logits of each, stacked; the caches after them),
    whole tensors."""
    from repro_torch.launch.specs import _leaves
    from repro_torch.serving.engine import decode_step, prefill
    lg, cache = prefill(params, cfg, toks[:, :DECODE_PROMPT], cache)
    logits = [_whole(lg)]
    for t in DECODE_AT:
        lg, cache = decode_step(params, cfg, cache, toks[:, t], t)
        logits.append(_whole(lg))
    return torch.stack(logits), [_whole(c).clone() for c in _leaves(cache)]


def _rank_compress(mesh, grads):
    """Each pod's ranks hold their pod's partial; the all-reduced mean."""
    from repro_torch.train.distributed import compressed_pod_allreduce
    pod = mesh.get_local_rank("pod")
    out = compressed_pod_allreduce({"g": torch.from_numpy(grads[pod])}, mesh)
    return out["g"]


def _rank_global_batch(mesh):
    """Whether every rank's ``make_global_batch`` shard is its (pod, data)
    rows of ``host_batch`` (pod major), with the per-pod global shape."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import (DataConfig, host_batch,
                                           make_global_batch)
    cfg = DataConfig(vocab=97, seq_len=8, global_batch=8, seed=3)
    got = make_global_batch(cfg, 5, mesh)
    pod = mesh.get_local_rank("pod")
    rows = host_batch(cfg, 5, 4 * pod, 4 * pod + 4)
    ok = torch.tensor(int(all(
        np.array_equal(got[k].to_local().numpy(), rows[k])
        and tuple(got[k].shape) == (4, 8) for k in ("tokens", "labels"))))
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok)


def _disk(ckpt_dir):
    """Step 1's arrays on disk, by leaf key."""
    import pathlib
    path = pathlib.Path(ckpt_dir) / f"step_{1:010d}"
    manifest = json.loads((path / "manifest.json").read_text())
    return {key: torch.from_numpy(np.load(path / leaf["file"]))
            for key, leaf in manifest["leaves"].items()}


def _whole(leaf):
    return leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf


def _save(ckpt_dir, params, opt):
    """Save step 1: (each leaf's full tensor, its array on disk) in leaf
    order."""
    from repro_torch.checkpoint.checkpointer import Checkpointer, _items
    tree = {"params": params, "opt": opt}
    Checkpointer(ckpt_dir).save(1, tree)
    disk = _disk(ckpt_dir)
    items = list(_items(tree))
    return ([_whole(leaf).detach() for _, leaf in items],
            [disk[key] for key, _ in items])


def _restore(ckpt_dir, params, opt):
    """Checkpoint ``ckpt_dir`` onto the placements of ``params``/``opt``:
    (full tensors restored, the arrays on disk) in leaf order."""
    from repro_torch.checkpoint.checkpointer import Checkpointer, _items
    like = {"params": params, "opt": opt}
    got = Checkpointer(ckpt_dir).restore(1, like)
    disk = _disk(ckpt_dir)
    restored, on_disk = [], []
    for key, leaf in _items(got):
        restored.append(_whole(leaf))
        on_disk.append(disk[key])
        placed = dict(_items(like))[key]
        assert type(leaf) is type(placed), key
        if hasattr(placed, "placements"):
            assert leaf.placements == placed.placements, key
    return restored, on_disk


def _rank_main(rank, world, store, spawn, out):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("cpu", init_method=f"file://{store}", rank=rank,
                     world_size=world, timeout_s=60)
    result = {}
    if spawn == "2x2":
        mesh = make_mesh((2, 2), ("data", "model"))
        losses, g0, params, opt = _rank_train(mesh)
        result["train"] = (losses, g0, _full(params))
        result["decode"] = _rank_decode(mesh)
        result["decode_seq_all"] = _rank_decode(mesh, batch=1, seq_all=True)
        result["saved_a"] = _save(os.path.join(out, "ckpt_a"), params, opt)
        losses, _, params8, opt8 = _rank_train(mesh, eightbit=True)
        result["eightbit"] = (losses, _full(params8),
                              _opt_placements(opt8, params8, mesh))
        result["saved_8bit"] = _save(os.path.join(out, "ckpt_8bit"),
                                     params8, opt8)
    elif spawn == "1x1":
        mesh = make_mesh((1, 1), ("data", "model"))
        losses, g0, params, opt = _rank_train(mesh)
        result["train"] = (losses, g0, _full(params))
        result["restore_a"] = _restore(os.path.join(out, "ckpt_a"), params,
                                       opt)
        result["decode"] = _rank_decode(mesh)
        result["saved_b"] = _save(os.path.join(out, "ckpt_b"), params, opt)
    elif spawn == "1x4":
        mesh = make_mesh((1, 4), ("data", "model"))
        losses, g0, params, opt = _rank_train(mesh)
        result["train"] = (losses, g0, _full(params))
        result["decode"] = _rank_decode(mesh)
        pods4 = make_mesh((4, 1, 1), ("pod", "data", "model"))
        result["compress4"] = _rank_compress(pods4, _pod_grads()[1])
        mesh22 = make_mesh((2, 2), ("data", "model"))
        _, _, params22, opt22 = _rank_train(mesh22)
        result["restore_b"] = _restore(os.path.join(out, "ckpt_b"),
                                       params22, opt22)
    elif spawn == "2x1x2":
        mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
        losses, g0, params, opt = _rank_train(mesh, "int8_pod")
        result["train"] = (losses, None, _full(params))
        result["saved_pod"] = _save(os.path.join(out, "ckpt_pod"), params,
                                    opt)
        result["compress2"] = _rank_compress(mesh, _pod_grads()[0])
        result["global_batch"] = _rank_global_batch(mesh)
    else:
        raise ValueError(spawn)
    if rank == 0:
        torch.save(result, os.path.join(out, f"{spawn}.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()


def _spawn_ranks(spawn, out):
    import tempfile
    import torch.multiprocessing as mp
    world = int(np.prod([int(n) for n in spawn.split("x")]))
    store = tempfile.mktemp(dir=out, prefix=f"store_{spawn}_")
    mp.spawn(_rank_main, args=(world, store, spawn, out), nprocs=world)


# ---------------------------------------------------------------------------
# the test's side
# ---------------------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _run_spawn(spawn, out):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), spawn,
                           str(out)], capture_output=True, text=True,
                          env=_env(), timeout=SPAWN_TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return torch.load(out / f"{spawn}.pt", weights_only=False)


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    return {spawn: _run_spawn(spawn, out)
            for spawn in ("2x2", "1x1", "1x4", "2x1x2")}


def _single(compression_pods=None, eightbit=False):
    """The port's single-process steps on the same data: plain, or (with
    ``compression_pods``) each pod's partial gradient on its rows, the
    reference's ``_compress_body`` arithmetic in numpy over them.
    Returns (losses, first-step gradients, params, floor): ``floor`` a
    mask a leaf of the elements whose gradient lies at the noise floor
    at some step (the module's docstring)."""
    from repro_torch.models.params import (init_params, is_tensor, tensors,
                                           tree_map)
    from repro_torch.models.transformer import model_defs
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_grad_fn, make_train_step
    cfg, toks, labs = _data()
    tc = _train_cfg(eightbit=eightbit)
    params = init_params(model_defs(cfg), seed=0, dtype=torch.float32,
                         device="cpu")
    for p in tensors(params):
        p.requires_grad_(True)
    opt = adamw.init(tc.opt, params)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)}
    grad_fn = make_grad_fn(cfg, tc)
    _, _, g0 = grad_fn(params, batch)
    losses = []
    floor = [torch.zeros(p.shape, dtype=torch.bool) for p in tensors(params)]
    for _ in range(STEPS):
        if compression_pods is None:
            g = tensors(grad_fn(params, batch)[2])
            floor = [f | (x.abs() <= GRAD_TOL * x.abs().max())
                     for f, x in zip(floor, g)]
            params, opt, m = make_train_step(cfg, tc)(params, opt, batch)
            losses.append(float(m["loss"]))
            continue
        rows = 8 // compression_pods
        parts = [grad_fn(params, {k: v[i * rows:(i + 1) * rows]
                                  for k, v in batch.items()})
                 for i in range(compression_pods)]
        losses.append(float(np.mean([float(p[0]) for p in parts])))
        leaves = [np.stack([tensors(p[2])[j].numpy() for p in parts])
                  for j in range(len(tensors(params)))]
        means = [compress_replica(x) for x in leaves]
        floor = [f | torch.from_numpy(np.abs(m) <= COMPRESS_FLOOR * unit(x))
                 for f, m, x in zip(floor, means, leaves)]
        mean = iter(torch.from_numpy(m) for m in means)
        grads = tree_map(lambda _: next(mean), params, is_tensor)
        params, opt, _ = adamw.apply_updates(tc.opt, params, grads, opt)
    return (losses, tensors(g0), [p.detach() for p in tensors(params)],
            floor)


def compress_replica(partials: np.ndarray) -> np.ndarray:
    """The reference's ``_compress_body`` in numpy float32, over the pods'
    partials stacked on axis 0, as XLA compiles it: its divisions by the
    constants ``limit`` and ``n_pods`` are multiplications by their
    float32 reciprocals."""
    n = partials.shape[0]
    limit = max(1, 127 // n)
    scale = np.float32(np.max(np.abs(partials.astype(np.float32))))
    scale = np.float32(np.maximum(scale, np.float32(1e-12))
                       * np.float32(1.0 / limit))
    q = np.clip(np.round(partials.astype(np.float32) / scale), -limit,
                limit).astype(np.int8)
    s = q.sum(axis=0, dtype=np.int8)
    return ((s.astype(np.float32) * scale) * np.float32(1.0 / n)).astype(
        partials.dtype)


def unit(partials: np.ndarray) -> float:
    """One unit of ``compress_replica``'s int8 sum, ``scale / n_pods``."""
    n = partials.shape[0]
    return float(max(np.abs(partials).max(), 1e-12) / max(1, 127 // n) / n)


def _check_params(got, want, floor):
    """Leaf by leaf: every element within ``PARAM_TOL`` but where
    ``floor`` marks its gradient as noise at some step."""
    assert len(got) == len(want) == len(floor) > 0
    for i, (a, b, f) in enumerate(zip(got, want, floor)):
        off = ((a - b).abs() > PARAM_TOL) & ~f
        assert not bool(off.any()), (i, tuple(b.shape), int(off.sum()),
                                     float((a - b).abs().max()))


@pytest.fixture(scope="module")
def single():
    return _single()


@pytest.mark.parametrize("spawn", ["2x2", "1x4"])
def test_sharded_training_matches_single_process(spawns, single, spawn):
    losses, g0, params = spawns[spawn]["train"]
    want_losses, want_g0, want_params, floor = single
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for a, b in zip(g0, want_g0):
        assert float((a - b).abs().max()) <= GRAD_TOL * float(
            b.abs().max()) + 1e-12
    _check_params(params, want_params, floor)


def test_eightbit_microbatched_training_matches_single_process(spawns):
    """8-bit moments (their block scales placed by ``opt_pack``'s specs,
    blocks that cross shard edges updated gathered) and 2 microbatches
    (each rank's own rows split) on (2, 2) against one process."""
    losses, params, placed = spawns["2x2"]["eightbit"]
    want_losses, _, want_params, floor = _single(eightbit=True)
    assert placed
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    _check_params(params, want_params, floor)


def test_one_rank_mesh_is_the_unsharded_step(spawns, single):
    """A (1, 1) mesh runs every op on the rank's whole tensors: the
    losses, first gradients and parameters equal the unsharded step's bit
    for bit."""
    losses, g0, params = spawns["1x1"]["train"]
    want_losses, want_g0, want_params, _ = single
    assert losses == want_losses
    for a, b in zip(g0 + params, list(want_g0) + want_params):
        assert torch.equal(a, b)


def test_int8_pod_training_matches_replica(spawns):
    """(2, 1, 2) with ``int8_pod`` against one process that compresses
    the two pods' partial gradients with the reference's arithmetic.  The
    partials differ by float32 rounding (a sum over shards in another
    order), which can move a value across a rounding boundary of the
    int8 grid — one quantum, ``scale / 63`` — so an element whose sum
    lies within ``COMPRESS_FLOOR`` units of 0 at some step may part by
    more than ``PARAM_TOL``."""
    losses, _, params = spawns["2x1x2"]["train"]
    want_losses, _, want_params, floor = _single(compression_pods=2)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    _check_params(params, want_params, floor)


@pytest.mark.parametrize("spawn", ["2x2", "1x1", "1x4", "2x2_seq_all"])
def test_sharded_decode_matches_unsharded(spawns, spawn):
    """Every step's logits and the caches within 3e-4 on (2, 2), (1, 4)
    and ``seq_all`` (2, 2) (a batch of one); on a (1, 1) mesh bit for
    bit."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import model_defs
    from repro_torch.serving.cache import init_cache
    cfg = get_smoke("qwen2.5-3b")
    mesh, _, layout = spawn.partition("_")
    batch = 1 if layout else 2
    params = init_params(model_defs(cfg), seed=0, dtype=torch.float32,
                         device="cpu")
    with torch.no_grad():
        want, want_c = _decode(params, cfg, _decode_tokens(cfg)[:batch],
                               init_cache(cfg, batch, DECODE_SLOTS,
                                          torch.float32, "cpu"))
    got, got_c = spawns[mesh]["decode_" + layout if layout else "decode"]
    assert got.shape == want.shape and len(got_c) == len(want_c)
    if spawn == "1x1":
        assert torch.equal(got, want)
        assert all(torch.equal(g, w) for g, w in zip(got_c, want_c))
    np.testing.assert_allclose(got[..., :cfg.vocab].numpy(),
                               want[..., :cfg.vocab].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=DECODE_TOL,
                                   atol=DECODE_TOL)


def _reference_compress():
    """The JAX package's all-reduce on the same data, 8 fake devices,
    meshes (2, 2, 2) and (4, 2, 1)."""
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.train.distributed import compressed_pod_allreduce
        out = []
        for shape, n in (((2, 2, 2), 2), ((4, 2, 1), 4)):
            mesh = jax.make_mesh(shape, ("pod", "data", "model"))
            g = np.random.default_rng(0).normal(size=(n, 64)).astype(
                np.float32)
            with jax.set_mesh(mesh):
                dev = jax.device_put(jnp.asarray(g), jax.NamedSharding(
                    mesh, P("pod", None)))
                got = jax.jit(compressed_pod_allreduce)(dev)
            out.append(np.asarray(got)[0].tolist())
        import json
        print("RESULT:" + json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=SPAWN_TIMEOUT, cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT:")]
    return [np.asarray(v, np.float32) for v in json.loads(line[0][7:])]


@pytest.fixture(scope="module")
def reference_compress():
    return _reference_compress()


def test_global_batch_rows_follow_the_pods(spawns):
    """On (2, 1, 2) each rank's batch is its pod's rows of the stream."""
    assert spawns["2x1x2"]["global_batch"]


@pytest.mark.parametrize("pods", [2, 4])
def test_compressed_pod_allreduce_equals_reference(spawns,
                                                   reference_compress,
                                                   pods):
    got = spawns["2x1x2" if pods == 2 else "1x4"][f"compress{pods}"]
    want = reference_compress[0 if pods == 2 else 1]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), compress_replica(
        _pod_grads()[0 if pods == 2 else 1]))


@pytest.mark.parametrize("spawn,key", [("2x2", "saved_a"),
                                       ("2x2", "saved_8bit"),
                                       ("1x1", "saved_b"),
                                       ("2x1x2", "saved_pod")])
def test_checkpoint_writes_the_full_tensors(spawns, spawn, key):
    """What rank 0 wrote, the leaves gathered from their shards (f32 and
    8-bit moments on (2, 2); one rank; pod 0's replica on (2, 1, 2)),
    equals each leaf's full tensor."""
    full, disk = spawns[spawn][key]
    assert len(full) == len(disk) > 0
    for a, b in zip(full, disk):
        a = a.float() if a.dtype == torch.bfloat16 else a
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("direction", ["2x2_to_1x1", "1x1_to_2x2"])
def test_checkpoint_crosses_meshes(spawns, direction):
    spawn, key = (("1x1", "restore_a") if direction == "2x2_to_1x1"
                  else ("1x4", "restore_b"))
    restored, disk = spawns[spawn][key]
    assert len(restored) == len(disk) > 0
    for a, b in zip(restored, disk):
        assert torch.equal(a.cpu(), b)


def test_torchrun_launch_restarts_on_a_mesh():
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--arch", "lm100m", "--smoke", "--steps", "6", "--ckpt-every", "2",
         "--fail-at", "3", "--global-batch", "4", "--seq-len", "32",
         "--device", "cpu", "--mesh-shape", "2x2"],
        capture_output=True, text=True, env=_env(), timeout=SPAWN_TIMEOUT,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    done = [x for x in proc.stdout.splitlines() if x.startswith("done:")]
    assert len(done) == 1 and "6 steps" in done[0] \
        and "restarts=1" in done[0], proc.stdout[-2000:]


def test_mesh_refuses_another_world_size(tmp_path):
    """A 2×2 mesh on a group of one process raises; it is never shrunk."""
    code = textwrap.dedent(f"""
        from repro_torch.launch.mesh import init_distributed, make_mesh
        init_distributed("cpu", init_method="file://{tmp_path}/store",
                         rank=0, world_size=1, timeout_s=60)
        try:
            make_mesh((2, 2), ("data", "model"))
        except ValueError as e:
            print("REFUSED", e)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=SPAWN_TIMEOUT,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REFUSED a 2x2 mesh needs 4 processes" in proc.stdout


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _spawn_ranks(sys.argv[1], sys.argv[2])
