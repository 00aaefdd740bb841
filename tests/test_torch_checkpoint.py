"""The port's checkpointer, data stream and fault-tolerant loop
(``repro_torch.checkpoint``, ``repro_torch.data``, ``repro_torch.runtime``,
``repro_torch.launch.train``) on the CPU.

* the seven behaviours of ``tests/test_checkpoint.py`` (the elastic
  device-count test becomes a CPU-to-CPU restore with a dtype change);
* the on-disk format both ways: parameters plus an ``AdamWState`` (float32
  and 8-bit moments) written by the JAX package restore in the port bit
  for bit, and the other way round;
* the passing tests of ``tests/test_fault_tolerance.py`` (data
  determinism, the resilient loop, watchdog, straggler accounting);
  ``host_batch`` equal to the reference's byte for byte;
* the port's ``launch.train`` on lm100m smoke (8 steps, batch 2, seq 32,
  ``ckpt_every`` 2, a failure injected at step 5): one restart, the last
  loss of a clean run at ``rtol=1e-5``, and each step's loss within 1e-5
  relative of a loop over the JAX package's ``make_train_step`` fed
  ``host_batch`` from the same initial parameters.  (The reference's own
  end-to-end test, ``test_training_trajectory_identical_after_restart``,
  fails with the installed jax, so the port is held to its parts.)
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten as jflatten
from repro.data import pipeline as jpipeline
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.checkpoint.checkpointer import Checkpointer, _items
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig, host_batch, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models.params import init_params, tree_items
from repro_torch.models.transformer import model_defs
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (FailureInjector, StepTimeout,
                                                 StragglerStats, Watchdog,
                                                 resilient_train_loop)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(rng.normal(size=(8, 16)),
                                     dtype=torch.float32),
                   "b": torch.tensor(rng.normal(size=(16,)),
                                     dtype=torch.float32)},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [torch.arange(4), torch.ones((2, 2), dtype=torch.bfloat16)],
    }


def _leaves(tree):
    return [x for _, x in tree_items(tree, lambda x: isinstance(
        x, torch.Tensor))]


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = _tree()
    ck.save(3, tree)
    assert ck.latest_step() == 3
    out = ck.restore(3, tree)
    for a, b in zip(_leaves(out), _leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_and_wait(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    ck.save_async(1, _tree())
    ck.wait()
    assert ck.latest_step() == 1


def test_keep_k_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    assert ck.complete_steps() == [3, 4]


def test_atomicity_partial_write_ignored(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    ck.save(5, _tree())
    # a crashed mid-write leaves a .tmp dir: must be invisible + GC'd
    crash = tmp_path / "step_0000000009.tmp"
    crash.mkdir()
    (crash / "leaf_00000.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 5
    ck.save(6, _tree())
    assert not crash.exists()


def test_corrupt_manifest_is_not_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    ck.save(5, _tree())
    (tmp_path / "step_0000000007").mkdir()       # no manifest inside
    assert ck.latest_step() == 5


def test_restore_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    ck.save(1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError):
        ck.restore(1, {"w": torch.zeros((5, 4))})


def test_restore_onto_a_named_device_and_dtype(tmp_path):
    """The elastic test's counterpart on one device: leaves are stored
    whole, and restore places them on the device named, in the ``like``
    tree's dtypes (float32 saved, bf16 and float64 restored)."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    ck = Checkpointer(tmp_path, keep=1)
    ck.save(1, tree)
    for dtype in (torch.bfloat16, torch.float64):
        like = {"w": torch.empty((8, 8), dtype=dtype, device="meta")}
        out = ck.restore(1, like, device="cpu")
        assert out["w"].dtype == dtype and out["w"].device.type == "cpu"
        assert torch.equal(out["w"], tree["w"].to(dtype))
    with pytest.raises(ValueError):             # meta needs a device named
        ck.restore(1, {"w": torch.empty((8, 8), device="meta")})


def test_async_error_raised_on_wait(tmp_path):
    ck = Checkpointer(tmp_path, keep=1)
    ck.save_async(1, {"w": torch.zeros(3)})
    ck.wait()
    ck._write = lambda *a: (_ for _ in ()).throw(OSError("disk full"))
    ck.save_async(2, {"w": torch.zeros(3)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                                    # the error is raised once


def test_async_snapshot_is_a_copy(tmp_path):
    """The step updates its tensors in place: the snapshot is taken before
    ``save_async`` returns."""
    w = torch.zeros(1000)
    ck = Checkpointer(tmp_path, keep=1)
    ck.save_async(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    assert torch.equal(ck.restore(1, {"w": w})["w"], torch.zeros(1000))


# -- the format, both ways ---------------------------------------------------

def _opt_trees(eightbit: bool):
    rng = np.random.default_rng(11)
    arrays = {"blocks": [{"w": rng.standard_normal((3, 8, 300)).astype(
        np.float32)}], "embed": rng.standard_normal((40, 8)).astype(
        np.float32), "scale": rng.standard_normal((8,)).astype(np.float32)}
    jparams = jax.tree.map(jnp.asarray, arrays)
    cfg = jadamw.AdamWConfig(eightbit=eightbit, warmup_steps=1)
    jopt = jadamw.init(cfg, jparams)
    grads = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)), jparams)
    jparams, jopt, _ = jadamw.apply_updates(cfg, jparams, grads, jopt)
    return {"params": jparams, "opt": jopt}


def _port_like(jtree):
    """The port's tree of the same structure (zeros), from numpy."""
    host = jax.tree.map(np.asarray, jtree)
    params = jax.tree.map(lambda a: torch.zeros(a.shape), host["params"])
    opt = adamw.state_from_numpy(
        jax.tree.map(np.zeros_like, host["opt"]), device="cpu")
    return {"params": params, "opt": opt}


def _same_bits(port_tree, jtree):
    """The two trees' leaf keys (each package's own flattening) are the
    same strings, and each leaf the same bytes."""
    want = {k: np.asarray(x) for k, x in jflatten(jtree).items()}
    got = {k: x.numpy() for k, x in _items(port_tree)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


@pytest.mark.parametrize("eightbit", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, eightbit):
    jtree = _opt_trees(eightbit)
    JCheckpointer(tmp_path, keep=1).save(4, jtree)
    out = Checkpointer(tmp_path).restore(4, _port_like(jtree), device="cpu")
    assert isinstance(out["opt"], adamw.AdamWState)
    if eightbit:
        assert isinstance(out["opt"].mu["embed"], adamw.Moment8)
    _same_bits(out, jtree)


@pytest.mark.parametrize("eightbit", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, eightbit):
    jtree = _opt_trees(eightbit)
    host = jax.tree.map(np.asarray, jtree)
    port = {"params": jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                                   host["params"]),
            "opt": adamw.state_from_numpy(host["opt"], device="cpu")}
    Checkpointer(tmp_path, keep=1).save(4, port)
    like = jax.tree.map(jnp.zeros_like, jtree)
    out = JCheckpointer(tmp_path).restore(4, like)
    _same_bits(port, out)
    _same_bits(port, jtree)


# -- data --------------------------------------------------------------------

def test_data_deterministic_and_shardable():
    cfg = DataConfig(vocab=128, seq_len=32, global_batch=8, seed=3)
    a = host_batch(cfg, step=5, lo=0, hi=8)
    b = host_batch(cfg, step=5, lo=0, hi=8)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    shard = host_batch(cfg, step=5, lo=2, hi=6)
    np.testing.assert_array_equal(shard["tokens"], a["tokens"][2:6])
    c = host_batch(cfg, step=6, lo=0, hi=8)
    assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("seed", [0, 5])
def test_host_batch_equals_reference(seed):
    """Byte for byte; ``make_batch`` is the same arrays as tensors."""
    cfg = DataConfig(vocab=97, seq_len=24, global_batch=6, seed=seed)
    jcfg = jpipeline.DataConfig(vocab=97, seq_len=24, global_batch=6,
                                seed=seed)
    for step in (0, 7):
        got = host_batch(cfg, step, 0, 6)
        want = jpipeline.host_batch(jcfg, step, 0, 6)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
        tensors = make_batch(cfg, step, "cpu")
        for k in want:
            assert np.array_equal(tensors[k].numpy(), want[k])


@pytest.mark.parametrize("kw", [dict(frontend_prefix=4, d_model=16),
                                dict(encoder_seq=12, d_model=16)])
def test_host_batch_modality_inputs_follow_reference(kw):
    """The reference draws prefix embeddings and frames from
    ``SeedSequence([seed, step, -1])`` and ``[..., -2]``, which numpy
    refuses (entropy must be non-negative): ``host_batch`` raises for a
    VLM or audio configuration in both packages (ROADMAP Queue 3,
    reference fault 4).  The port copies the stream as it is."""
    cfg = DataConfig(vocab=97, seq_len=24, global_batch=2, **kw)
    jcfg = jpipeline.DataConfig(vocab=97, seq_len=24, global_batch=2, **kw)
    for fn, c in ((host_batch, cfg), (jpipeline.host_batch, jcfg)):
        with pytest.raises(ValueError, match="non-negative"):
            fn(c, 0, 0, 2)


# -- the resilient loop --------------------------------------------------------

def _counter_loop(tmp_path, fail_at, total=20, ckpt_every=5):
    """A deterministic 'training' whose state is a running hash of steps."""
    trace = []

    def step_fn(state, step):
        trace.append(step)
        return {"acc": (state["acc"] * 31 + step + 1) % 1_000_003}

    report = resilient_train_loop(
        state={"acc": 0},
        step_fn=step_fn,
        save_tree_fn=lambda s: {"acc": torch.tensor(s["acc"],
                                                    dtype=torch.int64)},
        restore_fn=lambda ck, st, s: {"acc": int(ck.restore(
            st, {"acc": torch.tensor(0, dtype=torch.int64)})["acc"])},
        checkpointer=Checkpointer(tmp_path, keep=3),
        total_steps=total, ckpt_every=ckpt_every,
        failure_injector=FailureInjector(fail_at))
    return report, trace


def test_failure_recovery_exact_state(tmp_path):
    clean, _ = _counter_loop(tmp_path / "clean", [])
    faulty, _ = _counter_loop(tmp_path / "faulty", [7, 13])
    assert faulty.restarts == 2
    assert faulty.final_step == clean.final_step == 20
    like = {"acc": torch.tensor(0, dtype=torch.int64)}
    a = Checkpointer(tmp_path / "clean").restore(20, like)
    b = Checkpointer(tmp_path / "faulty").restore(20, like)
    assert int(a["acc"]) == int(b["acc"])


def test_too_many_failures_raises(tmp_path):
    with pytest.raises(RuntimeError):
        _counter_loop(tmp_path, [3] * 7, total=5)


def test_restart_resumes_from_latest(tmp_path):
    report, trace = _counter_loop(tmp_path, [12])
    assert trace.count(10) == 2 and trace.count(11) == 2
    assert trace.count(12) == 1
    assert report.restarts == 1


def test_watchdog_trips():
    w = Watchdog(deadline_s=0.1)
    try:
        w.arm()
        time.sleep(0.3)
        with pytest.raises(StepTimeout):
            w.check()
    finally:
        w.stop()


def test_watchdog_ok_within_deadline():
    w = Watchdog(deadline_s=5.0)
    try:
        w.arm()
        w.check()
        w.disarm()
    finally:
        w.stop()


def test_straggler_accounting():
    s = StragglerStats()
    for _ in range(10):
        s.update(0.1)
    assert s.slow_steps == 0
    s.update(1.0)
    assert s.slow_steps == 1
    assert s.ewma_s < 0.2


# -- end to end: the port's driver against the reference's step --------------

def test_launch_train_restart_and_reference_trajectory(tmp_path):
    cfg = get_smoke("lm100m")
    steps, gb, seq = 8, 2, 32
    kw = dict(steps=steps, global_batch=gb, seq_len=seq, ckpt_every=2,
              log_every=0, device="cpu")
    clean = launch_train.train(cfg, ckpt_dir=tmp_path / "a", **kw)
    faulty = launch_train.train(cfg, ckpt_dir=tmp_path / "b", fail_at=[5],
                                **kw)
    assert faulty.restarts == 1 and faulty.final_step == steps
    la = [m["loss"] for m in clean.metrics_history]
    lb = [m["loss"] for m in faulty.metrics_history if m["step"] > 4]
    np.testing.assert_allclose(la[-1], lb[-1], rtol=1e-5)
    # steps 1-5, the failure before step 6, the restore of step 4, 5-8
    assert [m["step"] for m in faulty.metrics_history] == [
        1, 2, 3, 4, 5, 5, 6, 7, 8]
    np.testing.assert_allclose(lb[1:], la[4:], rtol=1e-5)
    np.testing.assert_allclose(lb[0], lb[1], rtol=1e-5)

    # the reference's step, fed host_batch, from the port's initial draw
    params = init_params(model_defs(cfg), seed=0, dtype=torch.float32,
                         device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
    tc = launch_train.default_train_config(cfg.name, gb, steps)
    jtc = jts.TrainConfig(opt=jadamw.AdamWConfig(
        total_steps=tc.opt.total_steps, warmup_steps=tc.opt.warmup_steps))
    from repro.configs import get_smoke as jget_smoke
    jstep = jax.jit(jts.make_train_step(jget_smoke("lm100m"), jtc))
    jopt = jadamw.init(jtc.opt, jparams)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb)
    ref_losses = []
    for step in range(steps):
        batch = {k: jnp.asarray(v)
                 for k, v in host_batch(dcfg, step, 0, gb).items()}
        jparams, jopt, met = jstep(jparams, jopt, batch)
        ref_losses.append(float(met["loss"]))
    np.testing.assert_allclose(la, ref_losses, rtol=1e-5)
