"""The port's training pieces on the CPU: the chunked loss against the JAX
package's, remat (``none``/``dots``/``full``) and its recompute under the
forward's modes, ``grad_cast``, the attention op's plain backward, the
MoE router's gradient, and the train config rules.

Tolerances (float32): the loss's nll and accuracy within 1e-6 relative
of the reference's (``LOSS_RTOL``: one chunked sum in a different
order); gradients under the three remat policies within 1e-6 × the
leaf's max |value| of each other (``REMAT_TOL``: the recompute runs the
same operations); the attention op's plain-backward gradients within
1e-5 × max |value| of ``attention_ref``'s own (``ATTN_TOL``: two
float32 attention schedules, one chunked); a model's gradients with
``attention_ref`` standing in for the kernel's forward within 1e-4 × max
|value| of the plain path's (``PATH_TOL``: the two forwards differ by
float32 rounding in every layer, as the kernel's and the plain version's
do on the card); the MoE gradients within 1e-5 × max |value| of the
reference's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.train import losses as jlosses
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, moe
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.params import tree_items
from repro_torch.train import losses
from repro_torch.train import train_step as ts

from test_torch_lm_serving import both, numpy_params
from test_torch_train_archs import batch_of

LOSS_RTOL = 1e-6
REMAT_TOL = 1e-6
ATTN_TOL = 1e-5
PATH_TOL = 1e-4


def _leaves(tree):
    return [x for _, x in tree_items(tree, lambda x: isinstance(
        x, torch.Tensor))]


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= tol * max(1e-30, float(np.max(np.abs(want), initial=0.0))), err


@pytest.mark.parametrize("s, chunk, masked", [(32, 16, False),
                                              (24, 16, False),
                                              (24, 16, True),
                                              (30, 512, True)])
def test_chunked_softmax_xent_matches_reference(s, chunk, masked):
    """nll and accuracy at a ragged S (24 with chunk 16 takes 12) and with
    a mask."""
    jcfg, tcfg, jparams, tparams = both("lm100m")
    rng = np.random.default_rng(s + masked)
    h = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab, (2, s)).astype(np.int32)
    mask = rng.random((2, s)) < 0.6 if masked else None
    nll, acc = losses.chunked_softmax_xent(
        tparams, tcfg, torch.from_numpy(h), torch.from_numpy(labels),
        chunk=chunk, mask=None if mask is None else torch.from_numpy(mask))
    jnll, jacc = jlosses.chunked_softmax_xent(
        jparams, jcfg, jnp.asarray(h), jnp.asarray(labels), chunk=chunk,
        mask=None if mask is None else jnp.asarray(mask))
    assert abs(float(nll) - float(jnll)) <= LOSS_RTOL * abs(float(jnll))
    assert abs(float(acc) - float(jacc)) <= LOSS_RTOL


def _grads(cfg, params, batch, **tc):
    loss, metrics, grads = ts.make_grad_fn(cfg, ts.TrainConfig(**tc))(
        params, batch)
    return loss, metrics, grads


def _port(arch, seed=0):
    _, tcfg, _, tparams = both(arch, seed)
    for p in _leaves(tparams):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in batch_of(tcfg).items()}
    return tcfg, tparams, batch


@pytest.mark.parametrize("arch", ["lm100m", "moonshot-v1-16b-a3b",
                                  "whisper-base", "jamba-1.5-large-398b"])
def test_remat_policies_give_the_same_gradients(arch):
    """``none``, ``dots`` and ``full`` (decoder, tail and encoder blocks
    checkpointed) give the same loss and gradients."""
    cfg, params, batch = _port(arch)
    out = {r: _grads(dataclasses.replace(cfg, remat=r), params, batch)
           for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert float(out[r][0]) == pytest.approx(float(out["none"][0]),
                                                 rel=REMAT_TOL)
        for g, want in zip(_leaves(out[r][2]), _leaves(out["none"][2])):
            _close(g, want.numpy(), REMAT_TOL)


def test_remat_only_under_grad(monkeypatch):
    """Serving (no grad) runs the blocks unwrapped."""
    from repro_torch.models import transformer
    cfg, params, batch = _port("lm100m")
    cfg = dataclasses.replace(cfg, remat="full")
    wrapped = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **kw: wrapped.append(1) or real(*a, **kw))
    with torch.inference_mode():
        transformer.forward(params, cfg, batch["tokens"])
    assert wrapped == []
    transformer.forward(params, cfg, batch["tokens"])
    assert len(wrapped) == cfg.n_layers


@pytest.fixture
def kernel_stand_in(monkeypatch):
    """CPU attention takes the kernel's branch of ``layers.attention``
    (outside ``plain_attention``), with ``attention_ref`` standing in for
    the launch that ``ops.with_plain_backward`` makes; returns the list of
    stand-in launches."""
    launched = []

    def fake(q, k, v, *, causal, window, q_offset, backend):
        launched.append(tuple(q.shape))
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)

    monkeypatch.setattr(layers, "uses_kernel",
                        lambda x: not layers.plain_mode())
    monkeypatch.setattr(ops, "attention", fake)
    return launched


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_recompute_runs_under_the_forward_mode(kernel_stand_in, remat):
    """A checkpointed block's recompute runs during ``backward()``: it must
    take the attention path its forward took, whatever scope
    ``backward()`` runs in."""
    cfg, params, batch = _port("lm100m")
    cfg = dataclasses.replace(cfg, remat=remat)
    grad_fn = ts.make_grad_fn(cfg, ts.TrainConfig())
    n = cfg.n_layers
    # forward on the plain path, backward outside the scope: no launch
    with layers.plain_attention():
        loss, _ = ts.loss_fn(params, cfg, batch, ts.TrainConfig())
    torch.autograd.grad(loss, _leaves(params))
    assert kernel_stand_in == []
    # forward on the kernel path, backward inside plain_attention: the
    # recompute launches again, once a layer
    loss, _ = ts.loss_fn(params, cfg, batch, ts.TrainConfig())
    assert len(kernel_stand_in) == n
    with layers.plain_attention():
        kernel_grads = torch.autograd.grad(loss, _leaves(params))
    assert len(kernel_stand_in) == 2 * n
    # the kernel path's gradients are the plain path's
    with layers.plain_attention():
        _, _, plain_grads = grad_fn(params, batch)
    for g, want in zip(kernel_grads, _leaves(plain_grads)):
        _close(g, want.numpy(), PATH_TOL)


def test_recompute_keeps_the_routing_log(kernel_stand_in):
    """Under remat an MoE layer logs its routing once (the forward), and a
    replay dispatches the recompute to the replayed experts: gradients
    equal those of the same replay without remat."""
    cfg, params, batch = _port("moonshot-v1-16b-a3b")
    n_moe = sum(cfg.moe_layers())
    tc = ts.TrainConfig()
    with moe.routing_log() as log:
        loss, _ = ts.loss_fn(params, dataclasses.replace(cfg, remat="full"),
                             batch, tc)
        assert len(log) == n_moe
        torch.autograd.grad(loss, _leaves(params))
    assert len(log) == n_moe
    replay = [torch.roll(ids, 1, dims=1) for ids in log]    # other experts
    out = {}
    for remat in ("none", "full"):
        with moe.routing_log(replay=replay) as seen:
            out[remat] = _grads(dataclasses.replace(cfg, remat=remat),
                                params, batch)
        assert len(seen) == n_moe
    assert float(out["full"][0]) == pytest.approx(float(out["none"][0]),
                                                  rel=REMAT_TOL)
    for g, want in zip(_leaves(out["full"][2]), _leaves(out["none"][2])):
        _close(g, want.numpy(), REMAT_TOL)


def test_grad_cast_casts_the_cotangent():
    x = torch.randn(6, dtype=torch.bfloat16, requires_grad=True)
    y = layers.grad_cast(x)
    assert y.grad_fn is not None and torch.equal(y, x)
    ct = torch.linspace(-1, 1, 6, dtype=torch.float32) / 3
    ctx = type("Ctx", (), {"dtype": torch.bfloat16})()
    cast = layers._GradCast.backward(ctx, ct)
    assert cast.dtype == torch.bfloat16 and torch.equal(cast, ct.bfloat16())
    w = torch.linspace(1, 2, 6)
    (g,) = torch.autograd.grad((layers.grad_cast(x).float() * w).sum(), x)
    assert g.dtype == torch.bfloat16 and torch.equal(g, w.bfloat16())
    with torch.no_grad():
        assert layers.grad_cast(x) is x


@pytest.mark.parametrize("shape, kw", [
    ((2, 4, 2, 24, 24, 16), dict(causal=True)),
    ((1, 4, 1, 40, 40, 16), dict(causal=True, window=12)),
    ((2, 2, 2, 8, 24, 16), dict(causal=True, q_offset=16)),
    ((1, 2, 2, 12, 20, 16), dict(causal=False))])
def test_attention_plain_backward(shape, kw):
    """``ops.with_plain_backward``, with ``attention_ref`` standing in for
    the launch and ``chunked_attention`` as the plain version: the output
    carries a ``grad_fn``, and the gradients are ``attention_ref``'s."""
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(sq + skv)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            requires_grad=True)
               for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    launch = functools.partial(ref.attention_ref, **kw)
    plain = functools.partial(layers.chunked_attention, q_chunk=8,
                              kv_chunk=8, **kw)
    out = ops.with_plain_backward(launch, plain, q, k, v)
    assert out.grad_fn is not None
    assert "PlainBackward" in type(out.grad_fn).__name__
    ct = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), ct)
    want = torch.autograd.grad(ref.attention_ref(q, k, v, **kw), (q, k, v),
                               ct)
    for g, w in zip(got, want):
        _close(g, w.numpy(), ATTN_TOL)
    # only q requires grad: k and v get none
    q2 = q.detach().requires_grad_(True)
    out = ops.with_plain_backward(launch, plain, q2, k.detach(), v.detach())
    (gq,) = torch.autograd.grad(out, (q2,), ct)
    _close(gq, want[0].numpy(), ATTN_TOL)
    # no grad, or inference: the launch alone, no graph
    for scope in (torch.no_grad, torch.inference_mode):
        with scope():
            assert ops.with_plain_backward(launch, plain, q, k, v
                                           ).grad_fn is None


def _moe_cfgs(cf=8.0):
    return (ModelConfig("x", 1, 32, 4, 4, 64, 97,
                        moe=MoEConfig(4, 2, 64, capacity_factor=cf)),
            JModelConfig("x", 1, 32, 4, 4, 64, 97,
                         moe=JMoEConfig(4, 2, 64, capacity_factor=cf)))


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_grad_flows_through_router(cf):
    """``tests/test_models_property.py::test_moe_grad_flows_through_router``
    in the port, and its gradients against the reference's, with room for
    every token (8.0) and with experts that overflow (0.5)."""
    cfg, jcfg = _moe_cfgs(cf)
    arrays = numpy_params(jmoe.moe_defs(jcfg), 3)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 8, 32)).astype(np.float32)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    out, _ = moe.moe_apply(p, cfg, torch.from_numpy(x))
    names = sorted(p)
    grads = dict(zip(names, torch.autograd.grad(
        torch.sum(out ** 2), [p[k] for k in names])))
    assert float(grads["router"].abs().sum()) > 0   # gates carry grad
    jgrads = jax.grad(lambda jp: jnp.sum(jmoe.moe_apply(
        jp, jcfg, jnp.asarray(x))[0] ** 2))(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    for k in names:
        _close(grads[k], jgrads[k], 1e-5)


def test_train_step_refuses_pod_compression():
    """``grad_compression="int8_pod"`` is the reference's no-op without a
    mesh ``pod`` axis: the step equals the uncompressed one bit for bit
    (an unknown compression is refused)."""
    from repro_torch.optim import adamw
    from repro_torch.train.distributed import compressed_pod_allreduce
    cfg, _, batch = _port("lm100m")
    out = {}
    for comp in (None, "int8_pod"):
        _, params, _ = _port("lm100m")
        tc = ts.TrainConfig(grad_compression=comp)
        params, _, metrics = ts.make_train_step(cfg, tc)(
            params, adamw.init(tc.opt, params), batch)
        out[comp] = (float(metrics["loss"]), _leaves(params))
    assert out[None][0] == out["int8_pod"][0]
    for a, b in zip(out[None][1], out["int8_pod"][1]):
        assert torch.equal(a, b)
    grads = {"w": torch.ones(3)}
    assert compressed_pod_allreduce(grads) is grads
    with pytest.raises(ValueError):
        ts.make_train_step(cfg, ts.TrainConfig(grad_compression="fp8"))


@pytest.mark.parametrize("arch, batch, micro, big", [
    ("lm100m", 32, 1, False), ("qwen2.5-3b", 64, 4, False),
    ("mixtral-8x22b", 8, 1, True), ("nemotron-4-340b", 256, 4, True)])
def test_default_train_config(arch, batch, micro, big):
    """The reference's ``launch/specs.default_train_config`` rule."""
    tc = launch_train.default_train_config(arch, batch, 200)
    assert tc.microbatches == micro
    assert tc.opt.eightbit is big
    assert tc.grad_accum_dtype == (torch.bfloat16 if big else torch.float32)
    assert (tc.opt.total_steps, tc.opt.warmup_steps) == (200, 10)


def test_metrics_stay_on_the_device():
    cfg, params, batch = _port("lm100m")
    tc = ts.TrainConfig()
    from repro_torch.optim import adamw
    _, _, metrics = ts.make_train_step(cfg, tc)(
        params, adamw.init(tc.opt, params), batch)
    assert sorted(metrics) == ["accuracy", "grad_norm", "loss", "lr",
                               "moe_aux", "nll"]
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               and not v.requires_grad for v in metrics.values())
