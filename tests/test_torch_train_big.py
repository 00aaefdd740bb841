"""The ≥100B training recipe held against the JAX package on the CPU: two
train steps of mixtral-8x22b, nemotron-4-340b and qwen1.5-110b smoke
under the reference's train config for ``BIG_ARCHS`` (``launch/specs.
default_train_config``: 4 microbatches, gradients accumulated in bf16,
block-wise 8-bit AdamW moments), each microbatch ``B × S = 4 × 32``.

Each step starts both packages from the reference's parameters and
optimizer state (its 8-bit moments after step 1 are non-zero, so step 2
holds the dequantisation too), with the harness of
``tests/test_torch_train_archs.py``: one numpy parameter tree, a numpy
batch.  Held: the loss and grad norm; the accumulated gradients (as the
port's ``make_train_step`` hands them to ``adamw.apply_updates``); each
moment's int8 codes and float32 block scales; the updated parameters.
mixtral's step overflows an expert (ROADMAP Queue 3, reference fault 3:
the dropped assignments must give the reference's gradients).

The reference's accumulated gradients are rebuilt from its own
``loss_fn`` a microbatch at a time, summed in bf16 as its ``accumulated``
sums them (``a + g.astype(bf16)`` from zeros, then × 1/4).  Tolerances:

- loss within ``LOSS_RTOL`` (1e-5) relative, grad norm within the
  configuration's float32 gradient tolerance ``tol`` (that of
  ``test_torch_train_archs``: twice its float32 noise, at least 1e-4);
- gradients: two packages whose float32 microbatch gradients lie ``n_i``
  apart can round each to a bf16 value one ulp apart, and each of the
  four sums to one ulp apart, so their accumulators lie at most ``δ = ¼
  Σ_i (ulp(g_i) + ulp(a_i) + n_i)`` apart (``ulp``: bf16's spacing at
  the value, taken 1 % up for a value that crosses a binade; ``a_i`` the
  partial sum; ``n_i = tol`` × the leaf's max |g_i|);
- codes and scales: the moment each package quantises lies within the
  interval its value takes over the gradient in ``[g − 2δ, g + 2δ]`` (the
  rebuilt gradient is itself ``δ`` from the one the reference's step
  summed) and either package's clip; its block's max |value| within the
  same interval's; so its code ``round(127 (|x| / A)^(1/p))`` lies
  between ``round(c_lo)`` and ``round(c_hi)`` — the interval's codes, a
  value within ``CODE_EPS`` of a rounding boundary rounded either way
  (one code step: the two packages' float32 ``pow`` may differ by an ulp)
  — with the value's sign where the interval keeps one, and
  its scale ``A / 127^p`` between the interval's, within 1e-6 relative;
- parameters: ``p − lr (u + wd p)`` with ``u = m̂ / (√v̂ + ε)`` from the
  unquantised moments, so the port's parameter lies within ``lr ×`` the
  spread of ``u`` over the same interval, plus rounding ``1e-6 (|p| +
  lr)`` (``ROUND``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.configs import SHAPES
from repro_torch.launch import specs as tspecs
from repro_torch.models import moe
from repro_torch.models.params import is_tensor, tensors, tree_map
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

from test_torch_lm_serving import both
from test_torch_train_archs import (F32_DEVIATION, GRAD_TOL, LOSS_RTOL,
                                    ROUND, _flat, _port_tree, _rel)

ARCHS = ["mixtral-8x22b", "nemotron-4-340b", "qwen1.5-110b"]
B, S = 4, 32                        # one microbatch
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
POWER = {"mu": 2, "nu": 4}
CODE_EPS = 1e-3       # a code this near a rounding boundary may go either way


def _configs(arch):
    """Both packages' ``BIG_ARCHS`` train config (the rule of a global
    batch of 256, as ``train_4k``), with the test's schedule."""
    jtc = jspecs.default_train_config(arch, JSHAPES["train_4k"])
    tc = tspecs.default_train_config(arch, SHAPES["train_4k"])
    assert (jtc.microbatches, jtc.opt.eightbit) == (4, True)
    assert jtc.grad_accum_dtype == jnp.bfloat16
    assert (tc.microbatches, tc.opt.eightbit, tc.grad_accum_dtype) == (
        4, True, torch.bfloat16)
    jtc = jts.TrainConfig(microbatches=4, grad_accum_dtype=jnp.bfloat16,
                          opt=jadamw.AdamWConfig(eightbit=True, **OPT))
    tc = ts.TrainConfig(microbatches=4, grad_accum_dtype=torch.bfloat16,
                        opt=adamw.AdamWConfig(eightbit=True, **OPT))
    return jtc, tc


def _batch(cfg, m: int, seed: int = 2):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (m * B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _ulp(x):
    """bf16's spacing at |x| (float64), taken 1 % up."""
    a = np.maximum(np.abs(x) * 1.01, 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _reference_accumulation(jcfg, jtc, jparams, batch, m, tol):
    """(the reference's accumulated gradients rebuilt, float64 leaves;
    the bound δ on two packages' accumulators, elementwise)."""
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: jts.loss_fn(p, jcfg, b, jtc), has_aux=True))
    acc = bound = None
    for i in range(m):
        mb = {k: jnp.asarray(v[i * B:(i + 1) * B]) for k, v in batch.items()}
        _, g = grad(jparams, mb)
        g = _flat(g)
        if acc is None:
            acc = {k: np.zeros(v.shape, jnp.bfloat16) for k, v in g.items()}
            bound = {k: np.zeros(v.shape) for k, v in g.items()}
        for k, gi in g.items():
            acc[k] = np.asarray(jnp.asarray(acc[k])
                                + jnp.asarray(gi).astype(jnp.bfloat16))
            noise = tol * float(np.max(np.abs(gi), initial=0.0))
            bound[k] += (_ulp(gi) + _ulp(acc[k].astype(np.float64))
                         + noise)
    return ({k: a.astype(np.float64) / m for k, a in acc.items()},
            {k: d / m for k, d in bound.items()})


def _moments(flat, name):
    """{leaf: (codes, scales)} of a flattened state's ``name`` tree."""
    out = {}
    for k, v in flat.items():
        head, _, field = k.rpartition(".")
        if head.startswith(f".{name}") or head.startswith(f"[{name}"):
            out.setdefault(head, {})[field] = v
    return {k: (v["q"], v["scale"]) for k, v in out.items()}


def _dq(q, s, p):
    """float64 value of 8-bit codes (blocks of 256 along the last axis)."""
    blk = np.arange(q.shape[-1]) // adamw.BLOCK
    qf = q.astype(np.float64)
    return np.sign(qf) * np.abs(qf) ** p * s[..., blk].astype(np.float64)


def _interval(before, g, delta, clips, b, p):
    """(low, high) of the moment's value ``b · before + (1 − b) · y``, with
    ``y = c g`` for the first moment and ``(c g)²`` for the second, over
    the gradient in ``[g − 2δ, g + 2δ]`` and each clip ``c``."""
    ends = np.stack([c * gg for c in clips
                     for gg in (g - 2 * delta, g + 2 * delta)])
    y_lo, y_hi = ends.min(0), ends.max(0)
    if p == 4:
        sq = np.stack([y_lo * y_lo, y_hi * y_hi])
        y_lo = np.where((y_lo <= 0) & (y_hi >= 0), 0.0, sq.min(0))
        y_hi = sq.max(0)
    return b * before + (1 - b) * y_lo, b * before + (1 - b) * y_hi


def _check_moment(q, s, interval, p, what):
    """Codes and scales of one 8-bit leaf against its values' interval
    (see the module's docstring)."""
    lo, hi = interval
    crosses = (lo <= 0) & (hi >= 0)
    a_lo = np.where(crosses, 0.0, np.minimum(np.abs(lo), np.abs(hi)))
    a_hi = np.maximum(np.abs(lo), np.abs(hi))
    last = q.shape[-1]
    nb = -(-last // adamw.BLOCK)
    pad = [(0, 0)] * (q.ndim - 1) + [(0, nb * adamw.BLOCK - last)]

    def block_max(x):
        x = np.pad(x, pad).reshape(x.shape[:-1] + (nb, adamw.BLOCK))
        return x.max(-1)

    amax_lo, amax_hi = block_max(a_lo), block_max(a_hi)
    den = 127.0 ** p
    assert np.all(s >= amax_lo / den * (1 - 1e-6)), f"{what}: scale low"
    assert np.all(s <= amax_hi / den * (1 + 1e-6)), f"{what}: scale high"
    blk = np.arange(last) // adamw.BLOCK
    top, bot = amax_hi[..., blk], amax_lo[..., blk]
    with np.errstate(divide="ignore", invalid="ignore"):
        c_lo = np.where(top > 0, 127 * (a_lo / top) ** (1 / p), 0.0)
        c_hi = np.where(bot > 0, 127 * np.minimum(1.0, a_hi / bot)
                        ** (1 / p), 127.0)
    mag = np.abs(q.astype(np.int64))
    q_lo = np.floor(c_lo - CODE_EPS + 0.5)
    q_hi = np.floor(np.minimum(c_hi, 127.0) + CODE_EPS + 0.5)
    bad = (mag < q_lo) | (mag > q_hi)
    assert not bad.any(), (f"{what}: {int(bad.sum())} codes outside their "
                           f"interval, e.g. {mag[bad][:4]} in "
                           f"[{q_lo[bad][:4]}, {q_hi[bad][:4]}]")
    if p == 2:
        sign = np.sign(lo)
        wrong = ~crosses & (q != 0) & (np.sign(q) != sign)
        assert not wrong.any(), f"{what}: {int(wrong.sum())} signs differ"


def _u(mu_before, nu_before, g, clip, step, opt):
    """u = m̂ / (√v̂ + ε) from the unquantised moments of gradient g."""
    m = opt.b1 * mu_before + (1 - opt.b1) * clip * g
    v = opt.b2 * nu_before + (1 - opt.b2) * (clip * g) ** 2
    return (m / (1 - opt.b1 ** step)) / (np.sqrt(v / (1 - opt.b2 ** step))
                                         + opt.eps)


@pytest.mark.parametrize("arch", ARCHS)
def test_big_recipe_steps_match_reference(arch, monkeypatch):
    jcfg, tcfg, jparams, _ = both(arch)
    jtc, tc = _configs(arch)
    m, opt = tc.microbatches, jtc.opt
    tol = max(GRAD_TOL, 2 * F32_DEVIATION[arch])
    batch = _batch(tcfg, m)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jstep = jax.jit(jts.make_train_step(jcfg, jtc))
    jopt = jadamw.init(jtc.opt, jparams)
    step = ts.make_train_step(tcfg, tc)
    # the step's accumulated gradients, as it hands them to the update
    seen = []
    real_update = adamw.apply_updates

    def update(opt_cfg, params, grads, state):
        seen.append(tree_map(lambda g: g.detach().clone(), grads, is_tensor))
        return real_update(opt_cfg, params, grads, state)

    monkeypatch.setattr(adamw, "apply_updates", update)
    dropped = 0
    for t in (1, 2):
        arrays = jax.tree.map(np.asarray, jparams)
        before = _flat(jax.tree.map(np.asarray, jopt))
        tparams = _port_tree(arrays, tcfg)
        topt = adamw.state_from_numpy(jax.tree.map(np.asarray, jopt),
                                      device="cpu")
        with moe.routing_log() as routes:
            tparams, topt, tmet = step(tparams, topt, tbatch)
        grads = seen.pop()
        for ids in routes:
            cap = moe._capacity(ids.shape[1], tcfg.moe)
            counts = torch.bincount(ids.reshape(-1),
                                    minlength=tcfg.moe.n_experts)
            dropped += int((counts - cap).clamp(min=0).sum())
        g_ref, delta = _reference_accumulation(jcfg, jtc, jparams, batch, m,
                                               tol)
        jparams, jopt, jmet = jstep(jparams, jopt, jbatch)

        for key in ("loss", "nll"):
            _rel(tmet[key], jmet[key], LOSS_RTOL)
        _rel(tmet["moe_aux"], jmet["moe_aux"], LOSS_RTOL, 1e-7)
        _rel(tmet["grad_norm"], jmet["grad_norm"], tol)
        _rel(tmet["lr"], jmet["lr"], 1e-6)
        for name, v in tmet.items():
            assert torch.isfinite(v), name

        # the accumulated gradients: the port's bf16 accumulator within δ
        # of the rebuilt reference's
        assert all(g.dtype == torch.bfloat16 for g in tensors(grads))
        got = _flat(tree_map(lambda g: g.float(), grads, is_tensor))
        assert got.keys() == g_ref.keys()
        for k, w in g_ref.items():
            over = np.abs(got[k].astype(np.float64) - w) - delta[k]
            assert float(np.max(over, initial=-1.0)) <= 0, \
                f"grad {t} {k}: over by {float(np.max(over)):.3g}"

        clips = [min(1.0, 1.0 / (float(x) + 1e-9))
                 for x in (jmet["grad_norm"], tmet["grad_norm"])]
        state_t = _flat(jax.tree.map(np.asarray, topt))
        state_j = _flat(jax.tree.map(np.asarray, jopt))
        p_port, p_ref = _flat(tparams), _flat(jparams)
        moments = {}
        for name, b in (("mu", opt.b1), ("nu", opt.b2)):
            p = POWER[name]
            prev, port, ref_ = (_moments(x, name)
                                for x in (before, state_t, state_j))
            assert port.keys() == ref_.keys() == prev.keys()
            for leaf, (q, s) in port.items():
                key = leaf[len(name) + 1:]
                assert q.dtype == np.int8 and s.dtype == np.float32
                assert q.shape == ref_[leaf][0].shape
                old = _dq(*prev[leaf], p)
                span = _interval(old, g_ref[key], delta[key], clips, b, p)
                _check_moment(q, s, span, p, f"{name} {t} {key}")
                _check_moment(ref_[leaf][0], ref_[leaf][1], span, p,
                              f"reference {name} {t} {key}")
                moments.setdefault(key, {})[name] = old

        # parameters: within lr × the spread of u over the interval
        lr = float(jmet["lr"])
        for k, want in p_ref.items():
            mu0, nu0 = moments[k]["mu"], moments[k]["nu"]
            g_port = got[k].astype(np.float64)
            us = [_u(mu0, nu0, g_port, clips[1], t, opt)]
            for c in clips:
                for gg in (g_ref[k] - 2 * delta[k], g_ref[k] + 2 * delta[k]):
                    us.append(_u(mu0, nu0, gg, c, t, opt))
            us = np.stack(us)
            spread = np.maximum(np.abs(us - us[0]).max(0),
                                us.max(0) - us.min(0))
            gap = np.abs(p_port[k].astype(np.float64) - want)
            bound = lr * spread + ROUND * (np.abs(want) + lr)
            worst = float(np.max(gap - bound, initial=-1.0))
            assert worst <= 0, f"param {k} after step {t}: over by {worst:.3g}"
    if tcfg.moe is not None:
        assert dropped > 0, "no expert overflowed its capacity"
