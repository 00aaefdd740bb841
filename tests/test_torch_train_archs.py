"""One and two train steps of the port (``repro_torch.train``) held
against the JAX package's ``make_train_step`` on the CPU, for each of the
seven dense smoke configurations here and the MoE, Mamba and RWKV-6 ones
in ``tests/test_torch_train_recurrent.py`` (``B, S = 2, 32`` as in
``tests/test_arch_smoke.py``), float32 AdamW.

One parameter tree is drawn from a numpy seed (``numpy_params`` of
``tests/test_torch_lm_serving.py``: every leaf, biases and norm scales
too) and handed to both packages; the batch is numpy too.  The second
step starts both packages from the reference's parameters and optimizer
state after the first (``params_from_numpy``, ``state_from_numpy``), so
its moments are non-zero and each step is held on its own.

Tolerances (float32):
- loss and nll within 1e-5 relative (``LOSS_RTOL``); moe_aux likewise
  (absolute 1e-7 where it is 0); accuracy within one position;
- every gradient leaf within the configuration's gradient tolerance ×
  the leaf's max |value|, and grad_norm within it relative.  The reference's gradients are
  read from its first moment after the step, ``mu = b1 · mu_before +
  (1 - b1) · clip · g``, with ``clip`` from its grad_norm; the float32
  rounding of the reference's ``b1 · mu_before`` and of its sum (an ulp
  of each) divided by ``(1 - b1) · clip`` is added to the tolerance of
  each element, since at step 2 the subtraction cancels most of ``mu``.
  The gradient tolerance of a configuration is twice its float32 noise,
  and not below ``GRAD_TOL`` = 1e-4: with random weights the smoke
  models' gradients are ill-conditioned in float32, some (whisper-base's
  encoder, gemma3, jamba) badly.  ``F32_DEVIATION`` is that noise as
  measured: the largest deviation, over leaves and over the two steps'
  starting points, of either package's float32 gradient from the same
  port run with float64 parameters and inputs (its float32 islands, the
  norms and the attention softmax, kept), as a share of the leaf's max
  |value|.  The two packages then lay at most 1.70e-3 apart (whisper-base
  step 1; grad_norm 8.5e-4 apart, the port's 7e-5 from the float64
  run's, the reference's 9.3e-4), and at most 1.33e-4 for a
  configuration whose noise is under 1e-4;
- first and second moments after each step within the gradient tolerance
  and twice it (the second moment is quadratic in g) × the leaf's max;
- parameters after each step within a bound derived from the update.
  A step sets p ← p − lr·(u + wd·p) with u = m̂ / (√v̂ + ε) from that
  package's moments (at step 1, m̂ = clip·g and v̂ = (clip·g)², so u =
  g/(|g| + ε)).  Both packages start the step from the same p, so |p_port
  − p_ref| after it is at most lr·|u_port − u_ref|, computed from the two
  packages' moments, plus rounding: 1e-6 × (|p| + lr) (``ROUND``).  Where
  |g| is near ε or 0, u is ill-conditioned and the two packages may put a
  parameter up to 2·lr apart; the bound admits exactly that.

The microbatched step (``microbatches=2``) is held the same way against
the reference's scan accumulation (``tests/test_torch_train_recurrent.py``);
MoE configurations cover the capacity overflow (ROADMAP Queue 3,
reference fault 3), whose dropped writes must give the reference's
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.models import transformer as port_tr
from repro_torch.models.params import params_from_numpy, tree_items
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

from test_torch_lm_serving import DENSE, both

B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
F32_DEVIATION = {
    "lm100m": 6.41e-5, "qwen2.5-3b": 8.44e-5, "qwen1.5-110b": 6.42e-5,
    "nemotron-4-340b": 4.20e-5, "gemma3-1b": 5.11e-4,
    "internvl2-26b": 1.27e-4, "whisper-base": 2.31e-3,
    "mixtral-8x22b": 1.43e-4, "moonshot-v1-16b-a3b": 2.73e-4,
    "jamba-1.5-large-398b": 9.39e-4, "rwkv6-7b": 1.49e-4}
ROUND = 1e-6
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def batch_of(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)
    s_tok = S - cfg.frontend_prefix
    out = {"tokens": rng.integers(0, cfg.vocab, (B, s_tok)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, s_tok)).astype(np.int32)}
    if cfg.frontend_prefix:
        out["prefix_embed"] = rng.normal(
            0, 0.02, (B, cfg.frontend_prefix, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.normal(
            0, 0.02, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _flat(tree):
    """{path: leaf as numpy} of a jax or torch tree in the reference's
    order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    return {jax.tree_util.keystr(p): (x.detach().numpy()
                                      if isinstance(x, torch.Tensor)
                                      else np.asarray(x))
            for p, x in flat}


def _check_leaves(got, want, tol, what, extra=None):
    """Each leaf within ``tol`` × its max |value| (plus ``extra``'s leaf,
    elementwise, where given)."""
    got, want = _flat(got), _flat(want)
    extra = _flat(extra) if extra is not None else {}
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(1e-30, float(np.max(np.abs(w), initial=0.0)))
        over = np.abs(got[k] - w) - tol * scale - extra.get(k, 0.0)
        worst = float(np.max(over, initial=-1.0))
        assert worst <= 0, f"{what} {k}: over by {worst:.3g} (max {scale:.3g})"


def _rel(got, want, rtol, atol=0.0):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want) + atol, (got, want)


def _update(mu, nu, step: int, opt):
    """u = m̂ / (√v̂ + ε) of a package's moments after step ``step``."""
    bc1 = 1 - opt.b1 ** step
    bc2 = 1 - opt.b2 ** step
    mu, nu = np.asarray(mu, np.float64), np.asarray(nu, np.float64)
    return (mu / bc1) / (np.sqrt(nu / bc2) + opt.eps)


def _check_params(p_port, p_ref, state_port, state_ref, step, lr, opt):
    """Parameters after a step from the same parameters within the
    derived bound."""
    pp, pr = _flat(p_port), _flat(p_ref)
    mp, mr = _flat(state_port.mu), _flat(state_ref.mu)
    vp, vr = _flat(state_port.nu), _flat(state_ref.nu)
    for k, want in pr.items():
        gap = np.abs(pp[k].astype(np.float64) - want)
        du = np.abs(_update(mp[k], vp[k], step, opt)
                    - _update(mr[k], vr[k], step, opt))
        bound = lr * du + ROUND * (np.abs(want) + lr)
        worst = float(np.max(gap - bound, initial=-1.0))
        assert worst <= 0, f"param {k} after step {step}: over by {worst:.3g}"


def _port_tree(arrays, tcfg):
    params = params_from_numpy(port_tr.model_defs(tcfg), arrays,
                               device="cpu")
    for _, p in tree_items(params, lambda x: isinstance(x, torch.Tensor)):
        p.requires_grad_(True)
    return params


def steps_match_reference(arch: str, microbatches: int):
    """Steps 1 and 2 of ``arch``'s smoke config, each from the reference's
    tree, held to the reference's (the tolerances above)."""
    jcfg, tcfg, jparams, _ = both(arch)
    tol = max(GRAD_TOL, 2 * F32_DEVIATION[arch])
    batch = batch_of(tcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jtc = jts.TrainConfig(microbatches=microbatches,
                          opt=jadamw.AdamWConfig(**OPT))
    tc = ts.TrainConfig(microbatches=microbatches,
                        opt=adamw.AdamWConfig(**OPT))
    jstep = jax.jit(jts.make_train_step(jcfg, jtc))
    jopt = jadamw.init(jtc.opt, jparams)
    grad_fn = ts.make_grad_fn(tcfg, tc)
    step = ts.make_train_step(tcfg, tc)
    b1 = jtc.opt.b1
    for t in (1, 2):
        # both packages start the step from the reference's tree
        arrays = jax.tree.map(np.asarray, jparams)
        mu_before = jax.tree.map(np.asarray, jopt.mu)
        tparams = _port_tree(arrays, tcfg)
        topt = adamw.state_from_numpy(jax.tree.map(np.asarray, jopt),
                                      device="cpu")
        _, _, grads = grad_fn(_port_tree(arrays, tcfg), tbatch)
        jparams, jopt, jmet = jstep(jparams, jopt, jbatch)
        tparams, topt, tmet = step(tparams, topt, tbatch)
        for key in ("loss", "nll"):
            _rel(tmet[key], jmet[key], LOSS_RTOL)
        _rel(tmet["moe_aux"], jmet["moe_aux"], LOSS_RTOL, 1e-7)
        assert abs(float(tmet["accuracy"]) - float(jmet["accuracy"])) \
            <= 1.0 / (B * S) + 1e-7
        _rel(tmet["grad_norm"], jmet["grad_norm"], tol)
        _rel(tmet["lr"], jmet["lr"], 1e-6)
        clip = min(1.0, 1.0 / (float(jmet["grad_norm"]) + 1e-9))
        jgrads = jax.tree.map(
            lambda m, m0: (np.asarray(m, np.float64) - b1 * m0)
            / ((1 - b1) * clip), jopt.mu, mu_before)
        ulp = jax.tree.map(
            lambda m, m0: (np.spacing(np.abs(np.asarray(m, np.float32)))
                           + np.spacing(np.float32(b1) * np.abs(m0))
                           ).astype(np.float64) / ((1 - b1) * clip),
            jopt.mu, mu_before)
        _check_leaves(grads, jgrads, tol, f"grad {t}", ulp)
        _check_leaves(topt.mu, jopt.mu, tol, f"mu {t}")
        _check_leaves(topt.nu, jopt.nu, 2 * tol, f"nu {t}")
        _check_params(tparams, jparams, topt, jopt, t, float(jmet["lr"]),
                      jtc.opt)
        for name, v in tmet.items():
            assert torch.isfinite(v), name


@pytest.mark.parametrize("arch", DENSE)
def test_train_steps_match_reference(arch):
    steps_match_reference(arch, 1)
