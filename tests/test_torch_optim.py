"""The port's AdamW (``repro_torch.optim.adamw``) held against the JAX
package's (``repro.optim.adamw``) on the CPU, and the six behaviours of
``tests/test_optim.py`` as port tests.

Inputs are drawn from a numpy seed and handed to both packages.  Each
step of a three-step run starts both packages from the reference's
parameters and state (``adamw.state_from_numpy``), so a step is held on
its own.  Tolerances (float32 throughout): parameters, float32 moments,
``grad_norm`` and ``lr`` within 1e-6 relative (``RTOL``; an absolute
floor of 1e-6 × the leaf's largest value).  8-bit moments: ``_q8`` on
the same values gives scales within 1e-7 relative (``SCALE_RTOL``) and
int8 codes equal but where the code's float magnitude lies within 1e-6
(relative) of a .5 rounding edge, where one code of difference is
allowed.  Inside ``apply_updates`` the moments are quantised from
``g · clip``, and ``clip = 1 / grad_norm`` when the gradients clip:
``grad_norm`` is a float32 sum whose order differs between the two
packages (an ulp or two, within ``RTOL``), so there the scales are held
to ``RTOL`` and the codes to the same edge rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

RTOL = 1e-6
SCALE_RTOL = 1e-7


def _draw(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


# a matrix (decayed), a vector (not decayed), a stacked leaf whose last
# axis is no multiple of the 8-bit block
SHAPES = {"w": (16, 300), "b": (300,), "stack": (3, 8, 520)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=rtol * max(1e-30, float(np.max(np.abs(want)))))


def _check_codes(q_port, q_ref, m_float, scale, power):
    """One code of difference only where |m|/scale, to the power 1/power,
    is within 1e-6 (relative) of a .5 rounding edge."""
    q_port, q_ref = q_port.numpy().astype(int), np.asarray(q_ref, int)
    diff = np.abs(q_port - q_ref)
    assert diff.max(initial=0) <= 1
    if diff.any():
        last = m_float.shape[-1]
        blocks = np.repeat(np.asarray(scale, np.float64), jadamw.BLOCK,
                           axis=-1)[..., :last]
        mag = (np.abs(m_float) / np.where(blocks == 0, 1, blocks)) ** (
            1.0 / power)
        edge = np.abs(mag - np.floor(mag) - 0.5) <= 1e-6 * np.maximum(mag, 1)
        assert edge[diff == 1].all()


@pytest.mark.parametrize("eightbit", [False, True])
@pytest.mark.parametrize("start", [0, 1, 100, 10_000])
def test_apply_updates_matches_reference(eightbit, start):
    """Three steps from state step ``start``: each step's parameters,
    moments, grad_norm and lr equal the reference's."""
    cfg_kw = dict(lr=3e-3, eightbit=eightbit, warmup_steps=10,
                  total_steps=1000, grad_clip=1.0)
    jcfg, cfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    rng = np.random.default_rng(start + eightbit)
    params = _draw(rng, SHAPES)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jadamw.init(jcfg, jparams)._replace(step=jnp.int32(start))
    for i in range(3):
        # the second step's gradients clip (norm > 1), the others do not
        grads = _draw(rng, SHAPES, scale=0.3 if i == 1 else 0.004)
        prev = _np(jstate)
        state = adamw.state_from_numpy(prev, device="cpu")
        new_p, new_s, met = adamw.apply_updates(
            cfg, _torch(_np(jparams)), _torch(grads), state)
        jparams, jstate, jmet = jadamw.apply_updates(
            jcfg, jparams, {k: jnp.asarray(v) for k, v in grads.items()},
            jstate)
        assert int(new_s.step) == int(jstate.step) == start + i + 1
        _close(met["grad_norm"], jmet["grad_norm"])
        _close(met["lr"], jmet["lr"])
        clip = min(1.0, 1.0 / (float(jmet["grad_norm"]) + 1e-9))
        for k in SHAPES:
            _close(new_p[k], jparams[k])
            g = grads[k].astype(np.float64) * clip
            for name, power, beta, new in (("mu", 2, jcfg.b1, g),
                                           ("nu", 4, jcfg.b2, g * g)):
                got, want = getattr(new_s, name)[k], getattr(jstate, name)[k]
                if not eightbit:
                    _close(got, want)
                    continue
                old = getattr(prev, name)[k]
                m = beta * np.asarray(jadamw._dq8(
                    jnp.asarray(old.q), jnp.asarray(old.scale), power),
                    np.float64) + (1 - beta) * new
                _close(got.scale, want.scale)
                _check_codes(got.q, want.q, m, want.scale, power)


@pytest.mark.parametrize("step", [0, 1, 100, 10_000])
def test_lr_at_matches_reference(step):
    kw = dict(lr=1e-3, warmup_steps=100, total_steps=10_000)
    _close(adamw.lr_at(adamw.AdamWConfig(**kw), torch.tensor(step)),
           jadamw.lr_at(jadamw.AdamWConfig(**kw), jnp.int32(step)))


@pytest.mark.parametrize("power", [2, 4])
def test_q8_codes_match_reference(power):
    """Codes and scales of ``_q8`` equal the reference's on a draw with a
    zero block, a block of one value and a ragged last block."""
    rng = np.random.default_rng(power)
    x = (rng.standard_normal((5, 700)) * 10).astype(np.float32)
    x[1, :256] = 0.0
    x[2, 256:512] = 3.0
    if power == 4:
        x = x * x * 1e-4               # a second moment: ≥ 0, small
    q, s = adamw._q8(torch.from_numpy(x), power)
    jq, js = jadamw._q8(jnp.asarray(x), power)
    _close(s, js, SCALE_RTOL)
    _check_codes(q, jq, x.astype(np.float64), js, power)
    back = adamw._dq8(q, s, power)
    jback = jadamw._dq8(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                        power)
    _close(back, jback)


def test_state_from_numpy_carries_moments():
    rng = np.random.default_rng(3)
    jparams = {"w": jnp.asarray(rng.standard_normal((4, 300)), jnp.float32)}
    jstate = jadamw.init(jadamw.AdamWConfig(eightbit=True), jparams)
    state = adamw.state_from_numpy(_np(jstate), device="cpu")
    assert isinstance(state.mu["w"], adamw.Moment8)
    assert state.mu["w"].q.dtype == torch.int8
    assert state.mu["w"].scale.shape == (4, 2)
    assert state.step.dtype == torch.int32 and int(state.step) == 0


# -- the six behaviours of tests/test_optim.py -------------------------------

def _quadratic_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.tensor(rng.normal(size=(16, 300)), dtype=torch.float32,
                              requires_grad=True),
            "b": torch.tensor(rng.normal(size=(300,)), dtype=torch.float32,
                              requires_grad=True)}


def _run(cfg, steps=150, seed=0):
    params = _quadratic_params(seed)
    state = adamw.init(cfg, params)

    def loss(p):
        return sum(torch.mean((p[k] - 1.0) ** 2) for k in sorted(p))

    for _ in range(steps):
        names = sorted(params)
        grads = torch.autograd.grad(loss(params), [params[k] for k in names])
        params, state, metrics = adamw.apply_updates(
            cfg, params, dict(zip(names, grads)), state)
    with torch.no_grad():
        return float(loss(params)), params, metrics


def test_adamw_converges():
    final, _, metrics = _run(adamw.AdamWConfig(
        lr=5e-2, weight_decay=0.0, warmup_steps=1, total_steps=200))
    assert final < 0.05
    assert np.isfinite(float(metrics["grad_norm"]))


def test_eightbit_tracks_f32():
    kw = dict(lr=5e-2, weight_decay=0.0, warmup_steps=1, total_steps=200)
    f32, p32, _ = _run(adamw.AdamWConfig(**kw))
    f8, p8, _ = _run(adamw.AdamWConfig(eightbit=True, **kw))
    assert f8 < 0.1                     # still converges
    for k in p32:                       # trajectories stay close
        assert float((p32[k] - p8[k]).detach().abs().mean()) < 0.05


def test_eightbit_moment_is_param_shaped():
    st = adamw.init(adamw.AdamWConfig(eightbit=True),
                    {"w": torch.zeros((8, 300))})
    assert st.mu["w"].q.shape == (8, 300)
    assert st.mu["w"].scale.shape == (8, 2)    # ceil(300/256) = 2 blocks


def test_q8_roundtrip_bounded_error():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(4, 700)) * 10, dtype=torch.float32)
    q, s = adamw._q8(x, 2)
    err = (adamw._dq8(q, s, 2) - x).abs().numpy()
    # power-2 code: relative error ~2/127 of magnitude + floor scale/127²
    xa = x.abs().numpy()
    rel = err / np.maximum(xa, 1e-6)
    big = xa > xa.max() / 50
    assert rel[big].max() < 0.05


def test_grad_clip():
    cfg = adamw.AdamWConfig(lr=1e-3, grad_clip=1e-3, warmup_steps=1)
    params = {"w": torch.ones((4, 4))}
    before = params["w"].clone()
    state = adamw.init(cfg, params)
    new_params, _, m = adamw.apply_updates(
        cfg, params, {"w": torch.full((4, 4), 1e6)}, state)
    assert float(m["grad_norm"]) > 1e5
    # step is bounded by lr regardless of gradient magnitude
    assert float((new_params["w"] - before).abs().max()) < 2 * cfg.lr


def test_lr_schedule_shape():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    lrs = [float(adamw.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1.0) < 1e-6            # end of warmup
    assert lrs[-1] == pytest.approx(0.1, rel=1e-3)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))  # decay


def test_update_in_chunks_equals_whole(monkeypatch):
    """A leaf updated ``UPDATE_CHUNK`` values at a time gets the values it
    gets in one piece (the update is elementwise along its leading axis)."""
    rng = np.random.default_rng(5)
    shapes = {"stack": (5, 4, 300), "b": (300,)}
    params, grads = _draw(rng, shapes), _draw(rng, shapes, 0.1)
    out = {}
    for chunk in (adamw.UPDATE_CHUNK, 1200):
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
        for eightbit in (False, True):
            cfg = adamw.AdamWConfig(eightbit=eightbit, warmup_steps=1)
            p = _torch(params)
            st = adamw.init(cfg, p)
            for _ in range(2):
                p, st, _ = adamw.apply_updates(cfg, p, _torch(grads), st)
            out[chunk, eightbit] = p
    for eightbit in (False, True):
        for k in shapes:
            assert torch.equal(out[adamw.UPDATE_CHUNK, eightbit][k],
                               out[1200, eightbit][k])
