"""The port's MoE, Mamba and RWKV-6 functions held against the JAX package
on the CPU, on the draws of ``tests/test_models_property.py``.

Each case draws its inputs (and, where the reference's property test
does, its parameters through the JAX package's ``init_params``) once,
hands them to both packages as numpy arrays, and requires the port's
result within ``TOL`` (float32) of the reference's, times ``max(1, max
|reference value|)``; where the property test also holds the reference to
an oracle (the sequential WKV recurrence, the two-halves Mamba scan), the
port is held to the same oracle with the property test's tolerances.

MoE routing is compared exactly: the experts each token picks
(``top_k``, ties to the lower index as ``jax.lax.top_k``), which
assignments the capacity keeps, and the reference's handling of an
expert that overflows (its last slot ends up holding the pad row: XLA's
in-order scatter writes the dropped assignments there after the kept
one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.params import init_params as jinit_params
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.config import ModelConfig, MoEConfig

TOL = 1e-5


def close(got: torch.Tensor, want, tol: float = TOL, what: str = "") -> None:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.max(np.abs(got - want)))
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, f"{what}: max |diff| {err:.3g} > {bound:.3g}"


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# RWKV-6 chunked WKV (test_models_property.py:94)
# ---------------------------------------------------------------------------

def _wkv_draws(s: int, seed: int):
    rng = np.random.default_rng(seed)
    b, h, n = 1, 2, 8
    r = rng.normal(size=(b, h, s, n)).astype(np.float32)
    k = rng.normal(size=(b, h, s, n)).astype(np.float32)
    v = rng.normal(size=(b, h, s, n)).astype(np.float32)
    w = np.exp(-np.exp(rng.normal(size=(b, h, s, n)))).astype(np.float32)
    u = rng.normal(size=(h, n)).astype(np.float32) * 0.5
    return r, k, v, w, u


@pytest.mark.parametrize("s, chunk, seed", [
    (8, 4, 0), (16, 8, 7), (32, 16, 13), (32, 4, 29), (16, 16, 50),
    (8, 16, 3)])
def test_chunked_wkv_matches_reference_and_sequential(s, chunk, seed):
    from test_models_property import _wkv_sequential
    draws = _wkv_draws(s, seed)
    jout, jstate = jrwkv.chunked_wkv(*map(jnp.asarray, draws), chunk=chunk)
    tout, tstate = trwkv.chunked_wkv(*map(t, draws), chunk=chunk)
    close(tout, jout, what="out")
    close(tstate, jstate, what="state")
    ref_out, ref_state = _wkv_sequential(*draws)
    np.testing.assert_allclose(tout.numpy(), ref_out, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(tstate.numpy(), ref_state, atol=1e-4,
                               rtol=1e-3)


def test_chunked_wkv_carries_state_across_calls():
    """Two calls threading the state equal one call over both halves, and
    a length that is not a multiple of the chunk raises."""
    r, k, v, w, u = _wkv_draws(32, 5)
    half = lambda a, i: t(a[:, :, 16 * i:16 * (i + 1)])
    full, s_full = trwkv.chunked_wkv(*map(t, (r, k, v, w, u)), chunk=8)
    a, s_a = trwkv.chunked_wkv(*(half(x, 0) for x in (r, k, v, w)), t(u),
                               chunk=8)
    b, s_b = trwkv.chunked_wkv(*(half(x, 1) for x in (r, k, v, w)), t(u),
                               chunk=8, state=s_a)
    close(torch.cat([a, b], 2), full.numpy(), what="out")
    close(s_b, s_full.numpy(), what="state")
    with pytest.raises(ValueError, match="multiple of the WKV chunk"):
        trwkv.chunked_wkv(*map(t, (r, k, v, w, u)), chunk=12)


# ---------------------------------------------------------------------------
# Mamba (test_models_property.py:114)
# ---------------------------------------------------------------------------

def _mamba_case():
    jcfg = JModelConfig("m", 1, 32, 4, 4, 64, 97, ssm_kind="mamba",
                        mamba_d_state=4)
    tcfg = ModelConfig("m", 1, 32, 4, 4, 64, 97, ssm_kind="mamba",
                       mamba_d_state=4)
    p = jinit_params(jmamba.mamba_defs(jcfg), jax.random.PRNGKey(0),
                     jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    return jcfg, tcfg, p, to_torch(p), x


def test_mamba_matches_reference_and_two_halves():
    jcfg, tcfg, jp, tp, x = _mamba_case()
    jfull, (jconv, jh) = jmamba.mamba_apply(jp, jcfg, jnp.asarray(x),
                                            return_state=True)
    tfull, (tconv, th) = tmamba.mamba_apply(tp, tcfg, t(x),
                                            return_state=True)
    close(tfull, jfull, what="out")
    close(tconv, jconv, what="conv tail")
    close(th, jh, what="h")
    st0 = tmamba.mamba_init_state(tcfg, 2, torch.float32, "cpu")
    a, st1 = tmamba.mamba_apply(tp, tcfg, t(x[:, :8]), state=st0,
                                return_state=True)
    b, _ = tmamba.mamba_apply(tp, tcfg, t(x[:, 8:]), state=st1,
                              return_state=True)
    np.testing.assert_allclose(tfull.numpy(), torch.cat([a, b], 1).numpy(),
                               atol=1e-4, rtol=1e-3)


def test_mamba_decode_steps_match_reference():
    """Token by token from a state: the conv tail as left context and the
    scan at one step, against the reference's decode step."""
    jcfg, tcfg, jp, tp, x = _mamba_case()
    jstate = jmamba.mamba_init_state(jcfg, 2, jnp.float32)
    tstate = tmamba.mamba_init_state(tcfg, 2, torch.float32, "cpu")
    assert tstate[1].dtype == torch.float32
    assert tmamba.mamba_init_state(tcfg, 2, torch.bfloat16,
                                   "cpu")[1].dtype == torch.float32
    for i in range(4):
        jo, jstate = jmamba.mamba_decode_step(jp, jcfg, jnp.asarray(x[:, i]),
                                              jstate)
        to, tstate = tmamba.mamba_decode_step(tp, tcfg, t(x[:, i]), tstate)
        close(to, jo, what=f"step {i}")
        close(tstate[0], jstate[0], what=f"conv {i}")
        close(tstate[1], jstate[1], what=f"h {i}")


@pytest.mark.parametrize("s", [256, 100])
def test_mamba_multi_chunk_matches_reference(s):
    """Past one ``MAMBA_CHUNK``: the carry across chunks (256), and a
    length the reference's assert refuses (100 is one chunk; 200 is not)."""
    jcfg, tcfg, jp, tp, _ = _mamba_case()
    x = np.random.default_rng(s).normal(size=(1, s, 32)).astype(np.float32)
    jo = jmamba.mamba_apply(jp, jcfg, jnp.asarray(x))
    close(tmamba.mamba_apply(tp, tcfg, t(x)), jo, what=f"S={s}")
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        tmamba.mamba_apply(tp, tcfg, t(np.zeros((1, 200, 32), np.float32)))


# ---------------------------------------------------------------------------
# MoE (test_models_property.py:138, :151, :163)
# ---------------------------------------------------------------------------

def _moe_case(cf: float, key: int):
    jcfg = JModelConfig("x", 1, 32, 4, 4, 64, 97,
                        moe=JMoEConfig(4, 2, 64, capacity_factor=cf))
    tcfg = ModelConfig("x", 1, 32, 4, 4, 64, 97,
                       moe=MoEConfig(4, 2, 64, capacity_factor=cf))
    p = jinit_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(key),
                     jnp.float32)
    return jcfg, tcfg, p


def _moe_both(jcfg, tcfg, jp, x, **kw):
    jout, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), **kw)
    tout, taux = tmoe.moe_apply(to_torch(jp), tcfg, t(x), **kw)
    close(tout, jout, what="out")
    for key in ("load_balance", "router_z"):
        close(taux[key], jaux[key], what=key)
    return tout, taux


@pytest.mark.parametrize("cf, key, seed, shape", [
    (8.0, 0, 0, (2, 8, 32)),        # :138, no drops
    (0.25, 0, 1, (2, 16, 32)),      # :151, most tokens dropped
    (1.25, 2, 2, (1, 32, 32)),      # :163, the configs' factor
])
def test_moe_matches_reference(cf, key, seed, shape):
    jcfg, tcfg, jp = _moe_case(cf, key)
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    out, aux = _moe_both(jcfg, tcfg, jp, x)
    if cf == 8.0:       # no drops: invariant to how the batch is grouped
        a, _ = tmoe.moe_apply(to_torch(jp), tcfg, t(x[:1]))
        b, _ = tmoe.moe_apply(to_torch(jp), tcfg, t(x[1:]))
        np.testing.assert_allclose(out.numpy(), torch.cat([a, b]).numpy(),
                                   atol=1e-5, rtol=1e-5)
    if cf == 0.25:      # dropped tokens contribute exactly zero
        norms = torch.linalg.norm(out.reshape(-1, 32), dim=-1)
        assert int((norms == 0).sum()) > 0
    assert float(aux["load_balance"]) >= 0.99
    assert float(aux["router_z"]) >= 0.0


def test_moe_overflowing_expert_loses_its_last_slot():
    """At capacity 2, an expert that four assignments pick keeps its first
    one and the pad row in slot 1: the reference's dropped assignments are
    written to slot ``capacity - 1`` after the kept one.  Built so that
    every token picks experts 0 and 1 (router columns 2 and 3 far below)."""
    jcfg, tcfg, jp = _moe_case(1.0, 4)          # capacity int(4·2·1/4) = 2
    jp = dict(jp)
    router = np.zeros((32, 4), np.float32)
    router[:, 2:] = -50.0
    router[0, 0] = 1.0                           # expert 0 first for x₀ > 0
    jp["router"] = jnp.asarray(router)
    x = np.random.default_rng(3).normal(size=(1, 4, 32)).astype(np.float32)
    x[..., 0] = 1.0 + np.abs(x[..., 0])
    x[..., 1:] *= 1e-3
    out, _ = _moe_both(jcfg, tcfg, jp, x)
    # token 0 is expert 0's slot 0, token 1 its slot 1 (overwritten by the
    # pad row); expert 1 takes tokens 0 and 1 second, and overflows too,
    # losing token 1: so token 0 is served twice, the rest not at all
    norms = torch.linalg.norm(out.reshape(-1, 32), dim=-1)
    assert float(norms[0]) > 0
    assert torch.equal(norms[1:], torch.zeros(3))


def test_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15],
                          [0.1, 0.3, 0.3, 0.3, 0.0]])
    vals, ids = tmoe.top_k(probs, 3)
    jvals, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert ids.tolist() == np.asarray(jids).tolist() == [[0, 1, 3],
                                                         [1, 2, 3]]
    assert torch.equal(vals, t(jvals))


def test_moe_router_tie_matches_reference():
    """Two experts with identical router columns score every token the
    same; the reference's ``lax.top_k`` and the port pick the lower."""
    jcfg, tcfg, jp = _moe_case(8.0, 5)
    jp = dict(jp)
    router = np.array(jp["router"])
    router[:, 3] = router[:, 1]
    jp["router"] = jnp.asarray(router)
    x = np.random.default_rng(6).normal(size=(2, 8, 32)).astype(np.float32)
    _moe_both(jcfg, tcfg, jp, x)
    logits = t(x).reshape(-1, 32) @ torch.from_numpy(router)
    _, ids = tmoe.top_k(torch.softmax(logits, -1), 2)
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1),
                            2)
    assert torch.equal(ids, t(jids).long())
    rows = ids.tolist()
    # 3 ties 1: picked only after 1, and some token breaks the tie at the
    # last pick (1 in, 3 out)
    assert all(1 in r[:r.index(3)] for r in rows if 3 in r)
    assert any(r[-1] == 1 for r in rows)


# ---------------------------------------------------------------------------
# RWKV-6 time and channel mix, decode steps
# ---------------------------------------------------------------------------

def test_rwkv6_mixes_and_decode_steps_match_reference():
    from repro.configs import get_smoke as jax_smoke
    from repro_torch.configs import get_smoke
    jcfg, tcfg = jax_smoke("rwkv6-7b"), get_smoke("rwkv6-7b")
    from test_torch_lm_serving import numpy_params
    arrays = numpy_params(jrwkv.rwkv6_defs(jcfg), 9)
    jp, tp = jax.tree.map(jnp.asarray, arrays), to_torch(arrays)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 12, tcfg.d_model)).astype(np.float32)
    jt, (jshift, jwkv) = jrwkv.rwkv6_time_mix(jp, jcfg, jnp.asarray(x),
                                              return_state=True)
    tt, (tshift, twkv) = trwkv.rwkv6_time_mix(tp, tcfg, t(x),
                                              return_state=True)
    close(tt, jt, what="time mix")
    close(tshift, jshift, what="shift")
    close(twkv, jwkv, what="wkv")
    jc, jcs = jrwkv.rwkv6_channel_mix(jp, jcfg, jnp.asarray(x),
                                      return_state=True)
    tc, tcs = trwkv.rwkv6_channel_mix(tp, tcfg, t(x), return_state=True)
    close(tc, jc, what="channel mix")
    close(tcs, jcs, what="cm shift")
    st = trwkv.rwkv6_init_state(tcfg, 2, torch.bfloat16, "cpu")
    assert st["wkv"].dtype == torch.float32
    assert st["shift"].dtype == torch.bfloat16
    # one decode step from the states the prompt left
    step = rng.normal(size=(2, tcfg.d_model)).astype(np.float32)
    jo, (js, jw) = jrwkv.rwkv6_decode_step(jp, jcfg, jnp.asarray(step),
                                           jshift, jwkv, jcs)
    to, (ts, tw) = trwkv.rwkv6_decode_step(tp, tcfg, t(step), tshift, twkv,
                                           tcs)
    close(to, jo, what="decode time mix")
    close(tw, jw, what="decode wkv")
    jo, js = jrwkv.rwkv6_channel_decode_step(jp, jcfg, jnp.asarray(step),
                                             jcs)
    to, ts = trwkv.rwkv6_channel_decode_step(tp, tcfg, t(step), tcs)
    close(to, jo, what="decode channel mix")
    close(ts, js, what="decode cm shift")
