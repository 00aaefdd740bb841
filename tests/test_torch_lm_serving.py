"""The port's LM stack held against the JAX package on the CPU.

For each of the eleven smoke configurations (the seven dense ones, and
mixtral, moonshot, jamba and rwkv6 with their MoE, Mamba and RWKV-6
layers), one parameter tree is
drawn from a numpy seed (every leaf, the zero- and one-initialised biases
and norm scales too, so each of them is exercised) and handed to both
packages: the JAX package's as ``jnp`` arrays, the port's through
``params_from_numpy``.  Both run in float32 on the CPU, the port's
attention on its plain ``chunked_attention``.

Tolerances (float32): ``LOGIT_TOL`` on hidden states and logits,
``CACHE_TOL`` on every K/V cache leaf, each times ``max(1, max |reference
value|)``; ``slot_pos`` must be equal.  They are set by float32 rounding,
not by the port: with random weights whisper-base and gemma3 smoke are
ill-conditioned, and the JAX package's own float32 logits lie 1.3e-3
(whisper-base, max |logit| 3.9) and 6.6e-4 (gemma3, 34) from the same
model run in float64, the port's 7.7e-4 and 5.2e-4.  The largest
difference seen between the two packages is 1.6e-4 × max |logit|
(whisper-base prefill) and 5.1e-5 on a cache.  A Mamba layer's ``conv``
and ``h`` states are held to ``MAMBA_STATE_TOL``: jamba smoke's SSM state
(max |h| ~5e4) is as ill-conditioned, the JAX package's own float32 ``h``
lying up to 1.7e-4 of max |h| from float64 (the port's 7.5e-5), and the
two packages up to 2.4e-4 apart.  The MoE aux loss is held to
``LOGIT_TOL``.

``Server.run`` on lm100m smoke and on rwkv6 smoke (the recurrent states
threaded through the server) is held against the JAX ``Server`` (no
mesh): the port's engine replays the JAX server's tokens teacher-forced
and its logits must match the JAX server's step for step; the two
servers' free-running token lists are compared only up to the first step
where the JAX top-2 logit margin is at most ten times ``LOGIT_TOL`` (a
flip there says nothing about the port).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.launch import serve as jax_serve
from repro.models import params as jax_params
from repro.models import transformer as jax_tr
from repro.serving import cache as jax_cache
from repro.serving import engine as jax_engine
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as port_tr
from repro_torch.models.params import ParamDef, params_from_numpy, tree_items
from repro_torch.models.weights import WeightsError
from repro_torch.serving import cache as port_cache
from repro_torch.serving import engine as port_engine

DENSE = ["lm100m", "qwen2.5-3b", "qwen1.5-110b", "nemotron-4-340b",
         "gemma3-1b", "internvl2-26b", "whisper-base"]
# MoE (mixtral with SWA, moonshot), Mamba + attention + MoE (jamba), RWKV-6
RECURRENT_MOE = ["mixtral-8x22b", "moonshot-v1-16b-a3b",
                 "jamba-1.5-large-398b", "rwkv6-7b"]
ARCHS = DENSE + RECURRENT_MOE
LOGIT_TOL = 4e-4
CACHE_TOL = 1e-4
MAMBA_STATE_TOL = 5e-4
B, PROMPT, MAX_SEQ, DECODE_STEPS = 2, 20, 48, 3


def numpy_params(defs, seed: int):
    """A parameter tree of numpy float32 leaves shaped by the JAX
    package's ``defs``: normal × (scale or 1/√fan_in); zero-initialised
    leaves 0.1·normal, one-initialised 1 + 0.1·normal."""
    rng = np.random.default_rng(seed)

    def draw(d):
        x = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "zeros":
            return 0.1 * x
        if d.init == "ones":
            return 1.0 + 0.1 * x
        scale = d.scale
        if scale is None:
            fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
            scale = 1.0 / np.sqrt(max(1, fan_in))
        return (x * np.float32(scale)).astype(np.float32)

    return jax.tree.map(draw, defs,
                        is_leaf=lambda x: isinstance(x, jax_params.ParamDef))


def both(arch: str, seed: int = 0):
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    arrays = numpy_params(jax_tr.model_defs(jcfg), seed)
    jparams = jax.tree.map(jnp.asarray, arrays)
    tparams = params_from_numpy(port_tr.model_defs(tcfg), arrays,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def inputs(cfg, seed: int):
    """Prompt tokens and the modality inputs (internvl's prefix, whisper's
    frames) as numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    extra = {}
    if cfg.frontend_prefix:
        extra["prefix_embed"] = rng.normal(
            0, 0.5, (B, cfg.frontend_prefix, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        extra["frames"] = rng.normal(
            0, 0.5, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (DECODE_STEPS, B)).astype(np.int32)
    return tokens, extra, steps


def close(got: torch.Tensor, want, tol: float, what: str) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    if not got.size:
        return 0.0
    err = float(np.max(np.abs(got - want)))
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, f"{what}: max |diff| {err:.3g} > {bound:.3g}"
    return err


def cache_leaves(tree):
    """(path, leaf) of a cache tree, either package's."""
    return list(tree_items({"blocks": list(tree.blocks),
                            "tail": list(tree.tail)},
                           lambda x: not isinstance(x, (dict, list))))


def check_caches(tcache, jcache, what: str) -> None:
    got, want = cache_leaves(tcache), cache_leaves(jcache)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if path.endswith("slot_pos"):
            assert np.array_equal(g.numpy(), np.asarray(w)), (what, path)
        else:
            tol = (MAMBA_STATE_TOL if path.endswith(("/conv", "/h"))
                   else CACHE_TOL)
            close(g, w, tol, f"{what} cache {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jparams, tparams = both(arch, seed=1)
    tokens, extra, _ = inputs(tcfg, seed=2)
    j_enc = t_enc = None
    if tcfg.encoder_layers:
        j_enc = jax_tr.encode(jparams, jcfg, jnp.asarray(extra["frames"]))
        t_enc = port_tr.encode(tparams, tcfg,
                               torch.from_numpy(extra["frames"]))
        close(t_enc, j_enc, LOGIT_TOL, f"{arch} encoder")
    prefix = extra.get("prefix_embed")
    jh, jaux = jax_tr.forward(jparams, jcfg, jnp.asarray(tokens),
                              prefix_embed=(None if prefix is None
                                            else jnp.asarray(prefix)),
                              enc_out=j_enc)
    th, aux = port_tr.forward(tparams, tcfg, torch.from_numpy(tokens),
                              prefix_embed=(None if prefix is None
                                            else torch.from_numpy(prefix)),
                              enc_out=t_enc)
    assert th.shape == (B, PROMPT + tcfg.frontend_prefix, tcfg.d_model)
    assert (float(aux) == 0.0) == (tcfg.moe is None)
    close(aux, jaux, LOGIT_TOL, f"{arch} MoE aux loss")
    close(th, jh, LOGIT_TOL, f"{arch} hidden")
    close(port_tr.unembed_logits(tparams, tcfg, th),
          jax_tr.unembed_logits(jparams, jcfg, jh), LOGIT_TOL,
          f"{arch} logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jparams, tparams = both(arch, seed=3)
    tokens, extra, steps = inputs(tcfg, seed=4)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    jc = jax_cache.init_cache(jcfg, B, MAX_SEQ, jnp.float32)
    tc = port_cache.init_cache(tcfg, B, MAX_SEQ, torch.float32, "cpu")
    check_caches(tc, jc, f"{arch} empty")
    before = ops.attention_launches
    jl, jc = jax_engine.prefill(jparams, jcfg, jnp.asarray(tokens), jc,
                                **jextra)
    tl, tc = port_engine.prefill(tparams, tcfg, torch.from_numpy(tokens),
                                 tc, **textra)
    assert tl.shape == (B, tcfg.vocab_padded)
    close(tl, jl, LOGIT_TOL, f"{arch} prefill logits")
    check_caches(tc, jc, f"{arch} prefill")
    j_enc = (jax_tr.encode(jparams, jcfg, jextra["frames"])
             if jcfg.encoder_layers else None)
    t_enc = (port_tr.encode(tparams, tcfg, textra["frames"])
             if tcfg.encoder_layers else None)
    pos = PROMPT + tcfg.frontend_prefix
    for t, tok in enumerate(steps):
        jl, jc = jax_engine.decode_step(jparams, jcfg, jc, jnp.asarray(tok),
                                        jnp.int32(pos + t), enc_out=j_enc)
        tl, tc = port_engine.decode_step(tparams, tcfg, tc,
                                         torch.from_numpy(tok), pos + t,
                                         enc_out=t_enc)
        close(tl, jl, LOGIT_TOL, f"{arch} decode {t} logits")
        check_caches(tc, jc, f"{arch} decode {t}")
    assert ops.attention_launches == before     # the CPU runs no kernel


def test_generate_matches_jax():
    """Greedy generation (the reference's scan, the port's loop) on
    qwen2.5 smoke: every step's margin is checked before the tokens are
    compared (ties would say nothing)."""
    jcfg, tcfg, jparams, tparams = both("qwen2.5-3b", seed=5)
    tokens, _, _ = inputs(tcfg, seed=6)
    jt = np.asarray(jax_engine.generate(jparams, jcfg, jnp.asarray(tokens),
                                        6, MAX_SEQ, dtype=jnp.float32))
    tt = port_engine.generate(tparams, tcfg, torch.from_numpy(tokens), 6,
                              MAX_SEQ, dtype=torch.float32)
    assert tt.shape == (B, 6)
    assert np.array_equal(tt.numpy(), jt)


class _Recorder:
    """Wraps the JAX server's prefill and decode to keep their logits."""

    def __init__(self, monkeypatch, server):
        self.logits = []
        real_prefill = jax_serve.prefill

        def prefill(*a, **kw):
            logits, cache = real_prefill(*a, **kw)
            self.logits.append(np.asarray(logits))
            return logits, cache

        real_decode = server._decode

        def decode(*a):
            logits, cache = real_decode(*a)
            self.logits.append(np.asarray(logits))
            return logits, cache

        monkeypatch.setattr(jax_serve, "prefill", prefill)
        server._decode = decode


def _requests(module, cfg, n: int, max_new: int):
    rng = np.random.default_rng(7)
    out = []
    for rid in range(n):
        plen = int(rng.integers(4, 12))
        out.append(module.Request(
            rid, rng.integers(0, cfg.vocab, plen).astype(np.int32), max_new))
    return out


def test_server_run_matches_jax_server(monkeypatch):
    server_matches_jax_server(monkeypatch, "lm100m")


def test_rwkv6_server_run_matches_jax_server(monkeypatch):
    """The recurrent states threaded through the port's ``Server``
    (prompts of 4–11 tokens: one WKV chunk)."""
    server_matches_jax_server(monkeypatch, "rwkv6-7b")


def server_matches_jax_server(monkeypatch, arch: str) -> None:
    jcfg, tcfg, jparams, tparams = both(arch, seed=8)
    n, max_new, bs, max_seq = 6, 8, 4, 64
    jserver = jax_serve.Server(jcfg, jparams, batch_size=bs, max_seq=max_seq)
    rec = _Recorder(monkeypatch, jserver)
    for r in _requests(jax_serve, jcfg, n, max_new):
        jserver.submit(r)
    jres = jserver.run()
    tserver = port_serve.Server(tcfg, tparams, batch_size=bs,
                                max_seq=max_seq, device="cpu", record=True)
    for r in _requests(port_serve, tcfg, n, max_new):
        tserver.submit(r)
    tres = tserver.run()
    assert sorted(tres) == sorted(jres) == list(range(n))
    assert all(len(tres[i]) == len(jres[i]) == max_new for i in range(n))
    # teacher-forced replay of the JAX server's tokens on the port's engine
    gens = tserver.generations
    assert len(gens) == 2 and len(rec.logits) == sum(
        1 + len(g.steps) for g in gens)
    jlogits = iter(rec.logits)
    jtokens = {}
    row_of = {}
    for g, gen in enumerate(gens):
        rids = [rid for rid in range(n) if rid // bs == g]
        for i, rid in enumerate(rids):
            row_of[rid] = (g, i)
        cache = port_cache.init_cache(tcfg, bs, max_seq, torch.float32, "cpu")
        logits, cache = port_engine.prefill(
            tparams, tcfg, torch.from_numpy(gen.prompts), cache)
        want = next(jlogits)
        close(logits, want, LOGIT_TOL, f"generation {g} prefill")
        margins = [_margin(want, tcfg.vocab)]
        fed = np.argmax(want, -1)
        for t, (_, pos) in enumerate(gen.steps):
            logits, cache = port_engine.decode_step(
                tparams, tcfg, cache, torch.from_numpy(fed), pos)
            want = next(jlogits)
            close(logits, want, LOGIT_TOL, f"generation {g} step {t}")
            margins.append(_margin(want, tcfg.vocab))
            fed = np.argmax(want, -1)
        jtokens[g] = np.stack(margins)          # (steps + 1, bs)
    for rid in range(n):
        g, i = row_of[rid]
        low = np.flatnonzero(jtokens[g][:, i] <= 10 * LOGIT_TOL)
        upto = int(low[0]) if low.size else max_new
        assert tres[rid][:upto] == jres[rid][:upto], rid


def _margin(logits: np.ndarray, vocab: int) -> np.ndarray:
    top = np.sort(logits[:, :vocab], axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("fault, constraint", [
    ("missing", "weights-missing"), ("extra", "weights-unexpected"),
    ("shape", "weights-shape")])
def test_params_from_numpy_refuses(fault, constraint):
    cfg = get_smoke("qwen2.5-3b")
    defs = port_tr.model_defs(cfg)
    arrays = numpy_params(jax_tr.model_defs(jax_smoke("qwen2.5-3b")), 0)
    if fault == "missing":
        del arrays["blocks"][0]["mix"]["bq"]
        name = "blocks/0/mix/bq"
    elif fault == "extra":
        arrays["tail"] = [{"norm1": {"scale": np.ones(cfg.d_model,
                                                      np.float32)}}]
        name = "tail/0/norm1/scale"
    else:
        arrays["unembed"] = arrays["unembed"][:, :-1]
        name = "unembed"
    with pytest.raises(WeightsError) as info:
        params_from_numpy(defs, arrays, device="cpu")
    assert info.value.constraint == constraint
    assert info.value.name == name


def test_params_from_numpy_keeps_structure_and_values():
    cfg = get_smoke("gemma3-1b")
    defs = port_tr.model_defs(cfg)
    arrays = numpy_params(jax_tr.model_defs(jax_smoke("gemma3-1b")), 0)
    params = params_from_numpy(defs, arrays, device="cpu")
    assert len(params["blocks"]) == 3 and len(params["tail"]) == 1
    got = dict(tree_items(params, lambda x: isinstance(x, torch.Tensor)))
    want = dict(tree_items(arrays, lambda x: isinstance(x, np.ndarray)))
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert np.array_equal(got[path].numpy(), arr), path
    assert all(isinstance(d, ParamDef) for _, d in tree_items(defs))
