"""The port's LM layers (``repro_torch.models.layers``) held against the
JAX package's (``repro.models.layers``) on the CPU, module by module.

Inputs and parameters are drawn from a numpy seed and handed to both
packages; everything runs in float32.  Tolerance: ``TOL`` absolute times
``max(1, max |reference value|)``.  ``chunked_attention`` is also held
to the port's ``ref.attention_ref`` (the kernel's contract), so the plain
path the CPU takes and the function the kernel computes on the card are
one function.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import layers as jl
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as tl

TOL = 1e-5


def close(got: torch.Tensor, want, tol: float = TOL) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err
    return err


def draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def as_both(tree):
    """A dict of numpy arrays as (jnp dict, torch dict)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_apply(norm):
    cfg = dataclasses.replace(get_smoke("lm100m"), norm=norm)
    jcfg = dataclasses.replace(jax_smoke("lm100m"), norm=norm)
    rng = np.random.default_rng(0)
    x = draw(rng, 2, 5, cfg.d_model, scale=3.0)
    p = {"scale": 1 + draw(rng, cfg.d_model, scale=0.1)}
    if norm == "layernorm":
        p["bias"] = draw(rng, cfg.d_model, scale=0.1)
    jp, tp = as_both(p)
    close(tl.norm_apply(tp, cfg, torch.from_numpy(x)),
          jl.norm_apply(jp, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("theta, offset", [(1e4, 0), (1e6, 0), (1e6, 1000)])
def test_rope(theta, offset):
    rng = np.random.default_rng(1)
    x = draw(rng, 2, 4, 12, 32)
    pos = offset + np.arange(12, dtype=np.int32)
    close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
          jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))


# (sq, skv, causal, window, q_offset, chunk, causal_skip)
CHUNKED = [
    (32, 32, True, None, 0, 16, False),
    (32, 32, True, None, 0, 16, True),         # causal_skip
    (48, 48, True, 12, 0, 16, True),           # window bounds lo
    (48, 48, True, 12, 0, 16, False),
    (16, 48, True, None, 32, 16, False),       # q_offset (chunked prefill)
    (16, 48, True, 20, 32, 16, True),          # skip disabled by q_offset
    (24, 24, True, None, 0, 16, False),        # 24 with chunk 16 → 12
    (24, 24, True, None, 0, 16, True),
    (8, 24, False, None, 0, 16, False),        # cross (non-causal)
    (1, 40, True, None, 39, 16, False),        # decode row
]


@pytest.mark.parametrize("sq, skv, causal, window, q_offset, chunk, skip",
                         CHUNKED)
def test_chunked_attention(sq, skv, causal, window, q_offset, chunk, skip):
    rng = np.random.default_rng(2)
    q = draw(rng, 2, 4, sq, 16)
    k = draw(rng, 2, 2, skv, 16)
    v = draw(rng, 2, 2, skv, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = tl.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), q_chunk=chunk,
                               kv_chunk=chunk, causal_skip=skip, **kw)
    close(got, jl.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), q_chunk=chunk,
                                    kv_chunk=chunk, causal_skip=skip, **kw))
    close(got, ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw).numpy())


def test_attention_on_cpu_takes_the_plain_path(monkeypatch):
    """CPU tensors go to ``chunked_attention`` with the config's chunks,
    never to the kernel op."""
    seen = []
    monkeypatch.setattr(ops, "attention", lambda *a, **kw: seen.append(1))
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(draw(rng, 1, 2, 24, 16)) for _ in range(3))
    out = tl.attention(q, k, v, causal=True, q_chunk=16, kv_chunk=16)
    assert seen == [] and not tl.uses_kernel(q)
    assert torch.equal(out, tl.chunked_attention(q, k, v, q_chunk=16,
                                                 kv_chunk=16))
    with tl.plain_attention():
        assert not tl.uses_kernel(q)


def _attn_params(rng, cfg, cross=False):
    defs = jl.attention_defs(cfg, cross=cross)
    return {name: draw(rng, *d.shape, scale=d.shape[0] ** -0.5)
            for name, d in defs.items()}


@pytest.mark.parametrize("arch, kind, cross", [
    ("qwen2.5-3b", "attn", False),              # GQA + QKV bias
    ("gemma3-1b", "attn_local", False),         # window, θ 1e4
    ("gemma3-1b", "attn", False),               # global θ 1e6
    ("whisper-base", "attn", True),             # cross-attention
])
def test_attention_apply(arch, kind, cross):
    cfg, jcfg = get_smoke(arch), jax_smoke(arch)
    rng = np.random.default_rng(4)
    p = _attn_params(rng, jcfg, cross)
    assert sorted(p) == sorted(tl.attention_defs(cfg, cross=cross))
    jp, tp = as_both(p)
    x = draw(rng, 2, 24, cfg.d_model)
    kv = draw(rng, 2, 12, cfg.d_model) if cross else None
    got = tl.attention_apply(tp, cfg, torch.from_numpy(x), kind=kind,
                             kv_input=None if kv is None
                             else torch.from_numpy(kv))
    want = jl.attention_apply(jp, jcfg, jnp.asarray(x), kind=kind,
                              kv_input=None if kv is None
                              else jnp.asarray(kv))
    close(got, want)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "sq_relu", "gelu"])
def test_mlp_apply(act):
    cfg = dataclasses.replace(get_smoke("lm100m"), act=act)
    jcfg = dataclasses.replace(jax_smoke("lm100m"), act=act)
    rng = np.random.default_rng(5)
    defs = jl.mlp_defs(jcfg)
    assert sorted(defs) == sorted(tl.mlp_defs(cfg))
    p = {name: draw(rng, *d.shape, scale=d.shape[0] ** -0.5)
         for name, d in defs.items()}
    jp, tp = as_both(p)
    x = draw(rng, 2, 7, cfg.d_model)
    close(tl.mlp_apply(tp, cfg, torch.from_numpy(x)),
          jl.mlp_apply(jp, jcfg, jnp.asarray(x)))
