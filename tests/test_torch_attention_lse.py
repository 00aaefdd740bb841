"""The attention op's ``return_lse`` mode on the CPU (its plain version,
``ref.attention_lse_ref``) and the combine of a decode over a
sequence-sharded cache (``serving.engine.combine_partials``).

* o equals ``ref.attention_ref``'s output (float32 rounding of the
  grouped product against the expanded one: 1e-6), in float32 whatever
  the inputs' dtype; lse equals ``torch.logsumexp`` of the scaled, masked
  scores (1e-6 × max(1, |lse|)); a row that keeps no key gives (0, -inf).
* The slots cut into ranges, each range's pair at ``q_offset - lo`` and
  the pairs combined with a reduction over the stacked ranges give back
  the whole call within 1e-6, a range that lies wholly after the query
  contributing (0, -inf); and the combined decode equals the reference's
  ``attention_ref`` (the JAX package's, at its float32 tolerance 2e-5)
  and the reference engine's masked-softmax decode
  (``repro.serving.engine._attn_scores_decode``).

The kernel's pair is held to this plain pair on a card by
``tests/test_torch_card.py`` and ``chip_smoke.py`` phase 20.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref as jref                            # noqa: E402
from repro_torch.kernels import ops as tops                      # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402
from repro_torch.serving.engine import combine_partials          # noqa: E402

TOL = 1e-6
REF_TOL = 2e-5
CASES = [
    # (b, h, hkv, sq, skv, d), kwargs
    ((2, 4, 2, 1, 96, 16), dict(causal=True, q_offset=70)),      # decode
    ((1, 8, 1, 1, 64, 32), dict(causal=True, q_offset=63)),      # MQA
    ((1, 4, 4, 16, 80, 16), dict(causal=True, q_offset=40)),     # chunk
    ((2, 4, 2, 24, 40, 16), dict(causal=False)),
    ((1, 2, 2, 32, 32, 16), dict(causal=True, window=8)),
    ((1, 2, 2, 10, 10, 32), dict(causal=True, q_offset=-5)),     # empty rows
]


def _tensors(seed, b, h, hkv, sq, skv, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype) for s in ((b, h, sq, d), (b, hkv, skv, d),
                                      (b, hkv, skv, d)))


def _scores(q, k, kw):
    """The scaled scores of every query head, -inf where the masks drop a
    key: K expanded over the group, unlike the plain version."""
    b, h, sq, d = q.shape
    k = k.float().repeat_interleave(h // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * d ** -0.5
    mask = tref.attention_mask(sq, k.shape[2], kw.get("causal", True),
                               kw.get("window"), kw.get("q_offset", 0),
                               q.device)
    return s.masked_fill(~mask, -math.inf)


def _combine(pairs):
    return combine_partials(torch.stack([o for o, _ in pairs]),
                            torch.stack([lse for _, lse in pairs]),
                            lambda t: t.amax(dim=0, keepdim=True),
                            lambda t: t.sum(dim=0, keepdim=True))[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw", CASES)
def test_pair_is_attention_ref_and_logsumexp(shape, kw, dtype):
    q, k, v = _tensors(sum(shape), *shape, dtype=dtype)
    o, lse = tops.attention(q, k, v, **kw, return_lse=True)
    assert o.dtype == lse.dtype == torch.float32
    assert tuple(lse.shape) == shape[:2] + (shape[3],)
    want = tref.attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(o, want, atol=TOL, rtol=TOL)
    want_lse = torch.logsumexp(_scores(q, k, kw), dim=-1)
    empty = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), empty)
    assert bool((lse[empty] < 0).all()) and bool((o[empty] == 0).all())
    assert bool(((lse - want_lse).abs()[~empty]
                 <= TOL * want_lse.abs().clamp(min=1.0)[~empty]).all())


@pytest.mark.parametrize("ranges", [2, 3, 4, 7])
@pytest.mark.parametrize("shape,kw", CASES[:3])
def test_ranges_combine_to_the_whole_call(shape, kw, ranges):
    """Uneven ranges; the last ones lie wholly after the decode's query."""
    q, k, v = _tensors(ranges + sum(shape), *shape)
    skv, pos = shape[4], kw["q_offset"]
    bounds = np.linspace(0, skv, ranges + 1).astype(int)
    pairs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        pair = tref.attention_lse_ref(q, k[:, :, lo:hi], v[:, :, lo:hi],
                                      causal=True, q_offset=pos - lo)
        if lo > pos + shape[3] - 1:          # no row reaches this range
            assert bool((pair[0] == 0).all())
            assert bool(torch.isneginf(pair[1]).all())
        pairs.append(pair)
    whole, _ = tref.attention_lse_ref(q, k, v, **kw)
    got = _combine(pairs)
    torch.testing.assert_close(got, whole, atol=TOL, rtol=TOL)
    jwant = np.asarray(jref.attention_ref(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), **kw))
    np.testing.assert_allclose(got.numpy(), jwant, atol=REF_TOL,
                               rtol=REF_TOL)


def test_empty_range_is_zero_and_minus_infinity():
    q, k, v = _tensors(3, 2, 4, 2, 1, 32, 16)
    o, lse = tref.attention_lse_ref(q, k, v, causal=True, q_offset=-1)
    assert bool((o == 0).all()) and bool(torch.isneginf(lse).all())
    # a range after the query changes nothing in the combine
    whole = tref.attention_lse_ref(q, k, v, causal=True, q_offset=20)
    got = _combine([whole, (o, lse)])
    assert torch.equal(got, whole[0])


def test_combined_decode_is_the_reference_engines():
    """The reference's decode attention (``_attn_scores_decode``: the
    masked softmax over the whole cache) on one device, and the port's
    split over four ranges of its slots, combined."""
    from repro.configs import get_smoke
    from repro.serving.engine import _attn_scores_decode
    cfg = get_smoke("qwen2.5-3b")
    b, s_max, pos = 2, 64, 37
    shape = (b, cfg.n_heads, cfg.n_kv_heads, 1, s_max, cfg.head_dim)
    q, k, v = _tensors(5, *shape)
    mask = (jnp.arange(s_max) <= pos)[None, None, None, :]
    jwant = np.asarray(_attn_scores_decode(
        cfg, *(jnp.asarray(x.numpy()) for x in (q, k, v)), mask))
    n = s_max // 4
    got = _combine([tref.attention_lse_ref(
        q, k[:, :, i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n],
        causal=True, q_offset=pos - i * n) for i in range(4)])
    np.testing.assert_allclose(got.numpy(), jwant, atol=REF_TOL,
                               rtol=REF_TOL)
