"""The float32 attention kernel's precision scheme, on the CPU.

``csrc/flash_attention.cu`` takes every product of Q Kᵀ and P V as three
TF32 products (split-TF32: ``hi = rna(x)``, ``lo = rna(x − hi)``,
``lo·hi + hi·lo + hi·hi``).  ``ref.attention_tf32_ref`` spells that scheme
out in torch; here, on numpy-seeded inputs, it is held to the reference's
float32 tolerance (atol = rtol = 2e-5, the reference's kernel tests)
against the port's ``attention_ref`` and the JAX package's, and one TF32
product per score (``terms=1``) is shown to miss that tolerance at the same
shapes: the check can tell the two apart.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref as jref                            # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402

ATOL = RTOL = 2e-5

# (b, h, hkv, sq, skv, d), kwargs
CASES = {
    # whisper-base cross-attention at its full 448 x 1500, 2 of 8 heads
    "whisper-base heads": ((1, 2, 2, 448, 1500, 64), dict(causal=False)),
    "gqa causal q_offset": ((2, 6, 2, 40, 120, 32),
                            dict(causal=True, q_offset=80)),
    "window": ((1, 4, 1, 96, 96, 64), dict(causal=True, window=17)),
    "ragged non-causal": ((1, 2, 1, 37, 53, 16), dict(causal=False)),
    "rows with no key": ((1, 2, 2, 12, 12, 128),
                         dict(causal=True, q_offset=-5)),
}


def _inputs(name):
    shape, _ = CASES[name]
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(sum(shape))
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32))


def _beyond(got, want):
    return int(np.sum(np.abs(got - want) > ATOL + RTOL * np.abs(want)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_tf32_products_hold_float32_tolerance(name):
    xs = _inputs(name)
    kw = CASES[name][1]
    q, k, v = (torch.from_numpy(x) for x in xs)
    got = tref.attention_tf32_ref(q, k, v, terms=3, **kw)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = tref.attention_ref(q, k, v, **kw).numpy()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    jax_out = np.asarray(jref.attention_ref(*(jnp.asarray(x) for x in xs),
                                            **kw), np.float32)
    np.testing.assert_allclose(got.numpy(), jax_out, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_tf32_product_misses_float32_tolerance(name):
    """The control: plain TF32 products move values beyond 2e-5."""
    xs = _inputs(name)
    kw = CASES[name][1]
    q, k, v = (torch.from_numpy(x) for x in xs)
    want = tref.attention_ref(q, k, v, **kw).numpy()
    one = tref.attention_tf32_ref(q, k, v, terms=1, **kw).numpy()
    three = tref.attention_tf32_ref(q, k, v, terms=3, **kw).numpy()
    assert _beyond(one, want) > 0
    assert _beyond(three, want) == 0
    assert np.abs(one - want).max() > 10 * np.abs(three - want).max()


def test_rows_with_no_key_are_zero():
    xs = _inputs("rows with no key")
    q, k, v = (torch.from_numpy(x) for x in xs)
    for terms in (1, 3):
        out = tref.attention_tf32_ref(q, k, v, terms=terms,
                                      **CASES["rows with no key"][1])
        assert torch.all(out[:, :, :5] == 0)
        assert torch.all(out[:, :, 5:].abs().sum(-1) > 0)


def test_tf32_round_is_rna():
    """Round to nearest on the 13 dropped bits, ties away from zero, and
    the low 13 bits zero; hi + lo holds x to about 2^-22 relative."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 3.0e-3, -7.5e8, 0.0],
                     dtype=torch.float32)
    r = tref.tf32_round(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert r[0] == 1.0 and r[6] == 0.0
    assert r[1] == 1.0 + one_ulp and r[2] == -(1.0 + one_ulp)
    assert r[3] == 1.0
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal(10_000, dtype=np.float32)
                         * np.float32(100.0))
    hi = tref.tf32_round(y)
    lo = tref.tf32_round(y - hi)
    assert torch.all((y - hi).abs() <= y.abs() * 2.0 ** -11)
    assert torch.all(((hi + lo) - y).abs() <= y.abs() * 2.0 ** -21)


def test_terms_must_be_one_or_three():
    q = torch.zeros(1, 1, 2, 16)
    with pytest.raises(ValueError, match="terms"):
        tref.attention_tf32_ref(q, q, q, terms=2)
