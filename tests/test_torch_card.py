"""The port's hand-written kernels against their plain versions, on a card.

Every test here is marked ``cuda``: it decides inside the test whether a
CUDA card is present and skips on a host without one.  The module imports
no ``jax``, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

``chip_smoke.py`` runs the full grids and the main paths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref                        # noqa: E402


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 4e-3, 2 ** -7)])
@pytest.mark.parametrize("shape,kw", [
    ((2, 4, 2, 70, 90, 64), dict(causal=False)),
    ((1, 4, 1, 33, 130, 256), dict(causal=True, q_offset=97)),
    ((1, 2, 2, 64, 64, 16), dict(causal=True, window=9)),
    ((4, 8, 2, 1, 77, 128), dict(causal=True, q_offset=76)),
    ((1, 2, 2, 10, 10, 32), dict(causal=True, q_offset=-5)),
])
def test_flash_attention_matches_plain(shape, kw, dtype, atol, rtol):
    """bf16: one ulp relative plus 4e-3 near 0, and at most 5 % of the
    values differ from the plain version's (both round to nearest)."""
    dev = _card()
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(sq + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(dev, dtype) for s in ((b, h, sq, d), (b, hkv, skv, d),
                                         (b, hkv, skv, d)))
    before = ops.attention_launches
    got = ops.attention(q, k, v, **kw)
    assert ops.attention_launches == before + 1
    want = ref.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    if dtype == torch.bfloat16:
        assert float((got != want).float().mean()) <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (100, 300, 200),
                                   (1, 17, 5)])
def test_vta_gemm_matches_plain(m, k, n):
    dev = _card()
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    bias = torch.from_numpy(rng.integers(-5000, 5000, (n,)).astype(np.int32))
    a, b, bias = a.to(dev), b.to(dev), bias.to(dev)
    for kw in (dict(relu=True, shift=3), dict(out_dtype=torch.int32)):
        assert torch.equal(ops.vta_matmul(a, b, bias, **kw),
                           ref.vta_gemm_ref(a, b, bias, **kw))
