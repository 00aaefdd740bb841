"""The port's attention op and plain version against the reference.

The same seeded numpy inputs go through ``repro.kernels`` (the XLA
reference ``ref.attention_ref`` and the Pallas kernel in interpret mode,
``ops.attention_pallas``) and through ``repro_torch.kernels`` on CPU
tensors, where ``ops.attention`` runs the plain torch version.
Tolerances: atol = rtol = 2e-5 for float32 (the reference's kernel
tests); for bfloat16 rtol = 2**-7, one bf16 ulp relative (the two
frameworks may round the float32 result to different neighbours), and
atol = 4e-3 for outputs near 0.

The Pallas path is compared only where it is sound: causal attention, or
KV lengths that are multiples of the KV block.  At a ragged non-causal
length it pads K and V with zeros and leaves the padded keys unmasked
(``src/repro/kernels/ops.py:91-96``, ``flash_attention.py:52-62``), and a
row that keeps no key returns mean(v) instead of 0; the port follows
``ref.attention_ref`` in both.

The CUDA kernel itself runs only on a card; ``chip_smoke.py`` holds it
against the plain version there, as does ``tests/test_torch_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st    # noqa: E402

from repro.kernels import ops as jops                            # noqa: E402
from repro.kernels import ref as jref                            # noqa: E402
from repro_torch.core.errors import CompileError                 # noqa: E402
from repro_torch.kernels import flash_attention as tkernel       # noqa: E402
from repro_torch.kernels import ops as tops                      # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402

ATTN_CASES = [
    # (b, h, hkv, sq, skv, d), as tests/test_kernels.py
    (1, 4, 4, 64, 64, 32),      # MHA
    (2, 4, 2, 64, 64, 32),      # GQA 2:1
    (1, 8, 1, 32, 32, 16),      # MQA (gemma3 kv=1)
    (1, 2, 2, 48, 96, 32),      # cross-shaped (prefill continuation)
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-3, 2.0 ** -7)}


def _inputs(seed, b, h, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _port(q, k, v, dtype="float32", **kw):
    """The port's op on CPU tensors (→ the plain version), as float32."""
    tt = DTYPES[dtype][1]
    out = tops.attention(*(torch.from_numpy(x).to(tt) for x in (q, k, v)),
                         **kw)
    assert out.dtype == tt
    return out.float().numpy()


def _jax(fn, q, k, v, dtype="float32", **kw):
    jt = DTYPES[dtype][0]
    out = fn(*(jnp.asarray(x, jt) for x in (q, k, v)), **kw)
    assert out.dtype == jt
    return np.asarray(out, np.float32)


def _close(got, want, dtype):
    atol, rtol = DTYPES[dtype][2:]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d", ATTN_CASES)
def test_cases_match_reference_and_pallas(b, h, hkv, sq, skv, d, causal,
                                          dtype):
    q, k, v = _inputs(b + h + sq, b, h, hkv, sq, skv, d)
    off = skv - sq if causal and skv > sq else 0
    kw = dict(causal=causal, q_offset=off)
    got = _port(q, k, v, dtype, **kw)
    _close(got, _jax(jref.attention_ref, q, k, v, dtype, **kw), dtype)
    _close(got, _jax(jops.attention_pallas, q, k, v, dtype, block_q=32,
                     block_k=32, **kw), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sliding_window(dtype):
    q, k, v = _inputs(9, 1, 2, 2, 64, 64, 16)
    kw = dict(causal=True, window=16)
    got = _port(q, k, v, dtype, **kw)
    _close(got, _jax(jref.attention_ref, q, k, v, dtype, **kw), dtype)
    _close(got, _jax(jops.attention_pallas, q, k, v, dtype, block_q=16,
                     block_k=16, **kw), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_q_offset_chunked_prefill(dtype):
    """A q block starting at position 32 of a 64-long KV."""
    q, k, v = _inputs(13, 1, 2, 2, 32, 64, 16)
    kw = dict(causal=True, q_offset=32)
    got = _port(q, k, v, dtype, **kw)
    _close(got, _jax(jref.attention_ref, q, k, v, dtype, **kw), dtype)
    _close(got, _jax(jops.attention_pallas, q, k, v, dtype, block_q=16,
                     block_k=16, **kw), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,hkv,skv", [(2, 8, 2, 40), (1, 4, 1, 33),
                                         (3, 2, 2, 64)])
def test_decode_single_query(b, h, hkv, skv, dtype):
    """Sq = 1 at the last position: causal attends to every key."""
    q, k, v = _inputs(skv + h, b, h, hkv, 1, skv, 32)
    kw = dict(causal=True, q_offset=skv - 1)
    got = _port(q, k, v, dtype, **kw)
    _close(got, _jax(jref.attention_ref, q, k, v, dtype, **kw), dtype)
    _close(got, _jax(jops.attention_pallas, q, k, v, dtype, block_q=8,
                     block_k=8, **kw), dtype)
    _close(got, _port(q, k, v, dtype, causal=False), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [16, 32, 64, 128, 192, 256])
def test_head_dims(d, dtype):
    """Every head dim the kernel takes, GQA 2:1, window and offset."""
    q, k, v = _inputs(d, 1, 4, 2, 24, 40, d)
    for kw in (dict(causal=True, q_offset=16), dict(causal=False),
               dict(causal=True, window=7, q_offset=16)):
        got = _port(q, k, v, dtype, **kw)
        _close(got, _jax(jref.attention_ref, q, k, v, dtype, **kw), dtype)


def test_nemotron_head_set_matches_reference_op():
    """nemotron-4-340b's heads: 96 query heads over 8 KV heads at D = 192
    (18432 / 96), which the reference's op takes at any D.  The port's
    checks accept it and its op on the CPU matches the reference's op at
    the float32 tolerance, prefill and decode."""
    for sq, skv, off in ((24, 40, 16), (1, 40, 39)):
        q, k, v = _inputs(192 + sq, 1, 96, 8, sq, skv, 192)
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        assert tkernel.check_inputs(tq, tk, tv) == (1, 96, 8, sq, skv, 192)
        kw = dict(causal=True, q_offset=off)
        _close(_port(q, k, v, **kw), _jax(jops.attention, q, k, v, **kw),
               "float32")


@pytest.mark.parametrize("sq,skv", [(40, 40), (32, 40), (7, 23)])
def test_ragged_non_causal_follows_reference(sq, skv):
    """At a ragged non-causal length the port equals ``attention_ref``;
    the reference's padded Pallas path does not (its padded keys join the
    softmax), which is why the other tests compare against it only where
    it is sound."""
    q, k, v = _inputs(sq * skv, 1, 2, 2, sq, skv, 16)
    got = _port(q, k, v, causal=False)
    _close(got, _jax(jref.attention_ref, q, k, v, causal=False), "float32")
    padded = _jax(jops.attention_pallas, q, k, v, causal=False, block_q=16,
                  block_k=16)
    assert np.abs(padded - got).max() > 1e-2


def test_rows_with_no_key_return_zero():
    """Causal with a negative offset, and a window that keeps nothing:
    rows that keep no key are 0, not NaN and not mean(v)."""
    q, k, v = _inputs(3, 1, 2, 2, 10, 10, 16)
    got = _port(q, k, v, causal=True, q_offset=-5)
    _close(got, _jax(jref.attention_ref, q, k, v, causal=True, q_offset=-5),
           "float32")
    assert np.all(got[:, :, :5] == 0) and np.all(np.isfinite(got))
    assert np.abs(got[:, :, 5:]).max() > 0
    # the reference's Pallas path returns mean(v) on the empty rows
    pallas = _jax(jops.attention_pallas, q, k, v, causal=True, q_offset=-5,
                  block_q=16, block_k=16)
    assert np.abs(pallas[:, :, :5]).max() > 1e-2
    none = _port(q, k, v, causal=True, window=0)
    assert np.all(none == 0)


def test_sm_scale():
    q, k, v = _inputs(21, 2, 4, 2, 16, 24, 32)
    for scale in (0.05, 1.0):
        kw = dict(causal=False, sm_scale=scale)
        _close(_port(q, k, v, **kw), _jax(jref.attention_ref, q, k, v, **kw),
               "float32")


@given(sq=st.sampled_from([1, 5, 16, 32, 48]),
       skv=st.sampled_from([1, 16, 23, 32, 64]),
       h=st.sampled_from([1, 2, 4]), g=st.sampled_from([1, 2]),
       causal=st.booleans(), seed=st.integers(0, 1000))
@settings(max_examples=15, deadline=None)
def test_attention_property(sq, skv, h, g, causal, seed):
    if h % g:
        g = 1
    q, k, v = _inputs(seed, 1, h, h // g, sq, skv, 16)
    off = max(0, skv - sq) if causal else 0
    kw = dict(causal=causal, q_offset=off)
    _close(_port(q, k, v, **kw), _jax(jref.attention_ref, q, k, v, **kw),
           "float32")


def test_plain_version_matches_op_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 1, 4, 2, 20, 30, 32))
    kw = dict(causal=True, window=9, q_offset=10)
    assert torch.equal(tops.attention(q, k, v, **kw),
                       tref.attention_ref(q, k, v, **kw))


def test_backend_refusals_and_typed_errors():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="kernel backend"):
        tops.attention(q, k, k, backend="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.attention(q, k, k, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.flash_attention(q, k, k)
    with pytest.raises(CompileError) as exc:
        tops.attention(q, torch.zeros((1, 3, 8, 16)),
                       torch.zeros((1, 3, 8, 16)))
    assert exc.value.constraint == "kernel-gqa-heads"
    # a tensor that is not on the CPU never reaches the plain version
    meta = torch.empty((1, 4, 8, 16), device="meta")
    meta_kv = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="plain version"):
        tops.attention(meta, meta_kv, meta_kv, backend="torch")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.attention(meta, meta_kv, meta_kv)


def test_kernel_input_checks():
    """What the kernel does not take raises before any launch."""
    def t(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    q, kv = t((1, 4, 8, 32)), t((1, 2, 8, 32))
    assert tkernel.check_inputs(q, kv, kv) == (1, 4, 2, 8, 8, 32)
    bad = [
        ((t((1, 4, 8, 48)), t((1, 2, 8, 48)), t((1, 2, 8, 48))), "head dim"),
        ((t((1, 4, 8, 32), torch.float16), kv, kv), "float32 or all"),
        ((q, t((1, 2, 8, 32), torch.bfloat16), kv), "float32 or all"),
        ((q.transpose(2, 3), kv, kv), "contiguous"),
        ((q, kv, t((1, 2, 9, 32))), "k and v of shape"),
        ((q, t((2, 2, 8, 32)), t((2, 2, 8, 32))), "k and v of shape"),
        ((t((1, 4, 0, 32)), kv, kv), "empty"),
        ((t((4, 8, 32)), kv, kv), "4-D"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tkernel.check_inputs(*args)
    with pytest.raises(CompileError) as exc:
        tkernel.check_inputs(q, t((1, 3, 8, 32)), t((1, 3, 8, 32)))
    assert exc.value.constraint == "kernel-gqa-heads"


def test_cpu_call_leaves_launch_counters():
    before = (tops.launches, tops.attention_launches)
    q = torch.ones((1, 2, 4, 16))
    out = tops.attention(q, q, q, backend="torch")
    tops.attention(q, q, q)
    assert out.shape == q.shape
    assert (tops.launches, tops.attention_launches) == before


def test_module_imports_and_build_without_nvcc_raises(tmp_path, monkeypatch):
    """The kernel module imports on a host with no nvcc; building there
    raises a typed error and falls back to nothing."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tkernel.KERNEL, "system_nvcc", tmp_path / "nvcc")
    monkeypatch.setattr(tkernel.KERNEL, "build_dir", tmp_path / "build")
    with pytest.raises(tkernel.KernelBuildError, match="nvcc not found"):
        tkernel.build()
    assert not (tmp_path / "build").exists()
    assert tkernel.library_path().name.startswith("libflash_attention_")
    assert tkernel.SOURCE.is_file()
