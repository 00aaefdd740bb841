"""The port's ``vta_gemm`` wrapper and plain version against the reference.

The same seeded numpy inputs go through ``repro.kernels`` (the XLA
reference ``ref.vta_gemm_ref`` and the Pallas kernel in interpret mode,
``ops.vta_matmul_pallas``) and through ``repro_torch.kernels`` on CPU
tensors, where the wrapper runs the plain torch version.  Integer
results must be bit-identical.  The CUDA kernel itself runs only on a
card; ``chip_smoke.py`` holds it against the plain version there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops                            # noqa: E402
from repro.kernels import ref as jref                            # noqa: E402
from repro_torch.core.errors import CompileError                 # noqa: E402
from repro_torch.kernels import ops as tops                      # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402
from repro_torch.kernels import vta_gemm as tkernel              # noqa: E402

GEMM_SHAPES = [(8, 128, 128), (100, 300, 200), (256, 256, 256),
               (1, 17, 5), (130, 200, 140), (512, 128, 384)]
_T_DTYPE = {jnp.int8: torch.int8, jnp.int32: torch.int32}


def _port(a, b, bias=None, **kw):
    """The port's wrapper on CPU tensors (→ the plain version)."""
    if "out_dtype" in kw:
        kw["out_dtype"] = _T_DTYPE[kw["out_dtype"]]
    out = tops.vta_matmul(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(bias) if bias is not None
                          else None, **kw)
    return out.numpy()


def _jax(fn, a, b, bias=None, **kw):
    return np.asarray(fn(jnp.asarray(a), jnp.asarray(b),
                         jnp.asarray(bias) if bias is not None else None,
                         **kw))


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_shapes_match_reference_and_pallas(m, k, n):
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    got = _port(a, b)
    np.testing.assert_array_equal(got, _jax(jref.vta_gemm_ref, a, b))
    np.testing.assert_array_equal(got, _jax(jops.vta_matmul_pallas, a, b))
    plain = tref.vta_gemm_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(plain.numpy(), got)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shift", [0, 3, 8])
@pytest.mark.parametrize("saturate", [False, True])
def test_epilogues_match_pallas(relu, shift, saturate):
    rng = np.random.default_rng(42)
    a = rng.integers(-128, 128, (64, 96)).astype(np.int8)
    b = rng.integers(-128, 128, (96, 80)).astype(np.int8)
    bias = rng.integers(-5000, 5000, (80,)).astype(np.int32)
    kw = dict(relu=relu, shift=shift, saturate=saturate)
    got = _port(a, b, bias, **kw)
    np.testing.assert_array_equal(got, _jax(jops.vta_matmul_pallas, a, b,
                                            bias, **kw))
    np.testing.assert_array_equal(got, _jax(jref.vta_gemm_ref, a, b, bias,
                                            **kw))


@pytest.mark.parametrize("out_dtype", [jnp.int8, jnp.int32])
def test_out_dtypes(out_dtype):
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (32, 64)).astype(np.int8)
    b = rng.integers(-128, 128, (64, 32)).astype(np.int8)
    got = _port(a, b, out_dtype=out_dtype)
    assert got.dtype == np.dtype(out_dtype)
    np.testing.assert_array_equal(
        got, _jax(jops.vta_matmul_pallas, a, b, out_dtype=out_dtype))


def _requant_reference(a, b, bias, *, relu, shift, saturate):
    """``gemm_compiler``'s requant semantics in plain numpy (as the
    reference's backend tests spell them)."""
    from repro.core.gemm_compiler import _wrap_int32
    from repro.core.layout import truncate_int8
    acc = _wrap_int32(a.astype(np.int64) @ b.astype(np.int64))
    if bias is not None:
        acc = _wrap_int32(acc.astype(np.int64) + bias.astype(np.int64))
    if relu:
        acc = np.maximum(acc, 0)
    if shift:
        acc = _wrap_int32(acc.astype(np.int64) >> shift)
    if saturate:
        return np.clip(acc, -128, 127).astype(np.int8)
    return truncate_int8(acc)


@pytest.mark.parametrize("m,k,n", [(16, 16, 16), (1, 129, 130), (40, 300, 24),
                                   (5, 7, 3), (64, 64, 64), (33, 257, 65)])
def test_requant_semantics_grid(m, k, n):
    """bias × relu × shift × saturate with a bias wide enough to wrap:
    the plain version equals the compiler's requant reference and the
    XLA reference elementwise."""
    rng = np.random.default_rng(808 + m + k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    bias = rng.integers(-(2 ** 20), 2 ** 20, (n,)).astype(np.int32)
    for use_bias in (False, True):
        for relu in (False, True):
            for shift in (0, 5):
                for saturate in (False, True):
                    bb = bias if use_bias else None
                    kw = dict(relu=relu, shift=shift, saturate=saturate)
                    got = _port(a, b, bb, **kw)
                    np.testing.assert_array_equal(
                        got, _requant_reference(a, b, bb, **kw),
                        err_msg=f"{(m, k, n)} bias={use_bias} {kw}")
                    np.testing.assert_array_equal(
                        got, _jax(jref.vta_gemm_ref, a, b, bb, **kw))


@pytest.mark.parametrize("out_dtype", [jnp.int32, jnp.int8])
def test_int32_wrap_case(out_dtype):
    """A·B + bias crosses 2**31 upward and downward: the accumulate wraps
    exactly as the reference's int32 does."""
    a = np.full((40, 256), 127, np.int8)
    b = np.full((256, 24), 127, np.int8)
    b[:, 12:] = -127
    bias = np.array([2 ** 31 - 1000] * 12 + [-(2 ** 31) + 7] * 12, np.int32)
    got = _port(a, b, bias, out_dtype=out_dtype, saturate=False)
    want = _jax(jref.vta_gemm_ref, a, b, bias, out_dtype=out_dtype,
                saturate=False)
    np.testing.assert_array_equal(got, want)
    if out_dtype == jnp.int32:
        acc = 127 * 127 * 256
        assert got[0, 0] == 2 ** 31 - 1000 + acc - 2 ** 32
        assert got[0, 12] == -(2 ** 31) + 7 - acc + 2 ** 32


def test_large_shift_fills_sign():
    a = np.array([[-3, 5]], np.int8)
    b = np.array([[100], [1]], np.int8)
    for shift in (31, 40):
        got = _port(a, b, shift=shift, out_dtype=jnp.int32)
        np.testing.assert_array_equal(got, [[-1]])


def test_typed_errors():
    a = torch.zeros((16, 16), dtype=torch.int8)
    with pytest.raises(CompileError) as exc:
        tops.vta_matmul(a, torch.zeros((8, 16), dtype=torch.int8))
    assert exc.value.constraint == "kernel-gemm-shape"
    with pytest.raises(ValueError, match="kernel backend"):
        tops.vta_matmul(a, a, backend="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.vta_matmul(a, a, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.vta_gemm(a, a)
    assert issubclass(CompileError, ValueError)


def test_cpu_call_leaves_launch_counter():
    before = tops.launches
    a = torch.ones((4, 8), dtype=torch.int8)
    out = tops.vta_matmul(a, a.T.contiguous(), backend="torch")
    assert out.shape == (4, 4)
    tops.vta_matmul(a, a.T.contiguous())
    assert tops.launches == before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """With no nvcc reachable the build raises a typed error (and does
    not fall back to anything)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tkernel.KERNEL, "system_nvcc", tmp_path / "nvcc")
    monkeypatch.setattr(tkernel.KERNEL, "build_dir", tmp_path / "build")
    with pytest.raises(tkernel.KernelBuildError, match="nvcc not found"):
        tkernel.build()
    assert not (tmp_path / "build").exists()
    assert tkernel.library_path().name.startswith("libvta_gemm_")
