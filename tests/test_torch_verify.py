"""The reference's three checking functions in the port, held against the
JAX package on the CPU:

* ``core.layer_compiler.verify_layer`` on LeNet-5's first layer (conv +
  ReLU + 2×2 average pool) and its fc4 layer (fc + ReLU): the layer's
  program reproduces the compiler's OUT region on every backend
  (``oracle``, ``fast``, ``batched``, ``cuda`` on ``device="cpu"``), and
  the report's loop and traffic counts equal the reference's
  ``verify_layer`` on its ``oracle`` and ``fast`` backends;
* ``NetworkProgram.verify`` on LeNet-5 and resnet8: the chain over the
  compile-time input equals the compiler's reference of the last layer on
  each backend, and the reference's ``verify`` returns the same output;
  an output that differs from that reference raises;
* ``models.lenet.reference_forward_float`` within ``FLOAT_RTOL`` of the
  reference's float32 logits on ``synthetic_digit`` images (float32
  summation order differs between XLA's and torch's convolutions: a few
  ulps of the largest logit).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.layer_compiler as jlc                          # noqa: E402
import repro.core.network_compiler as jnc                        # noqa: E402
import repro.models.lenet as jlenet                              # noqa: E402
import repro.models.resnet8 as j8                                # noqa: E402
import repro_torch.core.layer_compiler as tlc                    # noqa: E402
import repro_torch.core.network_compiler as tnc                  # noqa: E402
import repro_torch.models.lenet as tlenet                        # noqa: E402
import repro_torch.models.resnet8 as t8                          # noqa: E402
from repro_torch.core.errors import CompileError                 # noqa: E402

FLOAT_RTOL = 1e-5
COUNTS = ("gemm_loops", "gemm_reset_loops", "alu_loops", "dram_bytes_read",
          "dram_bytes_written", "insn_executed", "dep_pops", "dep_pushes")


def _cal():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 128, (1, 1, 32, 32)).astype(np.int8)
            for _ in range(8)]


@pytest.fixture(scope="module")
def lenets():
    image = tlenet.synthetic_digit(3)
    tw = tlenet.lenet5_random_weights(seed=0)
    jw = jlenet.lenet5_random_weights(seed=0)
    tnet = tnc.compile_network(
        tlenet.lenet5_specs(tw, tlenet.calibrate_shifts(tw, _cal())), image)
    jnet = jnc.compile_network(
        jlenet.lenet5_specs(jw, jlenet.calibrate_shifts(jw, _cal())), image)
    return tnet, jnet


@pytest.fixture(scope="module")
def resnets():
    tn, _ = t8.compile_resnet8()
    jn, _ = j8.compile_resnet8()
    return tn, jn


@pytest.mark.parametrize("backend", ["oracle", "fast", "batched", "cuda"])
@pytest.mark.parametrize("layer_idx", [0, 3])
def test_verify_layer_matches_reference(lenets, layer_idx, backend):
    """LeNet-5 layer 0 (conv + ReLU + pool) and layer 3 (fc + ReLU): the
    port's ``verify_layer`` passes on the backend, and its counts equal
    the reference's on the oracle (the ``cuda`` report counts what the
    kernel replaced, as the reference's ``pallas`` one does)."""
    tnet, jnet = lenets
    tl, jl = tnet.layers[layer_idx], jnet.layers[layer_idx]
    assert tl.spec.kind == ("conv" if layer_idx == 0 else "fc")
    if layer_idx == 0:
        assert tl.keep_rows is not None             # the pool's rows
    got = tlc.verify_layer(tl, backend=backend, device="cpu")
    want = jlc.verify_layer(jl, backend="oracle")
    assert jlc.verify_layer(jl, backend="fast").gemm_loops == want.gemm_loops
    if backend == "cuda":
        assert got.gemm_loops == want.gemm_loops
        return
    for field in COUNTS:
        assert getattr(got, field) == getattr(want, field), field


def test_verify_layer_refuses_a_wrong_output(lenets):
    """A program whose expected OUT region is not what it computes fails
    ``verify_layer`` on the port, as on the reference."""
    tnet, _ = lenets
    prog = tnet.layers[3].program
    bad = dataclasses.replace(tnet.layers[3], program=dataclasses.replace(
        prog, expected_out=prog.expected_out + np.int8(1)))
    with pytest.raises(AssertionError, match="mismatch"):
        tlc.verify_layer(bad, backend="fast", device="cpu")


@pytest.mark.parametrize("backend", ["oracle", "fast", "batched", "cuda"])
def test_network_verify_lenet5(lenets, backend):
    """LeNet-5's chain over its compile-time input (``synthetic_digit(3)``)
    equals the compiler's fc5 reference and the reference's ``verify``
    output, with one report a layer."""
    tnet, jnet = lenets
    out, reports = tnet.verify(backend=backend, device="cpu")
    want, _ = jnet.verify(backend="fast")
    assert out.dtype == np.int8 and out.shape == (1, 10)
    np.testing.assert_array_equal(out, want)
    assert len(reports) == len(tnet.layers)
    assert [r.gemm_loops for r in reports] == tnet.gemm_loops_per_layer()


@pytest.mark.parametrize("backend", ["oracle", "fast", "batched", "cuda"])
def test_network_verify_resnet8(resnets, backend):
    """resnet8's DAG (residual joins, strided convs) over its
    compile-time input equals the compiler's reference and the
    reference's ``verify`` output."""
    tn, jn = resnets
    out, reports = tn.verify(backend=backend, device="cpu")
    want, _ = jn.verify(backend="fast")
    np.testing.assert_array_equal(out, want)
    assert len(reports) == len(tn.layers)


def test_network_verify_refuses(lenets):
    """A wrong final output raises; an unknown backend is refused."""
    tnet, _ = lenets
    last = tnet.layers[-1]
    bad = dataclasses.replace(
        tnet, layers=tnet.layers[:-1] + [dataclasses.replace(
            last, ref_output_matrix=last.ref_output_matrix + np.int8(1))])
    with pytest.raises(AssertionError, match="compiler's reference"):
        bad.verify(backend="fast", device="cpu")
    with pytest.raises(CompileError) as err:
        tnet.verify(backend="pallas", device="cpu")
    assert err.value.constraint == "verify-backend"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reference_forward_float_matches_jax(seed):
    """The port's float forward on ``device="cpu"`` against the
    reference's ``reference_forward_float`` over the same integer-valued
    weights, within ``FLOAT_RTOL`` × max |logit|."""
    tw = tlenet.lenet5_random_weights(seed=seed)
    jw = jlenet.lenet5_random_weights(seed=seed)
    image = tlenet.synthetic_digit(seed)
    np.testing.assert_array_equal(image, jlenet.synthetic_digit(seed))
    got = tlenet.reference_forward_float(tw, image, device="cpu")
    want = jlenet.reference_forward_float(jw, image)
    assert got.shape == want.shape == (1, 10) and got.dtype == np.float32
    err = float(np.max(np.abs(got - want)))
    assert err <= FLOAT_RTOL * float(np.max(np.abs(want))), err
