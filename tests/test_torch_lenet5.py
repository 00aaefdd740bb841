"""LeNet-5 served by the port (device ``cpu``) against the reference.

* the device-side staging and decode (``repro_torch.core.staging``) are
  byte-identical to the reference's numpy functions on every LeNet layer;
* the port's ``serve`` is bit-identical to the reference's
  ``serve(backend="batched")``, ``serve(backend="pallas")`` (interpret
  mode) and ``reference_forward_int8``, and refuses what the reference
  refuses;
* ``lenet_weights_from_arrays`` and ``LeNet5Float`` take the reference's
  weights, and the float model agrees with the JAX float forward.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.conv_lowering as jconv                         # noqa: E402
import repro.core.layer_compiler as jlc                          # noqa: E402
import repro.core.layout as jlayout                              # noqa: E402
import repro.core.network_compiler as jnc                        # noqa: E402
import repro.core.simulator as jsim                              # noqa: E402
import repro.models.lenet as jlenet                              # noqa: E402
import repro_torch.core.network_compiler as tnc                  # noqa: E402
import repro_torch.models.lenet as tlenet                        # noqa: E402
from repro_torch.core import staging                             # noqa: E402
from repro_torch.core.errors import CompileError                 # noqa: E402
from repro_torch.harden import GuardPolicy                        # noqa: E402
from repro_torch.kernels import ops as tops                      # noqa: E402
from torch_stage_helpers import batch_matrix_to_binary          # noqa: E402


def _cal():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 128, (1, 1, 32, 32)).astype(np.int8)
            for _ in range(8)]


@pytest.fixture(scope="module")
def nets():
    tw = tlenet.lenet5_random_weights(seed=0)
    jw = jlenet.lenet5_random_weights(seed=0)
    tnet = tnc.compile_network(
        tlenet.lenet5_specs(tw, tlenet.calibrate_shifts(tw, _cal())),
        np.zeros((1, 1, 32, 32), np.int8))
    jnet = jnc.compile_network(
        jlenet.lenet5_specs(jw, jlenet.calibrate_shifts(jw, _cal())),
        np.zeros((1, 1, 32, 32), np.int8))
    return tw, tnet, jw, jnet


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 128, (1, 1, 32, 32)).astype(np.int8)
                     for _ in range(n)])


@pytest.mark.parametrize("layer_idx", range(5))
def test_staging_byte_identical(nets, layer_idx):
    """im2row / flatten → pad → split → binarise, and the OUT decode +
    semantic reshaping, against the numpy functions on one LeNet layer."""
    _, tnet, _, jnet = nets
    jl, tl = jnet.layers[layer_idx], tnet.layers[layer_idx]
    rng = np.random.default_rng(40 + layer_idx)
    shape = jl.input_matrix.shape
    b = 3
    if jl.spec.kind == "conv":
        c = jl.spec.weights.shape[1]
        hw = {0: 32, 1: 14, 2: 5}[layer_idx]
        sem = rng.integers(-128, 128, (b, c, hw, hw)).astype(np.int8)
        _, _, kh, kw = jl.spec.weights.shape
        A = jconv.im2row_batch(sem, kh, kw)
        A_t = staging.im2row_batch(torch.from_numpy(sem), kh, kw)
        np.testing.assert_array_equal(A_t.numpy(), A)
    else:
        A = rng.integers(-128, 128, (b,) + shape).astype(np.int8)
        A_t = torch.from_numpy(A)
    raw = jlayout.batch_matrix_to_binary(A, 16, np.int8)
    raw_t = batch_matrix_to_binary(A_t, 16, torch.int8)
    np.testing.assert_array_equal(raw_t.numpy(), raw)
    acc = rng.integers(-(2 ** 31), 2 ** 31, (b,) + shape).astype(np.int32)
    np.testing.assert_array_equal(
        batch_matrix_to_binary(torch.from_numpy(acc), 16,
                                       torch.int32).numpy(),
        jlayout.batch_matrix_to_binary(acc, 16, np.int32))

    image = jnet.dram_image()
    stack = np.broadcast_to(image, (b, image.size)).copy()
    region = jl.program.regions["out"]
    start = region.phys_addr - jnet.allocator.offset
    stack[:, start:start + region.nbytes] = \
        rng.integers(0, 256, (b, region.nbytes), dtype=np.uint8)
    mats = jsim.decode_out_region_batch(jl.program, stack)
    mats_t = staging.decode_out_region_batch(tl.program,
                                             torch.from_numpy(stack))
    np.testing.assert_array_equal(mats_t.numpy(), mats)
    sem_t = staging.decode_layer_output_batch(tl, mats_t).numpy()
    for i in range(b):
        want = jlc.decode_layer_output(jl, mats[i])
        got = sem_t[i][None] if jl.spec.kind == "conv" else sem_t[i]
        np.testing.assert_array_equal(got, want)


def test_serve_batch8_matches_batched_and_int8_reference(nets):
    tw, tnet, jw, jnet = nets
    images = _images(8, 42)
    before = tops.launches
    got, reports = tnet.serve(images, device="cpu")
    assert tops.launches == before
    want, jreports = jnet.serve(images, backend="batched")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8, 1, 10) and got.dtype == np.int8
    assert [r.gemm_loops for r in reports] == \
        [r.gemm_loops for r in jreports]
    shifts = [l.requant_shift for l in tnet.layers]
    for img, logits in zip(images, got):
        ref, _ = tlenet.reference_forward_int8(tw, img, shifts)
        np.testing.assert_array_equal(logits, ref)
    # a list of per-image arrays is the same batch
    got_list, _ = tnet.serve(list(images), device="cpu")
    np.testing.assert_array_equal(got_list, got)


def test_serve_batch2_matches_pallas(nets):
    _, tnet, _, jnet = nets
    images = _images(2, 817)
    got, _ = tnet.serve(images, device="cpu")
    want, _ = jnet.serve(images, backend="pallas")
    np.testing.assert_array_equal(got, want)


def test_serve_one_and_run_functional(nets):
    _, tnet, _, jnet = nets
    img = _images(1, 818)[0]
    np.testing.assert_array_equal(tnet.serve_one(img, device="cpu"),
                                  jnet.serve_one(img, backend="fast"))
    out_t, reps = tnet.run_functional(device="cpu")
    out_j, _ = jnet.run_functional(backend="fast")
    np.testing.assert_array_equal(out_t, out_j)
    assert len(reps) == 5


def test_serve_refusals(nets):
    """The reference's refusal set, with ``cuda`` in the place of
    ``pallas``: ``batched`` serves, with and without a guard; the ``cuda``
    backend refuses a guard, a fault hook and the overflow counters;
    ``serve_one`` serves on ``fast`` and refuses the batch engine."""
    _, tnet, _, jnet = nets
    images = _images(2, 1)
    want, _ = jnet.serve(images, backend="batched")
    got, _ = tnet.serve(images, backend="batched", device="cpu")
    np.testing.assert_array_equal(got, want)
    outs, _, reps = tnet.serve(images, backend="batched", device="cpu",
                               guard=GuardPolicy())
    np.testing.assert_array_equal(outs, want)
    assert [r.outcome for r in reps] == ["clean", "clean"]
    for kw, constraint in ((dict(backend="fast"), "serve-backend"),
                           (dict(guard=object()), "serve-guard-backend"),
                           (dict(fault_hook=lambda *a: None),
                            "serve-fault-hook"),
                           (dict(count_overflows=True),
                            "serve-count-overflows")):
        with pytest.raises(CompileError) as exc:
            tnet.serve(images, device="cpu", **kw)
        assert exc.value.constraint == constraint
    np.testing.assert_array_equal(
        tnet.serve_one(images[0], backend="fast", device="cpu"),
        jnet.serve_one(images[0], backend="fast"))
    with pytest.raises(CompileError) as exc:
        tnet.serve_one(images[0], backend="batched", device="cpu")
    assert exc.value.constraint == "serve-one-backend"
    with pytest.raises(ValueError, match="cannot interpret"):
        tnet.serve(np.zeros((2, 3, 32, 32), np.int8), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tnet.serve([], device="cpu")


def test_weights_from_reference_arrays(nets):
    tw, _, jw, _ = nets
    arrays = dataclasses.asdict(jw)
    weights = tlenet.lenet_weights_from_arrays(arrays)
    for name, arr in dataclasses.asdict(tw).items():
        np.testing.assert_array_equal(getattr(weights, name), arr)
    bad = dict(arrays)
    del bad["fc5_b"]
    with pytest.raises(tlenet.WeightsError) as exc:
        tlenet.lenet_weights_from_arrays(bad)
    assert exc.value.constraint == "weights-missing"
    assert exc.value.name == "fc5_b"
    for mutate, constraint in (
            (lambda d: d.update(extra=np.zeros(1)), "weights-unexpected"),
            (lambda d: d.update(fc4_w=d["fc4_w"][:, :80]), "weights-shape"),
            (lambda d: d.update(conv1_b=d["conv1_b"].astype(np.int64)),
             "weights-dtype"),
            (lambda d: d.update(conv1_w=d["conv1_w"].astype(np.float32)),
             "weights-dtype")):
        bad = dict(arrays)
        mutate(bad)
        with pytest.raises(tlenet.WeightsError) as exc:
            tlenet.lenet_weights_from_arrays(bad)
        assert exc.value.constraint == constraint
    assert issubclass(tlenet.WeightsError, ValueError)


def test_float_model_matches_jax_forward(nets):
    _, _, jw, _ = nets
    model = tlenet.LeNet5Float(dataclasses.asdict(jw))
    images = _images(4, 99)
    with torch.no_grad():
        got = model(torch.from_numpy(
            images.reshape(4, 1, 32, 32).astype(np.float32))).numpy()
    for i, img in enumerate(images):
        want = jlenet.reference_forward_float(jw, img)
        # float32 sums taken in another order than XLA's: relative 1e-5
        np.testing.assert_allclose(got[i:i + 1], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert np.argmax(got[i]) == np.argmax(want)
