"""ResNet-50's TensorAlu programs on a card: ``vta_alu`` over the stem's
tiled 3×3/s2 max pool, a join and the join + GAP tree over 9 and 49
positions, held to ``cuda_backend.plain_alu_epilogue`` (run on the card
too) by exact equality of the whole DRAM stack it leaves, with full-range
int32 inputs and both commits; the published stem's pool with its bias
preload read from its compiled image, as ``serve`` reads it; then the small ResNet-50 served on the card equal to the CPU with one
``vta_alu`` launch an unfused layer.

Every test here is marked ``cuda`` and skips on a host without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_resnet50_card.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cuda_backend as cb                  # noqa: E402
from repro_torch.core.layer_compiler import LayerSpec, compile_layer  # noqa
from repro_torch.kernels import ops                              # noqa: E402
from repro_torch.models import resnet50 as r50                  # noqa: E402
from test_torch_alu_epilogue_card import (_assert_same, _card,   # noqa: E402
                                          _kernel, _plain)

SMALL = r50.ResNet50Shape(input_hw=96, stem_width=8, widths=(8, 16, 32, 64))


@pytest.fixture(scope="module")
def small():
    weights = r50.resnet50_random_weights(SMALL, seed=11)
    calib = [r50.synthetic_image(s, SMALL) for s in range(1, 4)]
    return r50.compile_resnet50(weights, calib, r50.synthetic_image(0, SMALL),
                                shape=SMALL)[0]


def _full_stem():
    """The published stem (7×7/s2 conv 3→64, ReLU, the tiled 3×3/s2 max
    pool) compiled alone on a 224×224 image."""
    rng = np.random.default_rng(3)
    spec = LayerSpec("stem", "conv",
                     rng.integers(-5, 6, (64, 3, 7, 7)).astype(np.int8),
                     rng.integers(-64, 65, 64).astype(np.int32), stride=2,
                     padding=3, relu=True, pool="max3x3s2", requant_shift=9)
    image = rng.integers(-64, 64, (1, 3, 224, 224)).astype(np.int8)
    return compile_layer(spec, image).program


def _stack_case(prog, batch: int, dev, seed: int):
    p = cb.plan_cuda(prog)
    rng = np.random.default_rng(seed)
    mp, np_ = p.padded_shape
    gemm = rng.integers(-(2 ** 31), 2 ** 31, (batch, mp, np_),
                        dtype=np.int64).astype(np.int32)
    size = prog.allocator.image_size()
    stack = rng.integers(0, 256, (batch, -(-size // 16) * 16), dtype=np.uint8)
    return p, torch.from_numpy(gemm).to(dev), torch.from_numpy(stack).to(dev)


def _check(prog, batch, dev, seed):
    p, gemm, stack = _stack_case(prog, batch, dev, seed)
    for saturate in (False, True):
        _assert_same(_kernel(p, gemm, stack, saturate, stack[:1]),
                     _plain(p, gemm, stack, saturate, stack[:1]), p)


@pytest.mark.cuda
@pytest.mark.parametrize("name, kind", [("stem", "maxpool3x3s2"),
                                        ("s1b2c", "join"),
                                        ("s4b3c", "join+gap")])
def test_kernel_equals_plain_on_small_programs(small, name, kind):
    dev = _card()
    prog = next(l.program for l in small.layers if l.spec.name == name)
    assert prog.alu_kind == kind
    _check(prog, 33, dev, 7100 + len(name))


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_published_stem():
    dev = _card()
    prog = _full_stem()
    assert prog.chunk_plan.n_chunks > 1
    _check(prog, 4, dev, 7200)


@pytest.mark.cuda
def test_published_stem_reads_acc_from_its_image():
    """The stem's 3×3/s2 pool works in place in the GEMM's result (past
    shared memory) with ACC read from the compiled image, one row for the
    batch's 5 images."""
    dev = _card()
    prog = _full_stem()
    p, gemm, stack = _stack_case(prog, 5, dev, 7400)
    image = torch.from_numpy(prog.dram_image()).to(dev).reshape(1, -1)
    n = p.alpha * p.beta * p.row_height * p.block_size
    assert n * 4 > 232_448                      # past shared memory
    for saturate in (False, True):
        _assert_same(_kernel(p, gemm, stack, saturate, image),
                     _plain(p, gemm, stack, saturate, image), p)


@pytest.mark.cuda
def test_kernel_equals_plain_on_a_49_position_gap():
    dev = _card()
    rng = np.random.default_rng(4)
    spec = LayerSpec("c", "conv",
                     rng.integers(-5, 6, (2048, 512, 1, 1)).astype(np.int8),
                     rng.integers(-64, 65, 2048).astype(np.int32),
                     relu=True, pool="gap", residual_add=True,
                     residual_pre_shift=1)
    image = rng.integers(0, 64, (1, 512, 7, 7)).astype(np.int8)
    skip = rng.integers(0, 64, (1, 2048, 7, 7)).astype(np.int8)
    prog = compile_layer(spec, image, residual=skip).program
    assert prog.alu_kind == "join+gap"
    _check(prog, 17, dev, 7300)


@pytest.mark.cuda
def test_small_model_serves_on_card_as_on_cpu(small):
    dev = _card()
    images = np.stack([r50.synthetic_image(300 + s, SMALL)[0]
                       for s in range(24)])
    want, _ = small.serve(images, device="cpu")
    small.serve(images[:2], device=dev)             # builds and warms
    ops.reset_launches()
    got, _ = small.serve(images, device=dev)
    np.testing.assert_array_equal(got, want)
    assert ops.alu_launches == 17                   # the stem, 16 joins
    assert ops.launches == len(small.layers)
