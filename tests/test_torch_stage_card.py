"""The operand gather kernel (``vta_stage``) on a card.

The kernel is held to its plain version (``ref.vta_stage_ref``, run on the
card too) by exact equality over every layer's tables of LeNet-5, resnet8
and the published ResNet-50 (224×224), at a batch of 3: the operand, the
INP region in block order and the RES region, from seeded source rows;
then at each benchmark cell's batch (32,768, 8,192 and 256 images) for the
layer with the largest operand, and from source rows that do not allow
16-byte loads (every chunk gathered by entry) and into the RES region of
the stack it reads.  Served, each network's logits on the card equal its
integer reference, with one ``vta_stage`` launch a layer and one more a
join, ``ops.launches`` one a layer and ``ops.alu_launches`` one an unfused
layer.

Every test here is marked ``cuda``: it decides inside the test whether a
CUDA card is present and skips on a host without one.  The module imports
no ``jax``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_stage_card.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cuda_backend as cb                  # noqa: E402
from repro_torch.kernels import ops, ref                          # noqa: E402
from repro_torch.lenet5_e2e import compile_lenet5, request_images  # noqa: E402
from repro_torch.models import lenet                            # noqa: E402
from repro_torch.models import resnet50 as r50                  # noqa: E402
from repro_torch.models import resnet8 as t8                    # noqa: E402

MODELS = ["lenet5", "resnet8", "resnet50"]
CELL_BATCH = {"lenet5": 32768, "resnet8": 8192, "resnet50": 256}
# vta_stage launches a call: one a layer, one more a join
STAGE_LAUNCHES = {"lenet5": 5, "resnet8": 14, "resnet50": 70}
ALU_LAUNCHES = {"lenet5": 2, "resnet8": 4, "resnet50": 17}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def nets():
    """model -> (net, two images, the integer reference of one image),
    compiled only where a card is present."""
    _card()
    out = {}
    weights, net5 = compile_lenet5()
    shifts = [l.spec.requant_shift for l in net5.layers]
    out["lenet5"] = (net5, request_images(2, seed=91),
                     lambda img: lenet.reference_forward_int8(
                         weights, img, shifts)[0])
    net8, g8 = t8.compile_resnet8()
    out["resnet8"] = (net8, np.stack([t8.synthetic_image(920 + s)
                                      for s in range(2)]),
                      lambda img: t8.reference_forward_int8(g8, img))
    shape = r50.ResNet50Shape()
    net50, g50 = r50.compile_resnet50(
        r50.resnet50_random_weights(shape, seed=9),
        [r50.synthetic_image(s, shape) for s in range(1, 3)],
        r50.synthetic_image(0, shape), shape=shape)
    out["resnet50"] = (net50, np.stack([r50.synthetic_image(930 + s, shape)[0]
                                        for s in range(2)]),
                       lambda img: t8.reference_forward_int8(g50, img[None]))
    return out


def _rows(batch: int, nbytes: int, dev, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(0, 256, (batch, -(-nbytes // 16) * 16),
                         dtype=torch.uint8, device=dev, generator=gen)


def _assert_gather(src, table, what: str) -> None:
    dtype = torch.int8 if table.elem == 1 else torch.int32
    n = table.index.numel()
    got = torch.full((src.shape[0], n), 7, dtype=dtype, device=src.device)
    ops.vta_stage(src, table, got)
    want = ref.vta_stage_ref(src, table.index,
                             torch.empty_like(got))
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: {int((got != want).sum())} of "
                             f"{got.numel()} elements differ from the plain "
                             f"version")


def _source_bytes(net, j: int) -> int:
    return (int(np.prod(net.input_tensor.shape[1:])) if j < 0
            else net.allocator.image_size())


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_kernel_equals_plain_on_every_layer(nets, model):
    dev = _card()
    net = nets[model][0]
    srcs, rsrcs = net._sources(), net._res_sources()
    rows = {n: _rows(3, n, dev, 9100 + n % 97)
            for n in {_source_bytes(net, j) for j in (-1, 0)}}
    for order in (False, True):
        for k, stage in enumerate(net.stage_tables(dev, block_order=order)):
            name = f"{model} {net.layers[k].spec.name} block order {order}"
            _assert_gather(rows[_source_bytes(net, srcs[k])], stage.inp,
                           name)
            if stage.res is not None:
                _assert_gather(rows[_source_bytes(net, rsrcs[k])],
                               stage.res, name + " RES")


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_kernel_equals_plain_at_the_cells_batch(nets, model):
    """The largest operand at the cell's batch, and the largest RES."""
    dev = _card()
    net = nets[model][0]
    stages = net.stage_tables(dev)
    k = max(range(len(stages)), key=lambda i: stages[i].inp.index.numel())
    batch = CELL_BATCH[model]
    table = stages[k].inp
    _assert_gather(_rows(batch, table.span[1], dev, 9200), table,
                   f"{model} {net.layers[k].spec.name} x{batch}")
    joins = [s.res for s in stages if s.res is not None]
    if joins:
        table = max(joins, key=lambda t: t.index.numel())
        _assert_gather(_rows(batch, table.span[1], dev, 9300), table,
                       f"{model} largest RES x{batch}")


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_unaligned_sources_and_a_destination_in_the_stack(nets, model):
    """Source rows one byte off a 16-byte boundary (the kernel then reads
    every chunk entry by entry), and a RES region written inside the very
    stack rows the gather reads."""
    dev = _card()
    net = nets[model][0]
    stages = net.stage_tables(dev)
    srcs = net._sources()
    for k, stage in enumerate(stages):
        if srcs[k] < 0:
            continue
        n = net.allocator.image_size()
        src = _rows(3, n + 16, dev, 9400 + k)[:, 1:n + 1]
        assert src.data_ptr() % 16
        _assert_gather(src, stage.inp, f"{model} unaligned k={k}")
        break
    k = next((i for i, s in enumerate(stages) if s.res is not None), None)
    if k is None:
        return
    p = cb.plan_cuda(net.layers[k].program)
    stack = _rows(3, net.allocator.image_size(), dev, 9500)
    src_copy = stack.clone()
    out = cb._region(stack, p.res, torch.int32)
    ops.vta_stage(stack, stages[k].res, out)
    want = ref.vta_stage_ref(src_copy, stages[k].res.index,
                             torch.empty_like(out))
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    lo, size = p.res
    assert torch.equal(stack[:, :lo], src_copy[:, :lo])
    assert torch.equal(stack[:, lo + size:], src_copy[:, lo + size:])


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_serve_matches_reference_with_one_gather_a_destination(nets, model):
    dev = _card()
    net, images, reference = nets[model]
    net.serve(images, device=dev)                       # tables built
    ops.reset_launches()
    got, _ = net.serve(images, device=dev)
    assert ops.stage_launches == STAGE_LAUNCHES[model]
    assert ops.launches == len(net.layers)
    assert ops.alu_launches == ALU_LAUNCHES[model]
    for img, row in zip(images, got):
        np.testing.assert_array_equal(row.reshape(-1),
                                      np.asarray(reference(img)).reshape(-1))
