"""The served chain's operand gather (``vta_stage``) on the CPU.

``NetworkProgram.stage_tables`` builds, once per network and device, the index
each layer's GEMM operand and RES region is gathered through, by running
the torch staging functions over an index tensor.  Here, for every layer
of LeNet-5, resnet8 and the small ResNet-50: from the OUT bytes of a served
stack (and the input batch, for the first layer), the plain gather through
the tables equals what the torch staging chain builds from the same bytes
(OUT decoded, im2row or flatten, the tiled pool's rows, the pad and split),
byte for byte: the operand with its pad rows and columns, the INP region
in block order and the int32 RES region.  Then the table itself: the runs
it marks, the kernel's launch plan and the wrapper's refusals.  The kernel
is held to the plain version on the card (``tests/test_torch_stage_card.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cuda_backend as cb                  # noqa: E402
from repro_torch.core import staging                             # noqa: E402
from repro_torch.kernels import ops, ref                          # noqa: E402
from repro_torch.kernels import vta_stage                        # noqa: E402
from repro_torch.lenet5_e2e import compile_lenet5, request_images  # noqa: E402
from repro_torch.models import resnet50 as r50                  # noqa: E402
from repro_torch.models import resnet8 as t8                    # noqa: E402
from torch_stage_helpers import batch_matrix_to_binary          # noqa: E402

MODELS = ["lenet5", "resnet8", "resnet50_small"]
SMALL = r50.ResNet50Shape(input_hw=96, stem_width=8, widths=(8, 16, 32, 64))
BATCH = 3


@pytest.fixture(scope="module")
def nets():
    """model -> (net, a batch of images)."""
    net8, _ = t8.compile_resnet8()
    w50 = r50.resnet50_random_weights(SMALL, seed=7)
    calib = [r50.synthetic_image(s, SMALL) for s in range(1, 5)]
    net50, _ = r50.compile_resnet50(w50, calib, r50.synthetic_image(0, SMALL),
                                    shape=SMALL)
    return {"lenet5": (compile_lenet5()[1], request_images(BATCH, seed=71)),
            "resnet8": (net8, np.stack([t8.synthetic_image(810 + s)
                                        for s in range(BATCH)])),
            "resnet50_small": (net50, np.stack(
                [r50.synthetic_image(820 + s, SMALL)[0]
                 for s in range(BATCH)]))}


def _served(net, images):
    """The input batch and the stack a cuda serve leaves: every layer's
    OUT region committed."""
    first = net._as_image_batch(images, torch.device("cpu"))
    stack = torch.zeros((len(images), net.allocator.image_size()),
                        dtype=torch.uint8)
    net._run_chain(stack, first, net._kernel_executor(torch.device("cpu")),
                   operands=True)
    return first, stack


def _semantic(net, j, first, stack):
    """The torch chain's semantic output of source ``j`` (``-1`` the
    input), decoded from the stack's OUT bytes."""
    if j < 0:
        return first
    layer = net.layers[j]
    return staging.decode_layer_output_batch(
        layer, staging.decode_out_region_batch(layer.program, stack))


def _gather(src, table, dtype):
    out = torch.empty((src.shape[0], table.index.numel()), dtype=dtype)
    return ops.vta_stage(src, table, out)


@pytest.mark.parametrize("model", MODELS)
def test_gather_equals_the_staging_chain(nets, model):
    net, images = nets[model]
    first, stack = _served(net, images)
    rows = {-1: first.reshape(BATCH, -1)}
    operand = net.stage_tables("cpu")
    inp = net.stage_tables("cpu", block_order=True)
    residuals = 0
    for k, layer in enumerate(net.layers):
        p = cb.plan_cuda(layer.program)
        src, rsrc = net._sources()[k], net._res_sources()[k]
        A = staging.input_matrices_batch(
            layer, _semantic(net, src, first, stack))
        padded, rh = staging.pad_matrix_batch(A, 16, torch.int8)
        assert rh == p.row_height
        got = _gather(rows.get(src, stack), operand[k].inp, torch.int8)
        np.testing.assert_array_equal(
            got.view(padded.shape).numpy(), padded.numpy(),
            err_msg=f"{model} {layer.spec.name}: operand")
        assert not got.view(padded.shape)[:, A.shape[1]:].any()
        raw = batch_matrix_to_binary(A, 16, torch.int8)
        got = _gather(rows.get(src, stack), inp[k].inp, torch.int8)
        np.testing.assert_array_equal(
            got.view(torch.uint8).numpy(), raw.numpy(),
            err_msg=f"{model} {layer.spec.name}: INP in block order")
        # the interpreters' table is the operand's, permuted
        assert sorted(inp[k].inp.index.tolist()) == sorted(
            operand[k].inp.index.tolist())
        assert inp[k].res is operand[k].res or torch.equal(
            inp[k].res.index, operand[k].res.index)
        if rsrc is None:
            assert operand[k].res is None
            continue
        R = staging.residual_operand_batch(
            layer.spec, _semantic(net, rsrc, first, stack),
            layer.residual_matrix.shape)
        want = batch_matrix_to_binary(R, 16, torch.int32)
        got = _gather(rows.get(rsrc, stack), operand[k].res, torch.int32)
        assert got.numel() * 4 == p.res[1] * BATCH
        np.testing.assert_array_equal(
            got.view(torch.uint8).numpy(), want.numpy(),
            err_msg=f"{model} {layer.spec.name}: RES")
        residuals += 1
    assert residuals == {"lenet5": 0, "resnet8": 3,
                         "resnet50_small": 16}[model]


@pytest.mark.parametrize("model", MODELS)
def test_tables_are_built_once_per_image(nets, model, monkeypatch):
    net, images = nets[model]
    built = []
    real = type(net)._build_stages
    monkeypatch.setattr(type(net), "_build_stages",
                        lambda self, order: built.append(order)
                        or real(self, order))
    net._device_images.clear()
    net._stages.clear()
    for _ in range(2):
        net.serve(images[:2], device="cpu")
        net.serve(images[:1], backend="batched", device="cpu")
    assert built == [False, True]
    tables = net.stage_tables("cpu")
    assert net.stage_tables("cpu") is tables
    assert all(t.inp.index.dtype == torch.int32 for t in tables)
    # a replaced segment makes a new image, and keeps the tables: they
    # follow the compiled layout, not the bytes
    prog = net.layers[0].program
    image = net._device_image(torch.device("cpu"))
    original = prog.segments["wgt"]
    try:
        prog.set_segment("wgt", bytes(bytearray(original)))
        assert net._device_image(torch.device("cpu")) is not image
        net.serve(images[:2], device="cpu")
        assert net.stage_tables("cpu") is tables
        assert built == [False, True]
    finally:
        prog.set_segment("wgt", original)


def test_runs_are_read_off_the_table():
    index = torch.tensor(
        [list(range(32, 48)),                   # one aligned run
         list(range(33, 49)),                   # a run, not aligned
         [-1] * 16,                             # all zero
         list(range(16, 31)) + [-1],            # a run cut short
         list(range(64, 80))[::-1]])            # the bytes reversed
    table = vta_stage.make_table(index, elem=1, rows=5)
    assert table.runs.tolist() == [32, -1, -1, -1, -1]
    assert table.contiguous == 1 and table.chunks == 5 and table.cols == 1
    assert table.span == (16, 80)
    res = vta_stage.make_table(torch.tensor([8, 9, 10, 11, 9, 10, 11, 12,
                                             -1, -1, -1, -1]),
                               elem=4, rows=3)
    assert res.runs.tolist() == [8, -1, -1] and res.contiguous == 1
    with pytest.raises(ValueError):
        vta_stage.make_table(torch.arange(24), elem=1, rows=1)
    with pytest.raises(ValueError):
        vta_stage.make_table(torch.full((16,), -2), elem=1, rows=1)
    with pytest.raises(ValueError):
        vta_stage.make_table(torch.arange(16), elem=2, rows=1)


def test_plain_gather_zeroes_and_sign_extends():
    src = torch.tensor([[0, 127, 128, 255], [1, 2, 254, 3]],
                       dtype=torch.uint8)
    index = torch.tensor([3, -1, 2, 0], dtype=torch.int32)
    out8 = ref.vta_stage_ref(src, index, torch.empty((2, 4),
                                                     dtype=torch.int8))
    assert out8.tolist() == [[-1, 0, -128, 0], [3, 0, -2, 1]]
    out32 = ref.vta_stage_ref(src.view(torch.int8), index,
                              torch.empty((2, 4), dtype=torch.int32))
    assert out32.tolist() == [[-1, 0, -128, 0], [3, 0, -2, 1]]


@pytest.mark.parametrize("rows,cols,batch", [
    (15120, 10, 256), (1024, 9, 8192), (64, 36, 8192), (784, 2, 32768),
    (4096, 1, 3), (49, 288, 256), (1, 4, 1)])
def test_plan_covers_the_destination_once(rows, cols, batch):
    """Every chunk lies in one tile, every image in one group, a tile
    fits a block, and a group walks at least ``MIN_IMAGES`` images where
    the batch has them."""
    table = vta_stage.StageTable(
        index=torch.empty(0), runs=torch.empty(rows * cols), rows=rows,
        elem=1, span=(0, 0), contiguous=0)
    p = vta_stage.plan(table, batch, 132)
    assert p.tile_rows * p.tile_cols <= vta_stage.THREADS
    assert p.tile_cols <= vta_stage.MAX_TILE_COLS
    assert p.tiles == -(-rows // p.tile_rows) * -(-cols // p.tile_cols)
    assert (p.groups - 1) * p.per_block < batch <= p.groups * p.per_block
    assert p.per_block >= min(batch, vta_stage.MIN_IMAGES)
    assert p.groups <= vta_stage.GROUP_LIMIT
    if cols <= vta_stage.MAX_TILE_COLS:
        assert p.tile_cols == cols


def test_wrapper_takes_the_plain_version_on_the_cpu_and_launches_nothing():
    ops.reset_launches()
    table = vta_stage.make_table(torch.arange(16).flip(0), elem=1, rows=1)
    src = torch.arange(32, dtype=torch.uint8).reshape(2, 16)
    out = torch.empty((2, 16), dtype=torch.int8)
    assert ops.vta_stage(src, table, out) is out
    assert out.tolist() == [list(range(15, -1, -1)),
                            list(range(31, 15, -1))]
    assert (ops.stage_launches, ops.launches) == (0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        vta_stage.vta_stage(src, table, out)


def test_operand_checks_take_a_region_of_the_rows_read():
    """A RES or INP region written inside the stack rows the gather reads
    (batches of 3 and of 1, whose lone rows' strides need not agree) is
    taken; one over the bytes the table reads, a wrong type or a table
    of another length is refused."""
    table = vta_stage.make_table(torch.arange(64, 80), elem=4, rows=1)
    for batch in (3, 1):
        stack = torch.zeros((batch, 256), dtype=torch.uint8)
        out = stack[:, 128:192].view(torch.int32)
        assert vta_stage.check_operands(stack, table, out) == (256, 256 if
                                                              batch > 1
                                                              else 64)
        with pytest.raises(ValueError, match="region"):
            vta_stage.check_operands(stack, table,
                                     stack[:, 64:128].view(torch.int32))
    stack = torch.zeros((3, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="destinations"):
        vta_stage.check_operands(stack, table, stack[:, 128:144])
    with pytest.raises(ValueError, match="entries"):
        vta_stage.check_operands(stack, table,
                                 stack[:, 128:256].view(torch.int32))
    with pytest.raises(ValueError, match="past a row"):
        vta_stage.check_operands(stack[:, :64], table,
                                 torch.zeros((3, 16), dtype=torch.int32))
