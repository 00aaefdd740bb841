"""The ``cuda`` backend's serve without a copy of the compiled image in
every row of the DRAM stack, on the CPU.

``NetworkProgram.serve(backend="cuda")`` allocates its stack and reads the
kernel's weights, the fused bias and the ACC preload from the one compiled
image (``LayerConsts``, built once per image and device).  Here, over
resnet8, LeNet-5 and the small ResNet-50, at batches of 1 and 3: a stack
filled with a poison byte before the chain still serves bit for bit what
the batched interpreter and the model's integer reference give (nothing
reads a byte staging, the kernels or the encode did not write); the
constants are built once and rebuilt when a segment is replaced; and the
paths that keep the whole image in every row still do: the batched
interpreter reads each row's WGT, and ``BatchCudaSimulator`` gives each
row of a stack whose rows hold different weights and biases its own
answer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.network_compiler as tnc                  # noqa: E402
from repro_torch import tracing                                 # noqa: E402
from repro_torch.core import cuda_backend as cb                  # noqa: E402
from repro_torch.core.simulator import make_simulator, run_instructions  # noqa
from repro_torch.graph import evaluate_graph                    # noqa: E402
from repro_torch.lenet5_e2e import compile_lenet5, request_images  # noqa: E402
from repro_torch.models import lenet                            # noqa: E402
from repro_torch.models import resnet50 as r50                  # noqa: E402
from repro_torch.models import resnet8 as t8                    # noqa: E402

MODELS = ["resnet8", "lenet5", "resnet50_small"]
POISON = 0xA5
SMALL = r50.ResNet50Shape(input_hw=96, stem_width=8, widths=(8, 16, 32, 64))


@pytest.fixture(scope="module")
def nets():
    """model -> (net, 3 images, the integer reference of one image)."""
    out = {}
    net, graph = t8.compile_resnet8()
    out["resnet8"] = (net, np.stack([t8.synthetic_image(600 + s)
                                     for s in range(3)]),
                      lambda img: t8.reference_forward_int8(graph, img))
    weights, net5 = compile_lenet5()
    shifts = [l.spec.requant_shift for l in net5.layers]
    out["lenet5"] = (net5, request_images(3, seed=61),
                     lambda img: lenet.reference_forward_int8(
                         weights, img, shifts)[0])
    w50 = r50.resnet50_random_weights(SMALL, seed=5)
    calib = [r50.synthetic_image(s, SMALL) for s in range(1, 5)]
    net50, g50 = r50.compile_resnet50(w50, calib, r50.synthetic_image(0, SMALL),
                                      shape=SMALL)
    out["resnet50_small"] = (
        net50, np.stack([r50.synthetic_image(700 + s, SMALL)[0]
                         for s in range(3)]),
        lambda img: evaluate_graph(g50, img[None])[g50.outputs[0]].astype(
            np.int8))
    return out


def _region(prog, name):
    r = prog.regions[name]
    lo = r.phys_addr - prog.allocator.offset
    return slice(lo, lo + r.nbytes)


def _poisoned(monkeypatch, regions=None):
    """Make ``_run_chain`` write the poison byte over its stack (over the
    named regions of every layer, or all of it) before the chain runs;
    returns the list of the stacks' shapes it poisoned."""
    real = tnc.NetworkProgram._run_chain
    seen = []

    def run_chain(self, stack, first, execute, **kw):
        if regions is None:
            stack.fill_(POISON)
        else:
            for layer in self.layers:
                for name in regions:
                    stack[:, _region(layer.program, name)] = POISON
        seen.append(tuple(stack.shape))
        return real(self, stack, first, execute, **kw)

    monkeypatch.setattr(tnc.NetworkProgram, "_run_chain", run_chain)
    return seen


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("model", MODELS)
def test_cuda_serve_reads_no_byte_it_did_not_write(nets, model, batch,
                                                   monkeypatch):
    net, images, reference = nets[model]
    images = images[:batch]
    want, _ = net.serve(images, backend="batched", device="cpu")
    seen = _poisoned(monkeypatch)
    got, reports = net.serve(images, backend="cuda", device="cpu")
    assert seen == [(batch, net.allocator.image_size())]
    np.testing.assert_array_equal(got, want)
    for img, row in zip(images, got):
        np.testing.assert_array_equal(row.reshape(-1),
                                      reference(img).reshape(-1))
    assert [r.gemm_loops for r in reports] == [
        batch * g for g in net.gemm_loops_per_layer()]


@pytest.mark.parametrize("model", MODELS)
def test_interpreters_read_the_image_in_every_row(nets, model, monkeypatch):
    """The batched interpreter's stack is the image in every row, and its
    instructions load WGT from it: poisoning the rows' WGT changes its
    answer, and not the cuda backend's."""
    net, images, _ = nets[model]
    want, _ = net.serve(images, backend="batched", device="cpu")
    tracing.clear()
    with torch.profiler.profile():
        net.serve(images[:2], backend="batched", device="cpu")
    stack_bytes = [s["attrs"]["bytes"] for s in tracing.snapshot()["spans"]
                   if s["name"] == "repro_torch.serve.stack"]
    assert stack_bytes == [2 * net.allocator.image_size()]
    _poisoned(monkeypatch, regions=("wgt",))
    broken, _ = net.serve(images, backend="batched", device="cpu")
    assert not np.array_equal(broken, want)
    got, _ = net.serve(images, backend="cuda", device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", MODELS)
def test_constants_are_built_once_and_rebuilt_with_a_segment(nets, model,
                                                             monkeypatch):
    net, images, _ = nets[model]
    built = []
    real = tnc.layer_consts
    monkeypatch.setattr(tnc, "layer_consts",
                        lambda *a: built.append(a[0].name) or real(*a))
    net._device_images.clear()
    consts = net.layer_consts("cpu")
    assert net.layer_consts("cpu") is consts
    for _ in range(2):
        net.serve(images, device="cpu")
    assert net.layer_consts("cpu") is consts
    assert built == [l.program.name for l in net.layers]
    image = net._device_image(torch.device("cpu")).reshape(1, -1)
    for layer, c in zip(net.layers, consts):
        p = cb.plan_cuda(layer.program)
        assert c.image.data_ptr() == image.data_ptr()
        assert torch.equal(c.w, cb._decode_wgt(image, p)[0])
        assert c.w.is_contiguous()
        if p.acc and c.fused:
            assert torch.equal(c.bias, cb._decode_acc32(image, p, p.acc)[0, 0])
        else:
            assert c.bias is None

    # new weights in one layer: a new image, every constant rebuilt, and
    # the cuda serve still equals the interpreter's over the new image
    layer = next(l for l in net.layers if "acc" in l.program.segments)
    prog = layer.program
    original = dict(prog.segments)
    try:
        wgt = np.frombuffer(original["wgt"], dtype=np.int8)
        prog.segments["wgt"] = (-np.maximum(wgt, -127)).astype(
            np.int8).tobytes()
        want, _ = net.serve(images, backend="batched", device="cpu")
        got, _ = net.serve(images, backend="cuda", device="cpu")
        np.testing.assert_array_equal(got, want)
        rebuilt = net.layer_consts("cpu")
        assert rebuilt is not consts
        assert len(built) == 2 * len(net.layers)
        k = net.layers.index(layer)
        assert not torch.equal(rebuilt[k].w, consts[k].w)
    finally:
        prog.segments.clear()
        prog.segments.update(original)
    net.serve(images[:1], device="cpu")
    assert len(built) == 3 * len(net.layers)


def _picked(net):
    """The first layer that fuses a bias, the first that runs the TensorAlu
    epilogue, and the first that joins a residual."""
    plans = [cb.plan_cuda(l.program) for l in net.layers]
    picks = {}
    for layer, p, c in zip(net.layers, plans, net.layer_consts("cpu")):
        kind = ("res" if p.res else "fused" if c.fused and p.acc
                else "epilogue" if not p.fused else None)
        if kind is not None:
            picks.setdefault(kind, layer.program)
    return list(picks.values())


@pytest.mark.parametrize("model", MODELS)
def test_simulator_rows_keep_their_own_weights_and_bias(nets, model):
    """A ``BatchCudaSimulator`` stack of three rows over one seeded
    input, the second row with its weights negated and the third with a
    seeded amount added to every ACC word: each row's OUT equals the fast
    interpreter's over that row alone."""
    net, _, _ = nets[model]
    rng = np.random.default_rng(34)
    for prog in _picked(net):
        p = cb.plan_cuda(prog)
        image = prog.dram_image()
        inp = _region(prog, "inp")
        image[inp] = rng.integers(-64, 64, inp.stop - inp.start).astype(
            np.int8).view(np.uint8)
        stack = np.stack([image] * 3)
        wgt = stack[1, _region(prog, "wgt")].view(np.int8)
        wgt[:] = -np.maximum(wgt, -127)
        if p.acc:
            acc = stack[2, _region(prog, "acc")].view(np.int32)
            acc += rng.integers(-2 ** 14, 2 ** 14, acc.shape, dtype=np.int32)
        sim = cb.BatchCudaSimulator(prog.config, stack, device="cpu")
        sim.run_program(prog)
        got = sim.dram.numpy()
        out = _region(prog, "out")
        for i in range(3):
            fast = make_simulator(prog.config, stack[i], backend="fast",
                                  device="cpu")
            run_instructions(fast, prog.instructions, program=prog)
            want = np.asarray(torch.as_tensor(fast.dram).cpu())
            np.testing.assert_array_equal(got[i, out], want[out],
                                          err_msg=f"{prog.name} row {i}")
        assert not np.array_equal(got[0, out], got[1, out]), prog.name
        if p.acc:
            assert not np.array_equal(got[0, out], got[2, out]), prog.name
