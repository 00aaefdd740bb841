"""The TensorAlu epilogue kernel (``vta_alu``) on a card.

The kernel is held to its plain version (``cuda_backend.plain_alu_epilogue``
and ``_encode_out``, run on the card too) by exact equality of the whole
DRAM stack it leaves: OUT written, everything else untouched.  Over every
program of ``torch_alu_cases``, full-range int32 inputs, both commits,
batches of 1 and 4,096 images of 16 and of 18 vectors; images 16-byte
aligned and not (the kernel's 4-lane and 1-lane loads); and images too
large for shared memory (the pair and indexed programs then work in the
GEMM's result).  The ACC preload is read from one image (``acc_image``),
as ``serve`` reads it from the compiled image: the stack's first row, or
an image of its own whose ACC differs from every row's, over the same
programs, and over LeNet-5's pooled convs with their compiled image.
Then served networks: LeNet-5, resnet8, the CIFAR CNN and resnet_tiny,
``serve`` on the card bit-equal to ``serve`` on the CPU with one
``vta_alu`` launch an unfused layer; under the profiler every device
operation of an unfused layer's epilogue is the kernel (no int64 pass),
its encode launches nothing, the stack is made without a device operation,
nothing decodes INP and every layer's stage launches only ``vta_stage``.

Every test here is marked ``cuda``: it decides inside the test whether a
CUDA card is present and skips on a host without one.  The module imports
no ``jax``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_alu_epilogue_card.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.gemm_compiler as tgc                     # noqa: E402
import repro_torch.core.isa as tisa                              # noqa: E402
from repro_torch import tracing                                 # noqa: E402
from repro_torch.core import cuda_backend as cb                  # noqa: E402
from repro_torch.kernels import ops                              # noqa: E402
from torch_alu_cases import alu_cases, alu_ops                   # noqa: E402

CASES = alu_cases()
STRUCTURAL = [i for i, (_, spec) in enumerate(CASES)
              if any(kind in ("idx", "pair") for kind, *_ in spec)]
# (alpha, beta, row_height): 16 and 18 vectors of 16 lanes an image; 4,096
# vectors (256 KB of int32) do not fit a block's shared memory
BLOCKS = {"16_vectors": (2, 1, 8), "18_vectors": (3, 2, 3),
          "4096_vectors": (32, 8, 16)}
EPILOGUE = "repro_torch.layer.epilogue"
ENCODE = "repro_torch.layer.encode"


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _case(dev, case: int, blocks, batch: int, aligned: bool, seed: int):
    """(plan, GEMM result, stack) with full-range int32 result, ACC and
    RES: ACC, RES and OUT follow each other in an image, from byte 16 (or
    4, with a row stride that is not a multiple of 16 either)."""
    alpha, beta, rh = blocks
    n = alpha * beta * rh * 16
    first = 16 if aligned else 4
    acc, res, out = first, first + 4 * n, first + 8 * n
    stride = -(-(out + n) // 16) * 16 + (0 if aligned else 4)
    p = cb.CudaPlan(alpha=alpha, lam=1, beta=beta, row_height=rh,
                    block_size=16, valid_shape=(alpha * rh, beta * 16),
                    alu_ops=tuple(alu_ops(tgc, tisa, CASES[case][1])),
                    fused=False, relu=False, shift=0, inp=(0, 0), wgt=(0, 0),
                    out=(out, n), acc=(acc, 4 * n), res=(res, 4 * n))
    rng = np.random.default_rng(seed)
    gemm = rng.integers(-(2 ** 31), 2 ** 31, (batch, alpha * rh, beta * 16),
                        dtype=np.int64).astype(np.int32)
    stack = rng.integers(0, 256, (batch, stride), dtype=np.uint8)
    return (p, torch.from_numpy(gemm).to(dev),
            torch.from_numpy(stack).to(dev))


def _plain(p, gemm, stack, saturate: bool, acc_image) -> torch.Tensor:
    """The plain epilogue's stack; ACC from ``acc_image`` (one image,
    expanded over the batch)."""
    want = stack.clone()
    x = cb._decode_acc32(acc_image, p, p.acc).expand(stack.shape[0], -1, -1)
    res = cb._decode_acc32(stack, p, p.res) if p.res else None
    out = cb.plain_alu_epilogue(gemm, x, res, p,
                                cb.lower_alu(p.alu_ops, stack.device),
                                saturate)
    cb._encode_out(want, p, out)
    return want


def _kernel(p, gemm, stack, saturate: bool, acc_image) -> torch.Tensor:
    got = stack.clone()
    table = cb.lower_alu_table(p.alu_ops, p.alpha * p.beta * p.row_height,
                               stack.device)
    ops.vta_alu(gemm.clone(), got, table,
                blocks=(p.alpha, p.beta, p.row_height, p.block_size),
                acc=p.acc, res=p.res, out=p.out, saturate=saturate,
                acc_image=acc_image)
    torch.cuda.synchronize()
    return got


def _assert_same(got, want, p):
    if not torch.equal(got, want):
        start, size = p.out
        wrong = (got != want).nonzero()
        outside = ((wrong[:, 1] < start) | (wrong[:, 1] >= start + size))
        raise AssertionError(
            f"{len(wrong)} bytes differ ({int(outside.sum())} outside OUT); "
            f"first at (image, byte) {wrong[0].tolist()}")


@pytest.mark.cuda
@pytest.mark.parametrize("saturate", [False, True], ids=["trunc", "sat"])
@pytest.mark.parametrize("batch", [1, 4096])
@pytest.mark.parametrize("blocks", ["16_vectors", "18_vectors"])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[name for name, _ in CASES])
def test_kernel_equals_plain(case, blocks, batch, saturate):
    dev = _card()
    p, gemm, stack = _case(dev, case, BLOCKS[blocks], batch, True,
                           4100 + case)
    _assert_same(_kernel(p, gemm, stack, saturate, stack[:1]),
                 _plain(p, gemm, stack, saturate, stack[:1]), p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[name for name, _ in CASES])
def test_kernel_equals_plain_unaligned(case):
    dev = _card()
    p, gemm, stack = _case(dev, case, BLOCKS["18_vectors"], 33, False,
                           4200 + case)
    for saturate in (False, True):
        _assert_same(_kernel(p, gemm, stack, saturate, stack[:1]),
                     _plain(p, gemm, stack, saturate, stack[:1]), p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", STRUCTURAL,
                         ids=[CASES[i][0] for i in STRUCTURAL])
def test_kernel_equals_plain_beyond_shared_memory(case):
    dev = _card()
    p, gemm, stack = _case(dev, case, BLOCKS["4096_vectors"], 6, True,
                           4300 + case)
    for saturate in (False, True):
        _assert_same(_kernel(p, gemm, stack, saturate, stack[:1]),
                     _plain(p, gemm, stack, saturate, stack[:1]), p)


# every program at 18 vectors; the structural ones past shared memory too
ONE_IMAGE = ([(i, "18_vectors") for i in range(len(CASES))]
             + [(i, "4096_vectors") for i in STRUCTURAL])


@pytest.mark.cuda
@pytest.mark.parametrize("case, blocks", ONE_IMAGE,
                         ids=[f"{CASES[i][0]}-{b}" for i, b in ONE_IMAGE])
def test_kernel_reads_acc_from_one_image(case, blocks):
    """ACC from an image of its own, not the stack's: the stack's own
    ACC bytes are random and differ from it."""
    dev = _card()
    p, gemm, stack = _case(dev, case, BLOCKS[blocks], 33, True, 4600 + case)
    image = _case(dev, case, BLOCKS[blocks], 1, True, 4700 + case)[2]
    for saturate in (False, True):
        _assert_same(_kernel(p, gemm, stack, saturate, image),
                     _plain(p, gemm, stack, saturate, image), p)


@pytest.mark.cuda
def test_pooled_convs_read_acc_from_the_compiled_image():
    """LeNet-5's pooled convs (one block an image in shared memory) with
    their bias preload read from the compiled image on the card, over 257
    images."""
    dev = _card()
    net, _ = _network("lenet5")
    image = net._device_image(dev).reshape(1, -1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(34)
    pooled = [l for l in net.layers if l.program.alu_kind == "pool2x2"]
    assert [l.spec.name for l in pooled] == ["l1_conv", "l2_conv"]
    for layer in pooled:
        p = cb.plan_cuda(layer.program)
        gemm = torch.randint(-(2 ** 31), 2 ** 31, (257, *p.padded_shape),
                             dtype=torch.int32, device=dev, generator=gen)
        stack = torch.randint(0, 256, (257, image.shape[1]),
                              dtype=torch.uint8, device=dev, generator=gen)
        for saturate in (False, True):
            _assert_same(_kernel(p, gemm, stack, saturate, image),
                         _plain(p, gemm, stack, saturate, image), p)


@pytest.mark.cuda
def test_kernel_refuses_cpu_tensors_and_overlaps():
    dev = _card()
    p, gemm, stack = _case(dev, 0, BLOCKS["16_vectors"], 2, True, 4400)
    table = cb.lower_alu_table(p.alu_ops, 16, dev)
    kw = dict(blocks=(2, 1, 8, 16), acc=p.acc, res=p.res, out=p.out,
              saturate=False, acc_image=stack[:1])
    with pytest.raises(ValueError, match="CUDA"):
        ops.vta_alu(gemm.cpu(), stack.cpu(), table, **kw)
    with pytest.raises(ValueError, match="overlaps"):
        ops.vta_alu(gemm, stack, table, **{**kw, "out": (p.acc[0], 256)})


def _network(model: str):
    """(net, 32 seeded images) of a model compiled at full width."""
    if model == "lenet5":
        from repro_torch.lenet5_e2e import compile_lenet5, request_images
        return compile_lenet5()[1], request_images(32)
    if model == "resnet8":
        from repro_torch.models import resnet8 as m
        net, image = m.compile_resnet8()[0], m.synthetic_image
    elif model == "resnet_tiny":
        from repro_torch.models import resnet_tiny as m
        net, image = m.compile_resnet_tiny()[0], m.synthetic_image
    else:
        from repro_torch.models import cifar_cnn as m
        net, image = m.compile_cifar_cnn()[2], m.synthetic_cifar_image
    return net, np.stack([image(500 + r) for r in range(32)])


def _unfused(net, dev) -> list:
    return [k for k, c in enumerate(net.layer_consts(dev)) if not c.fused]


@pytest.mark.cuda
@pytest.mark.parametrize("model, n_unfused", [
    ("lenet5", 2), ("resnet8", 4), ("cifar_cnn", 3), ("resnet_tiny", 4)])
def test_serve_on_card_equals_cpu(model, n_unfused):
    dev = _card()
    net, images = _network(model)
    want, _ = net.serve(images, device="cpu")
    net.serve(images[:2], device=dev)               # builds and warms
    assert len(_unfused(net, dev)) == n_unfused
    ops.reset_launches()
    got, _ = net.serve(images, device=dev)
    np.testing.assert_array_equal(got, want)
    assert ops.alu_launches == n_unfused
    assert ops.launches == len(net.layers)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["lenet5", "resnet8"])
def test_epilogue_is_one_kernel_and_encode_is_empty(model, tmp_path):
    """Under the profiler, an unfused layer's ``layer.epilogue`` launches
    the kernel alone (no int64 widening, no wrap passes) and its
    ``layer.encode`` launches nothing; at 2,048 images."""
    dev = _card()
    net, images = _network(model)
    images = np.concatenate([images] * 64)
    plain, _ = net.serve(images, device=dev)
    unfused = _unfused(net, dev)
    tracing.clear()
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        out, _ = net.serve(images, device=dev)
    np.testing.assert_array_equal(out, plain)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    encodes = sorted(float(e["ts"]) for e in events
                     if e.get("cat") == "user_annotation"
                     and e["name"] == ENCODE)
    assert len(encodes) == len(net.layers)
    empty = {encodes[k] for k in unfused}
    launched = tracing.attribute(events)
    epilogue = [o["name"] for o in launched if o["span"] == EPILOGUE]
    assert len(epilogue) == len(unfused)
    assert all("vta_alu" in name for name in epilogue), epilogue
    assert [o["name"] for o in launched if o["span"] == ENCODE
            and o["span_ts"] in empty] == []
    spans = [s for s in tracing.snapshot()["spans"] if s["name"] == ENCODE]
    assert [s["attrs"]["bytes"] for s in spans] == [
        len(images) * cb.plan_cuda(l.program).out[1] for l in net.layers]
    # the stack is allocated, not cloned from the image; nothing decodes
    # INP: each layer's stage is its gathers (the operand, and RES on a
    # join), which write INP's bytes and RES's
    assert [o["name"] for o in launched
            if o["span"] == "repro_torch.serve.stack"] == []
    spans = tracing.snapshot()["spans"]
    assert not [s for s in spans if s["name"] == "repro_torch.layer.decode"]
    stages = [s["attrs"]["bytes"] for s in spans
              if s["name"] == "repro_torch.layer.stage"]
    assert stages == [len(images) * (cb.plan_cuda(l.program).inp[1] + (
        cb.plan_cuda(l.program).res[1] if src is not None else 0))
        for l, src in zip(net.layers, net._res_sources())]
    staged = [o["name"] for o in launched
              if o["span"] == "repro_torch.layer.stage"]
    assert staged and all("vta_stage" in name for name in staged), staged


@pytest.mark.cuda
def test_shared_memory_launches_from_two_threads():
    """Two threads launch the image kernel at once, each in a loop, with
    images of 784 vectors (50,176 bytes of shared memory, over the 48 KB a
    launch gets without asking) and of 112 (7,168 bytes): neither thread's
    launch may lower the other's limit, and both end equal to the plain
    version."""
    import threading
    dev = _card()
    case = next(i for i in STRUCTURAL if CASES[i][0].startswith("pair"))
    runs = [_case(dev, case, blocks, 64, True, 4500 + k)
            for k, blocks in enumerate([(49, 1, 16), (7, 1, 16)])]
    torch.cuda.synchronize()
    errors, got = [], [None, None]

    def launch(k):
        p, gemm, stack = runs[k]
        table = cb.lower_alu_table(p.alu_ops,
                                   p.alpha * p.beta * p.row_height, dev)
        try:
            for _ in range(400):
                out = stack.clone()
                ops.vta_alu(gemm.clone(), out, table,
                            blocks=(p.alpha, p.beta, p.row_height,
                                    p.block_size),
                            acc=p.acc, res=p.res, out=p.out, saturate=False,
                            acc_image=stack[:1])
            torch.cuda.synchronize()
            got[k] = out
        except Exception as exc:                    # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=launch, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    for (p, gemm, stack), out in zip(runs, got):
        _assert_same(out, _plain(p, gemm, stack, False, stack[:1]), p)


@pytest.mark.cuda
def test_engine_serves_lenet5_from_two_cuda_workers():
    """LeNet-5 behind the serving engine with two ``cuda`` workers, whose
    threads launch l1_conv's and l2_conv's epilogues (50,176 and 7,168
    bytes of shared memory) at once: four rounds of 256 requests, each
    equal to the CPU's serve, two ``vta_alu`` launches a batch."""
    from repro_torch.serving import vta
    dev = _card()
    net, _ = _network("lenet5")
    images = vta.request_images(net, 256, seed=31)
    want, _ = net.serve(images, device="cpu")
    for _ in range(4):
        engine = vta.VTAServingEngine(
            net, policy=vta.BatchPolicy(max_batch=32, max_wait_s=0.002),
            backends=("cuda", "cuda"), device=dev).start()
        ops.reset_launches()
        try:
            outs, tickets = vta.serve_all(engine, images)
        finally:
            engine.shutdown()
        np.testing.assert_array_equal(outs, want)
        assert engine.metrics.audit() == [] and engine.metrics.drained()
        batches = {(t.record.worker, t.record.dispatch_t) for t in tickets}
        assert ops.alu_launches == 2 * len(batches)
        assert ops.launches == 5 * len(batches)
