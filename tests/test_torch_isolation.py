"""The port stands alone: no ``jax``, no ``repro``, and no silent CPU.

* an AST scan of every module under ``src/repro_torch/`` (and of
  ``chip_smoke.py``) finds no import of ``jax`` or ``repro``, at module
  level or inside a function;
* a subprocess with ``jax`` and ``repro`` blocked in ``sys.modules``
  compiles and serves LeNet-5, and resnet8 through the graph front end,
  on ``device="cpu"``, serves a guarded LeNet-5 batch on the batched
  interpreter (a fault injected, detected and recovered), replays a short
  trace through the serving engine, runs the projection driver and
  trains, quantises and serves a float LeNet-5, runs the quickstart
  (``python -m repro_torch.quickstart --device cpu``), the LM server
  (``python -m repro_torch.launch.serve --arch lm100m --device cpu``)
  and the trainer (``python -m repro_torch.launch.train --arch lm100m
  --smoke --steps 2 ... --device cpu``, two steps); in another, the dry
  run's entry point (``repro_torch.launch.dryrun``, one full-width cell
  on a fake 16×16 group);
* with no CUDA card, entry points and drivers called without a device
  raise :class:`~repro_torch.device.NoDeviceError` before any work runs
  (the serving engine before any thread starts).
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            func = node.func
            name = getattr(func, "attr", getattr(func, "id", ""))
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_no_module_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    names = {str(f.relative_to(PORT)) for f in files[:-1]}
    assert {"serving/vta/engine.py", "serving/vta/simulate.py",
            "serve_vta.py", "resnet_e2e.py", "cifar10_cnn_e2e.py",
            "quantize/digits.py", "quantize/train.py", "quantize/ptq.py",
            "quantize/models.py", "quantize/evaluate.py",
            "quantize_eval.py", "vta_lm_projection.py",
            "core/fast_simulator.py", "harden/__init__.py",
            "harden/faults.py", "harden/guards.py", "configs/__init__.py",
            "configs/qwen2_5_3b.py", "models/config.py", "models/params.py",
            "models/layers.py", "models/transformer.py", "serving/cache.py",
            "serving/engine.py", "launch/serve.py", "models/moe.py",
            "models/mamba.py", "models/rwkv6.py", "quickstart.py",
            "optim/adamw.py", "train/losses.py", "train/train_step.py",
            "data/pipeline.py", "checkpoint/checkpointer.py",
            "runtime/fault_tolerance.py", "launch/train.py",
            "train_lm.py", "parallel/sharding.py", "launch/mesh.py",
            "launch/specs.py", "train/distributed.py", "launch/dryrun.py",
            "analysis/op_cost.py"} <= names
    bad = [f"{path.relative_to(ROOT)}:{line} imports {name}"
           for path in files for line, name in _imports(path)
           if _forbidden(name)]
    assert not bad, bad


_BLOCKED_RUN = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
from repro_torch.lenet5_e2e import compile_lenet5, request_images
from repro_torch.models.lenet import reference_forward_int8
weights, net = compile_lenet5()
images = request_images(3)
out, _ = net.serve(images, device="cpu")
shifts = [l.requant_shift for l in net.layers]
for img, logits in zip(images, out):
    want, _ = reference_forward_int8(weights, img, shifts)
    assert np.array_equal(logits, want)
from repro_torch.harden import FaultInjector, GuardPolicy
guarded, _, greps = net.serve(images, backend="batched", device="cpu",
                              guard=GuardPolicy(dual_execute=True))
assert np.array_equal(guarded, out)
assert [r.outcome for r in greps] == ["clean"] * 3
FaultInjector(seed=1).inject(net, "dram-wgt")
guarded, _, greps = net.serve(images, backend="batched", device="cpu",
                              guard=GuardPolicy())
assert np.array_equal(guarded, out)
assert [r.outcome for r in greps] == ["recovered"] * 3
from repro_torch.resnet8_e2e import request_images as resnet8_images
from repro_torch.models.resnet8 import (compile_resnet8,
                                        reference_forward_int8 as r8_ref)
r8, graph = compile_resnet8()
r8_imgs = resnet8_images(2)
r8_out, _ = r8.serve(r8_imgs, device="cpu")
for img, logits in zip(r8_imgs, r8_out):
    assert np.array_equal(logits, r8_ref(graph, img))
from repro_torch.serving.vta import (BatchPolicy, PoissonSource,
                                     ServiceModel, VTAServingEngine,
                                     serve_all, simulate)
with VTAServingEngine(net, policy=BatchPolicy(max_batch=4, max_wait_s=0.002),
                      backends=("cuda", "cuda"), device="cpu") as engine:
    served, _ = serve_all(engine, list(images) * 3)
assert np.array_equal(served, np.concatenate([out] * 3))
assert engine.metrics.audit() == []
sim = simulate(PoissonSource(400.0, 9, seed=1, images=list(images)),
               BatchPolicy(max_batch=4), ServiceModel(0.004, 0.001),
               workers=2, net=net, device="cpu")
assert len(sim.records) == 9 and sim.metrics.audit() == []
import contextlib, io
from repro_torch import vta_lm_projection
from repro_torch.quantize import (digit_dataset, float_model, int8_top1,
                                  quantize_network, train_float)
with contextlib.redirect_stdout(io.StringIO()) as said:
    assert vta_lm_projection.main(["--device", "cpu"]) == 0
assert "(bit-exact)" in said.getvalue()
from repro_torch import quickstart
with contextlib.redirect_stdout(io.StringIO()) as said:
    assert quickstart.main(["--device", "cpu"]) == 0
assert said.getvalue().rstrip().endswith("bit-exact ✓"), said.getvalue()
x, y = digit_dataset(64, seed=0)
params = train_float("lenet5", x, y, epochs=1, device="cpu")
qm = quantize_network(float_model("lenet5", params), x[:4], margin=0)
acc = int8_top1(qm.compile(), x[:16], y[:16], batch=8, device="cpu")
import runpy
argv = sys.argv
sys.argv = ["serve", "--arch", "lm100m", "--device", "cpu"]
try:
    with contextlib.redirect_stdout(io.StringIO()) as said:
        try:
            runpy.run_module("repro_torch.launch.serve", run_name="__main__")
        except SystemExit as done:
            assert done.code == 0, done.code
finally:
    sys.argv = argv
assert said.getvalue().startswith("served 6 requests, 96 tokens"), said.getvalue()
from repro_torch.launch import train as launch_train
with contextlib.redirect_stdout(io.StringIO()) as said:
    assert launch_train.main(["--arch", "lm100m", "--smoke", "--steps", "2",
                              "--global-batch", "2", "--seq-len", "32",
                              "--device", "cpu"]) == 0
trained = said.getvalue().splitlines()[-1]
assert trained.startswith("done: 2 steps"), said.getvalue()
with contextlib.redirect_stdout(io.StringIO()) as said:
    assert launch_train.main(["--arch", "lm100m", "--smoke", "--steps", "2",
                              "--global-batch", "2", "--seq-len", "32",
                              "--device", "cpu", "--mesh-shape", "1x1"]) == 0
assert said.getvalue().splitlines()[-1].startswith("done: 2 steps"), \
    said.getvalue()
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.parallel.sharding import SINGLE_POD
_, abs_p, p_specs = specs.param_pack(get_config("qwen2.5-3b"), SINGLE_POD)
assert specs.sharded_arg_bytes(abs_p, p_specs, SINGLE_POD) == 26_852_608
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "repro"))
assert not loaded, loaded
print("served", len(out), net.gemm_loops(), len(r8_out), r8.gemm_loops(),
      len(served), 0.0 <= acc <= 1.0, "restarts=0" in trained)
"""


_BLOCKED_DRYRUN = """
import contextlib, io, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.launch import dryrun
with contextlib.redirect_stdout(io.StringIO()) as said:
    code = dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                        "--out", sys.argv[1]])
assert code == 0, said.getvalue()
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "repro"))
assert not loaded, loaded
print(said.getvalue().split(":")[0])
"""


def test_dryrun_runs_with_jax_and_repro_blocked(tmp_path):
    """The dry run's entry point at full width on 16×16 (a fake process
    group of 256 ranks, every tensor on ``meta``) with ``jax`` and
    ``repro`` blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_DRYRUN,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "OK  qwen2.5-3b_decode_32k_16x16"


def test_runs_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "served 3 2942 2 53252 9 True True"


def test_no_device_raises_and_runs_nothing(monkeypatch):
    """No card and no device named: a typed error, and neither the kernel
    nor its plain version runs."""
    from repro_torch import device as tdevice
    from repro_torch import lenet5_e2e
    from repro_torch.core import cuda_backend
    from repro_torch.core.fast_simulator import FastSimulator
    from repro_torch.harden import GuardPolicy
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    real_ref = tref.vta_gemm_ref
    monkeypatch.setattr(tref, "vta_gemm_ref",
                        lambda *a, **kw: calls.append(1) or real_ref(*a,
                                                                     **kw))
    weights, net = lenet5_e2e.compile_lenet5()
    images = lenet5_e2e.request_images(2)
    before = tops.launches
    with pytest.raises(tdevice.NoDeviceError):
        tdevice.resolve_device()
    with pytest.raises(tdevice.NoDeviceError):
        net.serve(images)
    with pytest.raises(tdevice.NoDeviceError):
        net.serve(images, backend="batched")
    with pytest.raises(tdevice.NoDeviceError):
        net.serve(images, backend="batched", guard=GuardPolicy())
    with pytest.raises(tdevice.NoDeviceError):
        net.serve_one(images[0])
    for backend in ("fast", "oracle"):
        with pytest.raises(tdevice.NoDeviceError):
            net.serve_one(images[0], backend=backend)
    with pytest.raises(tdevice.NoDeviceError):
        FastSimulator(net.config, net.dram_image())
    with pytest.raises(tdevice.NoDeviceError):
        net.run_functional()
    with pytest.raises(tdevice.NoDeviceError):
        cuda_backend.CudaSimulator(net.config, net.dram_image())
    monkeypatch.setattr(sys, "argv", ["lenet5_e2e", "--requests", "2"])
    with pytest.raises(tdevice.NoDeviceError):
        lenet5_e2e.main()
    assert calls == [] and tops.launches == before
    assert not net._device_images           # nothing was staged anywhere
    # naming the CPU is the one way onto it
    out, _ = net.serve(images, device="cpu")
    assert calls and out.shape == (2, 1, 10)


def test_engine_without_card_raises_before_any_thread(monkeypatch):
    """No card and no device named: the engine, the calibration and a
    simulation that executes batches raise :class:`NoDeviceError`, and no
    worker thread starts."""
    import threading

    from repro_torch import device as tdevice
    from repro_torch.lenet5_e2e import compile_lenet5
    from repro_torch.serving import vta

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, net = compile_lenet5()
    threads = threading.active_count()
    with pytest.raises(tdevice.NoDeviceError):
        vta.VTAServingEngine(net, backends=("cuda", "cuda"))
    with pytest.raises(tdevice.NoDeviceError):
        vta.calibrate_service_model(net, batch=2, repeats=1)
    with pytest.raises(tdevice.NoDeviceError):
        vta.simulate(vta.PoissonSource(100.0, 2, seed=0,
                                       images=vta.request_images(net, 2, 0)),
                     vta.BatchPolicy(), vta.ServiceModel(0.001, 0.0),
                     net=net)
    assert threading.active_count() == threads
    assert not net._device_images


DRIVER_ARGS = {
    "serve_vta": ["--requests", "2"], "resnet_e2e": ["--requests", "2"],
    "cifar10_cnn_e2e": ["--requests", "2"],
    "quantize_eval": ["--net", "lenet5", "--train-n", "64"],
    "vta_lm_projection": [], "launch.serve": ["--arch", "lm100m"],
    "quickstart": [],
    "launch.train": ["--arch", "lm100m", "--smoke", "--steps", "2"],
    "train_lm": ["--steps", "2"]}


@pytest.mark.parametrize("module", list(DRIVER_ARGS))
def test_drivers_without_card_raise(monkeypatch, module):
    """The drivers run on the card unless ``--device`` names another, and
    with no card they raise before any work: no image drawn, nothing
    compiled, no GEMM run."""
    import importlib

    from repro_torch import device as tdevice
    from repro_torch.core import gemm_compiler
    from repro_torch.kernels import ref as tref
    from repro_torch.quantize import digits

    driver = importlib.import_module(f"repro_torch.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [module, *DRIVER_ARGS[module]])
    work = []
    for mod, name in ((digits, "digit_image"), (tref, "vta_gemm_ref"),
                      (gemm_compiler, "compile_matmul")):
        monkeypatch.setattr(mod, name, lambda *a, **kw: work.append(name))
    monkeypatch.setattr(driver, "compile_matmul",
                        lambda *a, **kw: work.append("compile_matmul"),
                        raising=False)
    with pytest.raises(tdevice.NoDeviceError):
        driver.main()
    assert work == []


def test_front_door_without_card_raises(monkeypatch):
    """No card and no device named: the float front door, the accuracy
    harness, the CIFAR CNN's float forward and the simulator's cuda
    backend raise :class:`NoDeviceError` before any work."""
    from repro_torch import device as tdevice
    from repro_torch import quantize as tq
    from repro_torch.core.simulator import run_program
    from repro_torch.lenet5_e2e import compile_lenet5
    from repro_torch.models import cifar_cnn
    from repro_torch.quantize import digits

    _, net = compile_lenet5()
    x, y = tq.digit_dataset(4)
    params = tq.init_params("lenet5")
    weights = cifar_cnn.cifar_cnn_random_weights()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    drawn = []
    monkeypatch.setattr(digits, "digit_image",
                        lambda *a, **kw: drawn.append(a))
    for call in (
            lambda: tq.evaluate_net("lenet5", train_n=64, eval_n=8),
            lambda: tq.train_or_load("lenet5", train_n=64),
            lambda: tq.train_float("lenet5", x, y, epochs=1),
            lambda: tq.float_top1("lenet5", params, x, y),
            lambda: tq.float_net("lenet5", params),
            lambda: tq.int8_top1(net, x, y),
            lambda: tq.backend_agreement(net, x),
            lambda: cifar_cnn.reference_forward_float(
                weights, cifar_cnn.synthetic_cifar_image()),
            lambda: run_program(net.layers[0].program, backend="cuda")):
        with pytest.raises(tdevice.NoDeviceError):
            call()
    assert drawn == [] and not net._device_images


def test_lm_server_without_card_raises(monkeypatch):
    """No card and no device named: the LM server, its ``main``, the
    parameter and cache builders raise :class:`NoDeviceError` before any
    prefill or decode runs."""
    from repro_torch import device as tdevice
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import model_defs
    from repro_torch.serving import cache

    cfg = get_smoke("lm100m")
    params = init_params(model_defs(cfg), seed=0, dtype=torch.float32,
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = []
    for name in ("prefill", "decode_step", "init_params", "init_cache"):
        monkeypatch.setattr(serve, name,
                            lambda *a, name=name, **kw: work.append(name))
    with pytest.raises(tdevice.NoDeviceError):
        serve.Server(cfg, params)
    with pytest.raises(tdevice.NoDeviceError):
        serve.main(["--arch", "lm100m"])
    with pytest.raises(tdevice.NoDeviceError):
        init_params(model_defs(cfg), seed=0)
    with pytest.raises(tdevice.NoDeviceError):
        cache.init_cache(cfg, 2, 16)
    assert work == []


def test_trainer_without_card_raises(monkeypatch):
    """No card and no device named: the trainer, its parts and both
    training drivers raise :class:`NoDeviceError` before any parameter is
    drawn or any batch built."""
    from repro_torch import device as tdevice
    from repro_torch import train_lm
    from repro_torch.configs import get_smoke
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw

    cfg = get_smoke("lm100m")
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = []
    for mod, name in ((launch_train, "init_params"),
                      (launch_train, "make_batch"),
                      (pipeline, "host_batch")):
        monkeypatch.setattr(mod, name,
                            lambda *a, name=name, **kw: work.append(name))
    for call in (
            lambda: launch_train.train(cfg, steps=1, global_batch=2,
                                       seq_len=8),
            lambda: launch_train.build_trainer(
                cfg, launch_train.default_train_config("lm100m", 2, 1),
                dcfg),
            lambda: pipeline.make_batch(dcfg, 0),
            lambda: adamw.state_from_numpy((0, {}, {})),
            lambda: launch_train.main(["--smoke", "--steps", "1"]),
            lambda: launch_train.main(["--smoke", "--steps", "1",
                                       "--mesh-shape", "1x1"]),
            lambda: launch_mesh.init_distributed(),
            lambda: train_lm.main(["--steps", "1"])):
        with pytest.raises(tdevice.NoDeviceError):
            call()
    assert work == []
    assert not torch.distributed.is_initialized()
