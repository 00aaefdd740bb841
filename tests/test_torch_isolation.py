"""The port stands alone: no ``jax``, no ``repro``, and no silent CPU.

* an AST scan of every module under ``src/repro_torch/`` (and of
  ``chip_smoke.py``) finds no import of ``jax`` or ``repro``, at module
  level or inside a function;
* a subprocess with ``jax`` and ``repro`` blocked in ``sys.modules``
  compiles and serves LeNet-5, and resnet8 through the graph front end,
  on ``device="cpu"``;
* with no CUDA card, entry points called without a device raise
  :class:`~repro_torch.device.NoDeviceError` before any work runs.
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
from repro_torch.resnet8_e2e import request_images as resnet8_images
from repro_torch.models.resnet8 import (compile_resnet8,
                                        reference_forward_int8 as r8_ref)
r8, graph = compile_resnet8()
r8_imgs = resnet8_images(2)
r8_out, _ = r8.serve(r8_imgs, device="cpu")
for img, logits in zip(r8_imgs, r8_out):
    assert np.array_equal(logits, r8_ref(graph, img))
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "repro"))
assert not loaded, loaded
print("served", len(out), net.gemm_loops(), len(r8_out), r8.gemm_loops())
"""


def test_runs_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "served 3 2942 2 53252"


def test_no_device_raises_and_runs_nothing(monkeypatch):
    """No card and no device named: a typed error, and neither the kernel
    nor its plain version runs."""
    from repro_torch import device as tdevice
    from repro_torch import lenet5_e2e
    from repro_torch.core import cuda_backend
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
        net.serve_one(images[0])
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
