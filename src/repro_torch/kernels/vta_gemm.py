"""Build, load and launch the hand-written ``vta_gemm`` CUDA kernel.

The kernel (``csrc/vta_gemm.cu``) is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  The build happens at first use, into ``build/repro_torch/`` at
the root of the checkout, and is keyed by a hash of the source and the
flags, so a fresh checkout builds it once and an edited source rebuilds.
``nvcc`` is looked up in ``$CUDA_HOME/bin``, then on ``PATH``, then in
``/usr/local/cuda/bin``; if none has it the build raises.

Nothing here runs at import time: the CPU tests import this module on a
host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "vta_gemm.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_SYSTEM_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_fn = None
build_log = ""          # nvcc's report (ptxas registers/smem) of the last build


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused the kernel source."""


class KernelLaunchError(RuntimeError):
    """The CUDA launch was refused (non-zero ``cudaGetLastError``)."""


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(pathlib.Path(on_path))
    candidates.append(_SYSTEM_NVCC)
    for path in candidates:
        if path.is_file():
            return str(path)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin); the vta_gemm kernel cannot be built")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libvta_gemm_{digest}.so"


def build() -> pathlib.Path:
    """Compile the kernel unless a library for this source exists."""
    global build_log
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)             # atomic: concurrent builders agree
    build_log = proc.stdout + proc.stderr
    return so


def _launcher():
    global _fn
    with _lock:
        if _fn is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.vta_gemm_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fn = fn
    return _fn


def _check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                   ndim: int, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vta_gemm(a: torch.Tensor, b: torch.Tensor,
             bias: Optional[torch.Tensor] = None, *,
             relu: bool = False, shift: int = 0, saturate: bool = True,
             out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: ``epilogue(A @ B + bias)``.

    ``a`` int8 (M, K), ``b`` int8 (K, N), ``bias`` int32 (N,) or None, all
    contiguous on one CUDA device; ragged M, N and K need no padding.
    Launches on the current stream and does not synchronise."""
    if a.device.type != "cuda":
        raise ValueError(f"vta_gemm launches on CUDA tensors, got {a.device}")
    dev = a.device
    _check_operand(a, "a", torch.int8, 2, dev)
    _check_operand(b, "b", torch.int8, 2, dev)
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"a {tuple(a.shape)} @ b {tuple(b.shape)}: K differs")
    n = b.shape[1]
    if bias is not None:
        _check_operand(bias, "bias", torch.int32, 1, dev)
        if bias.shape[0] != n:
            raise ValueError(f"bias has {bias.shape[0]} entries, N is {n}")
    if out_dtype not in (torch.int8, torch.int32):
        raise ValueError(f"out_dtype must be int8 or int32, got {out_dtype}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"GEMM {(m, k, n)} exceeds the kernel's int extents")
    if shift < 0:
        raise ValueError(f"shift must be >= 0, got {shift}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _launcher()
    args = (a.data_ptr(), b.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            m, k, n, int(relu), min(shift, 31), int(saturate),
            int(out_dtype == torch.int8),
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:                       # launch from the operands' device context
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise KernelLaunchError(f"vta_gemm launch failed: cudaError {err} "
                                f"at (M, K, N) = {(m, k, n)}")
    return out
