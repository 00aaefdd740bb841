"""Build, load and launch the hand-written ``vta_gemm`` CUDA kernel.

The kernel (``csrc/vta_gemm.cu``) is compiled with ``nvcc`` for
``sm_90a`` at first use and loaded with ``ctypes``, as ``build.py``
describes.

Nothing here runs at import time: the CPU tests import this module on a
host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from . import build as _build
from .build import KernelBuildError, KernelLaunchError  # noqa: F401

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "vta_gemm.cu"
KERNEL = _build.Kernel(SOURCE, "vta_gemm_launch",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
build = KERNEL.build
library_path = KERNEL.library_path


def __getattr__(name: str):
    if name == "build_log":     # nvcc's report of the last build
        return KERNEL.build_log
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    fn = KERNEL.launcher()
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
