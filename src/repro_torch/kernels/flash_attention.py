"""Build, load and launch the hand-written ``flash_attention`` CUDA kernel.

The kernel (``csrc/flash_attention.cu``) replaces the reference's Pallas
``flash_attention``; it is compiled with ``nvcc`` for ``sm_90a`` at first
use and loaded with ``ctypes``, as ``build.py`` describes.  Its plain torch
version is ``ref.attention_ref``; ``ops.attention`` picks between them by
the tensors' device.

Nothing here runs at import time: the CPU tests import this module on a
host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.core.errors import CompileError

from . import build as _build
from .build import KernelBuildError, KernelLaunchError  # noqa: F401

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
_GRID_LIMIT = 65535                 # gridDim.y (heads) and gridDim.z (batch)
_POSITION_LIMIT = 1 << 62           # |window|, |q_offset|: no int64 overflow

KERNEL = _build.Kernel(SOURCE, "flash_attention_launch",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong] * 2 + [ctypes.c_float]
                       + [ctypes.c_void_p])
build = KERNEL.build
library_path = KERNEL.library_path


def __getattr__(name: str):
    if name == "build_log":     # nvcc's report of the last build
        return KERNEL.build_log
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def check_inputs(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """What the kernel takes, checked before any launch; returns
    ``(B, H, Hkv, Sq, Skv, D)``.  Raises ``ValueError`` (``CompileError``
    ``kernel-gqa-heads`` when H is not a multiple of Hkv)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"q, k and v must all be float32 or all "
                             f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} needs k and v of shape "
                         f"({b}, Hkv, Skv, {d}); got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(b, h, hkv, sq) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if h % hkv:
        raise CompileError(
            f"{h} query heads do not group over {hkv} KV heads",
            constraint="kernel-gqa-heads")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes "
                         f"{SUPPORTED_HEAD_DIMS}")
    if max(b, h) > _GRID_LIMIT:
        raise ValueError(f"batch {b} or heads {h} exceed the grid limit "
                         f"{_GRID_LIMIT}")
    if max(sq, skv) >= 2 ** 31:
        raise ValueError(f"sequence lengths {(sq, skv)} exceed the kernel's "
                         f"int extents")
    return b, h, hkv, sq, skv, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: attention of ``q`` (B, H, Sq, D)
    over ``k``/``v`` (B, Hkv, Skv, D), output in q's dtype.

    Ragged Sq and Skv need no padding.  Launches on the current stream and
    does not synchronise."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA tensors, got "
                         f"{q.device}")
    b, h, hkv, sq, skv, d = check_inputs(q, k, v)
    if sm_scale is None:
        sm_scale = d ** -0.5
    for name, val in (("window", window or 0), ("q_offset", q_offset)):
        if abs(int(val)) >= _POSITION_LIMIT:
            raise ValueError(f"{name}={val} is out of range")
    out = torch.empty_like(q)
    fn = KERNEL.launcher()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, sq, skv, d, int(q.dtype == torch.bfloat16),
            int(causal), int(window is not None), int(window or 0),
            int(q_offset), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if q.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:                       # launch from the operands' device context
        with torch.cuda.device(q.device):
            err = fn(*args)
    if err != 0:
        raise KernelLaunchError(
            f"flash_attention launch failed: cudaError {err} at "
            f"(B, H, Hkv, Sq, Skv, D) = {(b, h, hkv, sq, skv, d)}, "
            f"{q.dtype}")
    return out
