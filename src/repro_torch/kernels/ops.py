"""Public wrappers around the ``vta_gemm`` and ``flash_attention`` kernels.

A CPU tensor goes to the plain torch version (``ref.vta_gemm_ref``,
``ref.attention_ref``); a CUDA tensor launches the hand-written kernel or
raises — there is no fallback from one to the other.  ``launches`` counts
kernel launches made through :func:`vta_matmul` and ``attention_launches``
the attention kernels launched (``flash_attention.launches``: the count
the C entry points report), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.errors import CompileError

from . import flash_attention as _flash
from . import ref as _ref
from . import vta_gemm as _vta_gemm

_BACKENDS = ("auto", "cuda", "torch")

launches = 0            # kernel launches made by vta_matmul


def reset_launches() -> None:
    global launches
    launches = 0
    _flash.launches = 0


def __getattr__(name: str):
    if name == "attention_launches":    # counted where the kernels launch
        return _flash.launches
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(
            f"kernel backend must be one of {_BACKENDS}, got {backend!r}")


def vta_matmul(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               relu: bool = False, shift: int = 0, saturate: bool = True,
               out_dtype: torch.dtype = torch.int8,
               backend: str = "auto") -> torch.Tensor:
    """Fused W8A8 GEMM ``epilogue(A @ B + bias)`` (the VTA datapath).

    backend: ``"auto"`` picks by the tensors' device, ``"cuda"`` requires
    CUDA tensors (kernel), ``"torch"`` requires CPU tensors (plain)."""
    global launches
    _check_backend(backend)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise CompileError(
            f"incompatible GEMM operand shapes {tuple(a.shape)} @ "
            f"{tuple(b.shape)}", constraint="kernel-gemm-shape")
    if a.device.type == "cpu":
        if backend == "cuda":
            raise ValueError("backend='cuda' launches the kernel and needs "
                             "CUDA tensors; got CPU tensors")
        return _ref.vta_gemm_ref(a, b, bias, relu=relu, shift=shift,
                                 saturate=saturate, out_dtype=out_dtype)
    if backend == "torch":
        raise ValueError("backend='torch' is the plain version for CPU "
                         f"tensors; got {a.device} (call "
                         f"ref.vta_gemm_ref directly to compare on the card)")
    out = _vta_gemm.vta_gemm(a, b, bias, relu=relu, shift=shift,
                             saturate=saturate, out_dtype=out_dtype)
    launches += 1
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: Optional[float] = None,
              window: Optional[int] = None, q_offset: int = 0,
              backend: str = "auto") -> torch.Tensor:
    """Flash attention with GQA: ``q`` (B, H, Sq, D), ``k``/``v``
    (B, Hkv, Skv, D) with H % Hkv == 0; output (B, H, Sq, D) in q's dtype.
    On CUDA tensors the path is ``flash_attention.plan``'s: float32 on
    split-TF32 ``mma.sync`` tensor-core products, bfloat16 on the ``wgmma``
    tiles or the split-KV decode path; ``attention_launches`` rises by every kernel the call launches
    (2 where a combine kernel follows a split), as the library reports.

    ``q_offset`` is the absolute position of ``q[..., 0, :]`` (chunked
    prefill, decode); ``window`` keeps keys with ``q_pos - k_pos <
    window``.  backend: ``"auto"`` picks by the tensors' device, ``"cuda"``
    requires CUDA tensors (kernel), ``"torch"`` requires CPU tensors
    (plain)."""
    _check_backend(backend)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"attention takes 4-D q and k, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    h, hkv = q.shape[1], k.shape[1]
    if hkv == 0 or h % hkv:
        raise CompileError(
            f"{h} query heads do not group over {hkv} KV heads",
            constraint="kernel-gqa-heads")
    if q.device.type == "cpu":
        if backend == "cuda":
            raise ValueError("backend='cuda' launches the kernel and needs "
                             "CUDA tensors; got CPU tensors")
        return _ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                  window=window, q_offset=q_offset)
    if backend == "torch":
        raise ValueError("backend='torch' is the plain version for CPU "
                         f"tensors; got {q.device} (call "
                         f"ref.attention_ref directly to compare on the card)")
    return _flash.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                  window=window, q_offset=q_offset)
