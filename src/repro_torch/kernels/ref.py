"""Plain torch versions of the port's kernels (the kernel test contracts).

They run on the CPU and on CUDA and are exact on both, which rules out
the obvious spellings: on this torch ``int8 @ int8`` returns int8 and
wraps, and CUDA has no int32 or int64 matmul.  The product is therefore
taken in float64 — every partial sum is an integer below ``K · 2**14``,
exact while that stays under ``2**53`` — and everything after it is
int64 with the int32 wrap and the int8 truncation spelt out as masks and
shifts (no out-of-range dtype casts).
"""

from __future__ import annotations

from typing import Optional

import torch

_INT32_SPAN = 1 << 32


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value congruent mod 2**32 (two's-complement wrap),
    still held in int64."""
    return ((x + (1 << 31)) & (_INT32_SPAN - 1)) - (1 << 31)


def truncate_int8(x: torch.Tensor) -> torch.Tensor:
    """The VTA's ACC→OUT commit: keep the low 8 bits as a signed byte."""
    return (((x.to(torch.int64) + 128) & 0xFF) - 128).to(torch.int8)


def vta_gemm_ref(a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 relu: bool = False, shift: int = 0, saturate: bool = True,
                 out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Plain version of ``kernels/csrc/vta_gemm.cu``: int32-wrapping
    ``A @ B + bias``, then relu, arithmetic SHR by ``shift`` and, for an
    int8 output, the commit (clip when ``saturate``, else truncation)."""
    k = a.shape[1]
    if k * (1 << 14) >= (1 << 53):
        raise ValueError(f"K={k} too deep for an exact float64 product")
    acc = (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)
    acc = wrap_int32(acc)
    if bias is not None:
        acc = wrap_int32(acc + bias.to(torch.int64)[None, :])
    if relu:
        acc = torch.clamp(acc, min=0)
    if shift:
        acc = acc >> min(shift, 31)
    if out_dtype == torch.int8:
        if saturate:
            return torch.clamp(acc, -128, 127).to(torch.int8)
        return truncate_int8(acc)
    if out_dtype != torch.int32:
        raise ValueError(f"out_dtype must be int8 or int32, got {out_dtype}")
    return acc.to(torch.int32)
