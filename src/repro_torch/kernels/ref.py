"""Plain torch versions of the port's kernels (the kernel test contracts).

They run on the CPU and on CUDA.  ``vta_gemm_ref`` is exact on both, which
rules out the obvious spellings: on this torch ``int8 @ int8`` returns int8 and
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


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Plain version of ``kernels/csrc/flash_attention.cu``: float32
    softmax attention of ``q`` (B, H, Sq, D) over ``k``/``v``
    (B, Hkv, Skv, D), query head h reading KV head ``h // (H // Hkv)``.

    Keeps the keys with ``q_pos >= k_pos`` (causal) and
    ``q_pos - k_pos < window``, where ``q_pos = q_offset + i``; a row that
    keeps no key returns 0.  Output in q's dtype.  On CUDA the float32
    products run in full float32: ``torch.backends.cuda.matmul.allow_tf32``
    is set to False for the call and restored after it (TF32 keeps about
    three decimal digits, too few for the kernel's 2e-5 tolerance)."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _attention_f32(q, k, v, causal, sm_scale, window, q_offset)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def attention_mask(sq: int, skv: int, causal: bool, window: Optional[int],
                   q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool, True where query i keeps key j."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def _attention_f32(q, k, v, causal, sm_scale, window, q_offset):
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = h // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    # repeat_interleave over heads, spelt as expand + reshape (no host sync,
    # so the plain version can be captured in a CUDA graph for timing)
    k = k[:, :, None].expand(b, hkv, group, skv, d).reshape(b, h, skv, d)
    v = v[:, :, None].expand(b, hkv, group, skv, d).reshape(b, h, skv, d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    mask = attention_mask(sq, skv, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    # rows with every position masked: softmax gives uniform; zero them
    out = out.masked_fill(~mask.any(dim=-1)[:, None], 0.0)
    return out.to(q.dtype)
