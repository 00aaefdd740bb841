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

import math
from typing import Optional

import torch

_INT32_SPAN = 1 << 32
LOG2E = math.log2(math.e)


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
    return _epilogue(wrap_int32(acc), bias, relu, shift, saturate, out_dtype)


def _epilogue(acc, bias, relu, shift, saturate, out_dtype):
    """``vta_gemm_ref``'s tail on the wrapped int32 sum ``acc`` (int64)."""
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


def vta_stage_ref(src: torch.Tensor, index: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels/csrc/vta_stage.cu``: ``out[b, i] =
    index[i] < 0 ? 0 : src[b, index[i]]``, each source byte read as int8
    and written in ``out``'s dtype (an int32 destination sign-extends).
    ``src`` (B, bytes) uint8 or int8; returns ``out``, written in place."""
    idx = index.to(torch.int64)
    rows = src.view(torch.int8) if src.dtype == torch.uint8 else src
    vals = rows.index_select(1, idx.clamp(min=0)).masked_fill_(idx < 0, 0)
    return out.copy_(vals)


def vta_gemm_split_ref(a: torch.Tensor, b: torch.Tensor,
                       bias: Optional[torch.Tensor], plan, *,
                       relu: bool = False, shift: int = 0,
                       saturate: bool = True,
                       out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """``vta_gemm_ref`` summed as the kernel sums it under ``plan`` (a
    ``vta_gemm.GemmPlan``): each warp group's K slices
    (``plan.k_slices()``) in wrapping int32, the groups added in order onto
    the first, then the same epilogue.  Wrapping addition is associative,
    so it must equal ``vta_gemm_ref``; the tests hold the plan's slicing to
    that.  No main path calls it."""
    k = a.shape[1]
    if k * (1 << 14) >= (1 << 53):
        raise ValueError(f"K={k} too deep for an exact float64 product")
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                      device=a.device)
    for ranges in plan.k_slices():
        part = torch.zeros_like(acc)
        for lo, hi in ranges:
            step = (a64[:, lo:hi] @ b64[lo:hi]).to(torch.int64)
            part = wrap_int32(part + step)
        acc = wrap_int32(acc + part)
    return _epilogue(acc, bias, relu, shift, saturate, out_dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Plain version of ``kernels/csrc/flash_attention.cu`` (float32) and
    ``flash_attention_bf16.cu`` (bfloat16): float32 softmax attention of
    ``q`` (B, H, Sq, D) over ``k``/``v``
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


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, sm_scale: Optional[float] = None,
                      window: Optional[int] = None, q_offset: int = 0):
    """Plain version of both kernels' ``return_lse`` mode: ``(o, lse)``,
    o :func:`attention_ref`'s output in float32 (not rounded to q's dtype)
    and lse the float32 (B, H, Sq) ``logsumexp`` of each row's scaled
    scores over the keys it keeps, -inf for a row that keeps none (whose o
    is 0).  A rank of a
    sequence-sharded decode calls it over its own slots ``[lo, hi)`` with
    ``q_offset = pos - lo`` (negative where they all lie after ``pos``:
    ``(0, -inf)``); ``serving.engine.combine_partials`` merges the parts.  The
    float32 products as in :func:`attention_ref`; each KV head's group of
    query rows in one product, as the reference's decode groups them (no
    copy of K or V a query head)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qg = q.float().reshape(b, hkv, h // hkv, sq, d)
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * sm_scale
        mask = attention_mask(sq, skv, causal, window, q_offset, q.device)
        s = s.masked_fill(~mask, -math.inf)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
        out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return out.reshape(b, h, sq, d), lse.reshape(b, h, sq)


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
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    k, v = _expand_kv(k, v, h)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    mask = attention_mask(sq, skv, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    # rows with every position masked: softmax gives uniform; zero them
    out = out.masked_fill(~mask.any(dim=-1)[:, None], 0.0)
    return out.to(q.dtype)


def _expand_kv(k, v, h):
    """K and V for each query head: repeat_interleave over heads, spelt as
    expand + reshape (no host sync, so the plain versions can be captured
    in a CUDA graph for timing)."""
    b, hkv, skv, d = k.shape
    group = h // hkv
    return (k[:, :, None].expand(b, hkv, group, skv, d).reshape(b, h, skv, d),
            v[:, :, None].expand(b, hkv, group, skv, d).reshape(b, h, skv, d))


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        splits: int, chunk: Optional[int] = None,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None, q_offset: int = 0,
                        partials: bool = False):
    """Plain version of the bf16 split path
    (``csrc/flash_attention_bf16.cu``: split kernel, then combine).

    The keys are cut into ``splits`` consecutive parts of ``chunk`` keys
    from key 0 (default ``ceil(Skv / splits)``).  Each part gives float32
    partials per row in base-2 units: ``m``, the largest kept score
    ``s · log2(e)`` (``-inf`` where the part keeps no key), ``l = Σ
    2^(s·log2 e − m)`` and ``acc = Σ 2^(s·log2 e − m) v`` (0 where none is
    kept).  They are combined as the combine kernel does: a part with
    ``m = -inf`` weighs 0, the rest weigh ``2^(m − max m)``, and a row that
    keeps no key in any part is 0.  Returns the output in q's dtype, or with
    ``partials`` ``(out, m, l, acc)``, ``m`` and ``l`` of shape
    (splits, B, H, Sq) and ``acc`` (splits, B, H, Sq, D).  Used by the
    tests and ``chip_smoke.py``; no main path calls it."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if chunk is None:
        chunk = max(1, -(-skv // splits))
    if splits < 1 or chunk < 1 or splits * chunk < skv:
        raise ValueError(f"{splits} splits of {chunk} keys do not cover "
                         f"Skv = {skv}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        k, v = _expand_kv(k, v, h)
        s2 = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
            sm_scale * LOG2E)
        mask = attention_mask(sq, skv, causal, window, q_offset, q.device)
        s2 = s2.masked_fill(~mask, -math.inf)
        ms, ls, accs = [], [], []
        for i in range(splits):
            part = s2[..., i * chunk:(i + 1) * chunk]
            m = (part.amax(dim=-1) if part.shape[-1]
                 else torch.full((b, h, sq), -math.inf, device=q.device))
            base = torch.where(m == -math.inf, 0.0, m)
            p = torch.exp2(part - base[..., None])
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(p @ v[:, :, i * chunk:(i + 1) * chunk].float())
        m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        top = m.amax(dim=0)
        top = torch.where(top == -math.inf, 0.0, top)
        w = torch.where(m == -math.inf, 0.0, torch.exp2(m - top))
        den = (w * l).sum(dim=0)
        num = (w[..., None] * acc).sum(dim=0)
        out = torch.where(den[..., None] > 0, num / den[..., None], 0.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    out = out.to(q.dtype)
    return (out, m, l, acc) if partials else out


def attention_rounded_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        p_split: bool, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """The float32 softmax of ``attention_ref`` with P rounded for a bf16
    product, as a tensor-core P·V sees it: ``p_split`` keeps about 16 bits
    of P as ``hi``, p truncated to bf16, plus ``lo = bf16(p − hi)`` rounded
    to nearest (the bf16 kernels' scheme); otherwise P is rounded to bf16
    alone.  ``l`` sums the
    unrounded p.  An emulation for the tests and the tolerance controls of
    ``chip_smoke.py``; no main path calls it."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        k, v = _expand_kv(k, v, h)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
        mask = attention_mask(sq, skv, causal, window, q_offset, q.device)
        s = s.masked_fill(~mask, -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(m == -math.inf, 0.0, m))
        l = p.sum(dim=-1, keepdim=True)
        if p_split:
            hi = (p.view(torch.int32) & -65536).view(torch.float32)
            pr = hi + (p - hi).to(torch.bfloat16).float()
        else:
            pr = p.to(torch.bfloat16).float()
        out = torch.where(l > 0, (pr @ v.float()) / l, 0.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return out.to(q.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero: ``cvt.rna.tf32.f32``, low 13 bits then zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def attention_tf32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       terms: int, causal: bool = True,
                       sm_scale: Optional[float] = None,
                       window: Optional[int] = None,
                       q_offset: int = 0) -> torch.Tensor:
    """The float32 kernel's precision scheme (``csrc/flash_attention.cu``)
    spelt out on float32 tensors: q scaled by ``sm_scale · log2(e)``, every
    operand of Q Kᵀ and P V rounded to TF32 as the tensor cores read it,
    the softmax in base 2.  ``terms=3``: each operand split as ``hi =
    rna(x)``, ``lo = rna(x − hi)`` and each product taken as
    ``lo·hi + hi·lo + hi·hi`` (split-TF32, the kernel's); ``terms=1``: one
    TF32 product ``rna(a)·rna(b)``, what a kernel with plain TF32 products
    would compute.  ``l`` sums the unrounded p.  An emulation for the tests
    and ``chip_smoke.py``'s float32 tolerance control; no main path calls
    it."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    scale2 = (torch.tensor(sm_scale, dtype=torch.float32)
              * torch.tensor(LOG2E, dtype=torch.float32)).to(q.device)

    def parts(x):
        hi = tf32_round(x)
        return hi, tf32_round(x - hi)

    def product(eq, x, y):
        (xh, xl), (yh, yl) = parts(x), parts(y)
        out = torch.einsum(eq, xh, yh)
        if terms == 3:
            out = (torch.einsum(eq, xl, yh) + torch.einsum(eq, xh, yl)) + out
        return out

    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        k, v = _expand_kv(k.float(), v.float(), h)
        s2 = product("bhqd,bhkd->bhqk", q.float() * scale2, k)
        mask = attention_mask(sq, skv, causal, window, q_offset, q.device)
        s2 = s2.masked_fill(~mask, -math.inf)
        m = s2.amax(dim=-1, keepdim=True)
        p = torch.exp2(s2 - torch.where(m == -math.inf, 0.0, m))
        l = p.sum(dim=-1, keepdim=True)
        out = torch.where(l > 0, product("bhqk,bhkd->bhqd", p, v) / l, 0.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return out.to(q.dtype)
