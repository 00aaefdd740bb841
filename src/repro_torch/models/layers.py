"""Core neural layers (port of the reference's ``models/layers.py``).

Norms, rotary embeddings, GQA attention and the MLP family (SwiGLU /
GeGLU / squared-ReLU / GELU), config-driven, in torch on the tensors'
device.  :func:`attention` picks the attention path by device: on CUDA
tensors the hand-written ``flash_attention`` kernel
(``repro_torch.kernels.ops.attention``), on CPU tensors the plain
:func:`chunked_attention`, the reference's double-chunked online softmax
with its chunk schedule.  There is no fallback from one to the other;
:func:`plain_attention` runs the plain version on either device, for the
card-side check of the kernel path.

On a mesh the parameters are DTensors (``models.params``), and so are
the activations.  The reference's ``constrain``/``constrain_seq``
sharding annotations are :func:`constrain`/:func:`constrain_seq` here,
at the same points: an explicit ``redistribute`` of a DTensor to the
spec's placements, an identity on a plain tensor; and the products'
inputs are gathered over the sequence first (``constrain(x, "batch",
None, None)``: sequence parallelism's all-gather, which DTensor's
flattening view of a sequence-sharded (B, S, d) would otherwise refuse).
Attention on a mesh runs the same op on each rank's local (batch, head)
shard through ``local_map`` (:func:`mesh_attention`).  The reference's
``grad_cast`` (a gradient-dtype boundary) is an identity in the forward
pass whose backward casts the cotangent to the input's dtype, and so it
is here.  Under grad the kernel's attention output backpropagates
through :func:`chunked_attention` with the same arguments
(``ops.with_plain_backward``): the kernel path's gradients are the plain
path's.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (P, fit_spec, is_dtensor,
                                           logical_to_spec, mesh_axes,
                                           placements)

from .config import ModelConfig
from .params import ParamDef

NEG_INF = -1e30

_PLAIN = contextvars.ContextVar("plain_attention", default=False)


@contextlib.contextmanager
def attention_mode(plain: bool) -> Iterator[None]:
    """Inside this scope attention runs as it would inside
    :func:`plain_attention` (``plain``) or outside every such scope: a
    checkpointed block's recompute runs under the mode of its forward."""
    token = _PLAIN.set(plain)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_attention():
    """Inside this scope every attention call of the model (prefill,
    decode, cross and encoder attention) runs its plain torch version on
    either device, not the kernel."""
    return attention_mode(True)


def plain_mode() -> bool:
    """True inside :func:`plain_attention`."""
    return _PLAIN.get()


def uses_kernel(x: torch.Tensor) -> bool:
    """True where attention over ``x``'s device launches the kernel."""
    return x.device.type == "cuda" and not _PLAIN.get()


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint: a DTensor redistributed to the
    placements of ``logical``'s spec on its mesh (mesh axes that do not
    divide their dim dropped); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = fit_spec(logical_to_spec(logical, mesh), x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def constrain_seq(x: torch.Tensor) -> torch.Tensor:
    """Sequence-parallel residual-stream constraint: (B, S, d) sharded
    ("batch", "seq", None)."""
    return constrain(x, "batch", "seq", None)


class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype)


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    """The reference's bf16 cotangent boundary: identity in the forward
    pass; the backward casts the cotangent to ``x``'s dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GradCast.apply(x)
    return x


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((d,), (None,), init="ones"),
                "bias": ParamDef((d,), (None,), init="zeros")}
    return {"scale": ParamDef((d,), (None,), init="ones")}


def norm_apply(p, cfg: ModelConfig, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (..., S, D) rotate-half RoPE at absolute ``positions`` (S,)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]   # (S, half)
    cos = torch.cos(ang)[None, None]
    sin = torch.sin(ang)[None, None]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf1 * sin + xf2 * cos],
                     -1).to(x.dtype)


# ---------------------------------------------------------------------------
# Double-chunked attention (flash-style, plain torch)
# ---------------------------------------------------------------------------

def _pick(n: int, target: int) -> int:
    """Largest divisor of n that is ≤ target (whisper's 1500-frame encoder
    and other non-power-of-2 lengths)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, q_chunk: int = 512,
                      kv_chunk: int = 512,
                      causal_skip: bool = False) -> torch.Tensor:
    """Online-softmax attention, O(q_chunk·kv_chunk) live scores: the
    reference's chunk schedule, step for step.

    q (B, H, Sq, D); k/v (B, KV, Skv, D); GQA expands the KV *chunk* only.
    ``causal_skip`` drops fully-masked (q, kv) chunk pairs from the
    schedule instead of masking them (only with ``q_offset == 0``)."""
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = h // hkv
    q_chunk = _pick(sq, q_chunk)
    kv_chunk = _pick(skv, kv_chunk)
    nq, nk = sq // q_chunk, skv // kv_chunk
    scale = d ** -0.5
    dev = q.device
    outs = []
    for qi in range(nq):
        q_i = q[:, :, qi * q_chunk:(qi + 1) * q_chunk].float()
        qpos = (q_offset + qi * q_chunk
                + torch.arange(q_chunk, device=dev))[:, None]
        m = torch.full((b, h, q_chunk, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_chunk, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32, device=dev)
        if causal_skip and causal and q_offset == 0:
            # only kv chunks j ∈ [lo, qi] contribute: causality bounds the
            # top, a sliding window the bottom
            lo = (max(0, (qi * q_chunk - (window - 1)) // kv_chunk)
                  if window is not None else 0)
            js = range(lo, qi + 1)
        else:
            js = range(nk)
        for j in js:
            kj = k[:, :, j * kv_chunk:(j + 1) * kv_chunk]
            vj = v[:, :, j * kv_chunk:(j + 1) * kv_chunk]
            kj = kj.repeat_interleave(group, dim=1)        # (B, H, ck, D)
            vj = vj.repeat_interleave(group, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", q_i, kj.float()) * scale
            kpos = j * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= qpos >= kpos
            if window is not None:
                mask &= (qpos - kpos) < window
            s = s.masked_fill(~mask[None, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            # P·V in the input dtype with float32 accumulation, as the
            # reference's flash discipline
            acc = acc * alpha + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vj.dtype).float(), vj.float())
            m = m_new
        safe = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((acc / safe).to(q.dtype))
    return outs[0] if nq == 1 else torch.cat(outs, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, q_chunk: int = 512, kv_chunk: int = 512,
              causal_skip: bool = False) -> torch.Tensor:
    """Attention of q (B, H, Sq, D) over k/v (B, KV, Skv, D).  On CUDA
    tensors the ``flash_attention`` kernel (contiguous operands, as it
    takes them; ``q_offset`` from the host), backpropagating through
    :func:`chunked_attention` with the same arguments; on CPU tensors, or
    inside :func:`plain_attention`, :func:`chunked_attention`."""
    if is_dtensor(q):
        return mesh_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, causal_skip=causal_skip)
    if uses_kernel(q):
        plain = functools.partial(
            chunked_attention, causal=causal, window=window,
            q_offset=q_offset, q_chunk=q_chunk, kv_chunk=kv_chunk,
            causal_skip=causal_skip)
        launch = functools.partial(ops.attention, causal=causal,
                                   window=window, q_offset=q_offset,
                                   backend="cuda")
        return ops.with_plain_backward(launch, plain, q.contiguous(),
                                       k.contiguous(), v.contiguous())
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, q_chunk=q_chunk,
                             kv_chunk=kv_chunk, causal_skip=causal_skip)


def _grad_places(places, mesh, partial_axes):
    """``places`` with ``Partial()`` on the mesh dims named in
    ``partial_axes`` (an input every rank of them uses a different part
    of has a gradient each of them holds a part of)."""
    from torch.distributed.tensor import Partial
    names = mesh.mesh_dim_names
    return tuple(Partial() if names[i] in partial_axes else pl
                 for i, pl in enumerate(places))


def mesh_attention(q, k, v, **kw) -> torch.Tensor:
    """:func:`attention` of DTensor operands, on each rank's local shard
    through ``local_map``: batch over the batch axes, query heads over
    ``model`` where it divides them.

    * ``model`` divides the KV heads: each rank holds whole KV heads and
      the query heads of their groups (qwen2.5-smoke's 4 heads over 2 KV
      heads at model = 2: one KV head and its two query heads a rank), and
      the local call is the op's own GQA.
    * ``model`` divides the query heads but not the KV heads (model = 4
      there: ``wk``'s kv·hd columns split inside a head): K and V are
      redistributed to ``Replicate`` over ``model`` first, as GSPMD
      gathers them, and each rank takes the KV head of each of its query
      heads (a local group of 1).  Their gradients are partial over
      ``model``.
    * ``model`` divides neither: every rank of ``model`` computes all
      heads.

    The local call is :func:`attention` on plain tensors: the kernel on a
    card, :func:`chunked_attention` on the CPU."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    tp = mesh_axes(mesh).get("model", 1)
    h, hkv = q.shape[1], k.shape[1]
    q_spec = fit_spec(logical_to_spec(("batch", "tp", None, None), mesh),
                      q.shape, mesh)
    heads_split = q_spec[1] is not None
    kv_split = heads_split and hkv % tp == 0
    kv_spec = q_spec if kv_split else P(q_spec[0], None, None, None)
    q_pl, kv_pl = placements(q_spec, mesh), placements(kv_spec, mesh)
    pick = None
    kv_grad = kv_pl
    if heads_split and not kv_split:
        rank, local = mesh.get_local_rank("model"), h // tp
        pick = torch.arange(rank * local, (rank + 1) * local) // (h // hkv)
        kv_grad = _grad_places(kv_pl, mesh, ("model",))

    def local_call(ql, kl, vl):
        if pick is not None:
            idx = pick.to(kl.device)
            kl, vl = kl.index_select(1, idx), vl.index_select(1, idx)
        return attention(ql, kl, vl, **kw)

    return local_map(local_call, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig, *, cross: bool = False
                   ) -> Dict[str, ParamDef]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * hd), ("fsdp", "tp")),
        "wk": ParamDef((d, kv * hd), ("fsdp", "tp")),
        "wv": ParamDef((d, kv * hd), ("fsdp", "tp")),
        "wo": ParamDef((h * hd, d), ("tp", "fsdp")),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = ParamDef((h * hd,), ("tp",), init="zeros")
        defs["bk"] = ParamDef((kv * hd,), ("tp",), init="zeros")
        defs["bv"] = ParamDef((kv * hd,), ("tp",), init="zeros")
    return defs


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n·hd) → (B, n, S, hd), a transposed view.  A DTensor whose
    last dim ``model`` shards inside a head (``n`` heads do not split over
    it: 2 KV heads at model = 4) is gathered over ``model`` first."""
    b, s, _ = x.shape
    if is_dtensor(x) and n % mesh_axes(x.device_mesh).get("model", 1):
        x = constrain(x, "batch", None, None)
    return x.reshape(b, s, n, hd).transpose(1, 2)


def attention_qkv(p, cfg: ModelConfig, x: torch.Tensor,
                  kv_input: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to (q, k, v) with head layout (B, H, S, D) (transposed
    views, not contiguous)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # a sequence-sharded residual stream is gathered before the products
    x = constrain(x, "batch", None, None)
    kv_in = x if kv_input is None else constrain(kv_input, "batch", None,
                                                 None)
    q = x @ p["wq"]
    k = kv_in @ p["wk"]
    v = kv_in @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = _split_heads(q, h, hd)
    k = _split_heads(k, kv, hd)
    v = _split_heads(v, kv, hd)
    q = constrain(q, "batch", "tp", None, None)
    return q, k, v


def _merge_heads(o: torch.Tensor, s: int, width: int) -> torch.Tensor:
    """(B, n, S, hd) → (B, S, n·hd).  A DTensor whose heads ``model`` does
    not split (every rank of ``model`` holds them all) is merged on each
    rank's local tensor through ``local_map``: the output projection's
    backward hands the gradient back split over ``model`` inside a head,
    which DTensor cannot unflatten, and ``local_map`` brings it back whole
    first."""
    if not (is_dtensor(o)
            and o.shape[1] % mesh_axes(o.device_mesh).get("model", 1)):
        return o.transpose(1, 2).reshape(o.shape[0], s, width)
    from torch.distributed.tensor.experimental import local_map
    places = list(o.placements)
    return local_map(lambda t: t.transpose(1, 2).reshape(t.shape[0], s,
                                                         width),
                     out_placements=places, in_placements=(places,),
                     device_mesh=o.device_mesh,
                     redistribute_inputs=True)(o)


def attention_window(cfg: ModelConfig, kind: str
                     ) -> Tuple[Optional[int], float]:
    """(window, RoPE theta) of an attention layer kind: 'attn' (global) |
    'attn_local' | 'attn_swa'."""
    if kind in ("attn_local", "attn_swa"):
        return cfg.local_window, cfg.rope_theta
    if kind == "attn" and cfg.rope_theta_global is not None:
        return None, cfg.rope_theta_global
    return None, cfg.rope_theta


def attention_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
                    kind: str = "attn",
                    positions: Optional[torch.Tensor] = None,
                    kv_input: Optional[torch.Tensor] = None,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Full attention block: qkv → rope → attention → output proj.

    kind selects window and (for gemma3) the RoPE theta.  ``kv_input``
    switches to cross-attention (no RoPE on kv, non-causal)."""
    b, s, _ = x.shape
    q, k, v = attention_qkv(p, cfg, x, kv_input)
    window, theta = attention_window(cfg, kind)
    is_cross = kv_input is not None
    if not is_cross:
        if positions is None:
            positions = q_offset + torch.arange(s, device=x.device)
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    q, k, v = grad_cast(q), grad_cast(k), grad_cast(v)
    out = attention(
        q, k, v, causal=causal and not is_cross,
        window=None if is_cross else window, q_offset=q_offset,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        causal_skip=cfg.causal_skip)
    out = _merge_heads(out, s, cfg.n_heads * cfg.head_dim)
    return constrain(out @ p["wo"], "batch", None, None)


# ---------------------------------------------------------------------------
# MLP family
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None
             ) -> Dict[str, ParamDef]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {"wg": ParamDef((d, ff), ("fsdp", "tp")),
                "wu": ParamDef((d, ff), ("fsdp", "tp")),
                "wd": ParamDef((ff, d), ("tp", "fsdp"))}
    return {"wu": ParamDef((d, ff), ("fsdp", "tp")),
            "wd": ParamDef((ff, d), ("tp", "fsdp"))}


def mlp_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = constrain(x, "batch", None, None)
    if cfg.act == "swiglu":
        hmid = F.silu(x @ p["wg"]) * (x @ p["wu"])
    elif cfg.act == "geglu":
        hmid = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wu"])
    elif cfg.act == "sq_relu":
        r = torch.clamp(x @ p["wu"], min=0)
        hmid = r * r                       # nemotron squared-ReLU
    else:
        hmid = F.gelu(x @ p["wu"], approximate="tanh")
    hmid = constrain(hmid, "batch", None, "tp")
    return constrain(hmid @ p["wd"], "batch", None, None)
