"""LM serving engine: prefill + single-token decode over the cache tree
(port of the reference's ``serving/engine.py``).

``prefill``     — runs the prompt through the parallel (chunked attention /
chunked WKV / chunked scan) forward while writing each layer's cache;
returns the last-position logits and the filled cache.

``decode_step`` — one new token against the caches.  Mamba and RWKV-6
layers advance their O(1) states (the same calls as prefill, on one
token), and MoE feed-forwards dispatch the batch's tokens.  A dense
layer on CUDA tensors runs the ``flash_attention`` kernel over the whole
contiguous cache (B, KV, S_max, D) with ``causal=True`` and
``q_offset=pos``: its causal mask keeps exactly the reference's
``arange(S_max) <= pos``, and the plan's kept range keeps it from reading
tiles above ``pos``.  On CPU tensors (or
inside ``layers.plain_attention``) it runs :func:`_attn_scores_decode`, the
reference's masked softmax over the whole cache.  A windowed ring buffer's
slots are not in position order, so its decode stays on
:func:`_attn_scores_decode` on either device.

Where the reference scans over the stacked repeats, this loops over them.
Caches are written in place (each stacked leaf through its ``[r]`` view)
and returned; ``pos`` is a host int, so no position is read back from the
device.

On a mesh the parameters are DTensors and the dense caches DTensors
placed by ``launch.specs.cache_pack`` (``init_cache(..., mesh=mesh)``):
batch over ``data``, sequence over ``model``.  A write at positions
``[lo, hi)`` lands in the shards that own those slots, each rank writing
its part of the range into its local shard (:func:`_write_slots`).  The
decode's attention gathers K and V over ``model`` first (exact, simple)
and runs the single-device call on each rank's batch rows; prefill's
attention is ``layers.mesh_attention``.  Tokens are the global batch, alike
on every rank; logits come back as DTensors.  Windowed and recurrent
caches are not placed on a mesh.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, attention_apply,
                                       attention_qkv, attention_window,
                                       norm_apply, rope, uses_kernel)
from repro_torch.models.mamba import mamba_apply
from repro_torch.models.rwkv6 import rwkv6_time_mix
from repro_torch.models.transformer import (embed, encode, ffn_apply,
                                            layer_slice, stack_layout,
                                            unembed_logits)
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (is_dtensor, mesh_scope,
                                           shard_range)

from .cache import CacheTree, init_cache, layer_cache_kind

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Attention over caches
# ---------------------------------------------------------------------------

def _attn_scores_decode(cfg: ModelConfig, q: torch.Tensor,
                        k_cache: torch.Tensor, v_cache: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Plain decode attention: q (B,H,1,D); cache (B,KV,S,D); mask
    broadcastable to (B,KV,group,S), True where a slot is kept."""
    group = cfg.n_heads // cfg.n_kv_heads
    b, h, _, hd = q.shape
    kv = cfg.n_kv_heads
    qg = q.reshape(b, kv, group, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                     k_cache.float()) * (hd ** -0.5)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.reshape(b, h, 1, hd).to(q.dtype)


def _write_slots(dst: torch.Tensor, src: torch.Tensor, lo: int) -> None:
    """``dst[:, :, lo:lo + S] = src`` for a cache leaf (B, KV, S_max, D)
    and new entries (B, KV, S, D).  A DTensor cache: ``src`` is brought to
    the cache's batch placement (its other dims whole) and each rank
    writes the part of ``[lo, lo + S)`` its sequence shard owns."""
    if not is_dtensor(dst):
        dst[:, :, lo:lo + src.shape[2]] = src.to(dst.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    want = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in dst.placements]
    if not is_dtensor(src):
        raise TypeError("a cache on a mesh takes DTensor entries")
    local = src.redistribute(dst.device_mesh, want).to_local()
    start, stop = shard_range(dst, 2)
    a, b = max(lo, start), min(lo + src.shape[2], stop)
    if a < b:
        dst.to_local()[:, :, a - start:b - start] = \
            local[:, :, a - lo:b - lo].to(dst.dtype)


def _mesh_decode_attention(cfg: ModelConfig, q, k_cache, v_cache,
                           pos: int):
    """Decode attention of DTensor q (B, H, 1, D) over a sequence-sharded
    DTensor cache: K and V gathered over every axis but the batch's, then
    the single-device call on each rank's batch rows."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_cache.device_mesh
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in k_cache.placements]

    def local(ql, kl, vl):
        if uses_kernel(ql):
            return ops.attention(ql.to(kl.dtype).contiguous(), kl, vl,
                                 causal=True, q_offset=pos,
                                 backend="cuda").to(ql.dtype)
        mask = (torch.arange(kl.shape[2], device=kl.device)
                <= pos)[None, None, None, :]
        return _attn_scores_decode(cfg, ql, kl, vl, mask)

    return local_map(local, out_placements=rows,
                     in_placements=(rows, rows, rows), device_mesh=mesh,
                     redistribute_inputs=True)(q, k_cache, v_cache)


def attn_decode(bp, cfg: ModelConfig, kind: str, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, d); returns (out (B, 1, d), cache written in place)."""
    b = x.shape[0]
    _, theta = attention_window(cfg, kind)
    q, k, v = attention_qkv(bp, cfg, x)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, theta)
    k = rope(k, posv, theta)

    if layer_cache_kind(cfg, kind) != "dense" and is_dtensor(cache["k"]):
        raise NotImplementedError(f"a {kind} cache is not placed on a mesh")
    if is_dtensor(cache["k"]):
        _write_slots(cache["k"], k, pos)
        _write_slots(cache["v"], v, pos)
        o = _mesh_decode_attention(cfg, q, cache["k"], cache["v"], pos)
    elif layer_cache_kind(cfg, kind) == "dense":
        cache["k"][:, :, pos:pos + 1] = k.to(cache["k"].dtype)
        cache["v"][:, :, pos:pos + 1] = v.to(cache["v"].dtype)
        if uses_kernel(q):          # the kernel takes one dtype: the cache's
            o = ops.attention(q.to(cache["k"].dtype).contiguous(),
                              cache["k"], cache["v"], causal=True,
                              q_offset=pos, backend="cuda").to(q.dtype)
        else:
            s_max = cache["k"].shape[2]
            mask = (torch.arange(s_max, device=x.device)
                    <= pos)[None, None, None, :]
            o = _attn_scores_decode(cfg, q, cache["k"], cache["v"], mask)
    else:                                       # windowed ring buffer
        w = cache["k"].shape[2]
        slot = pos % w
        cache["k"][:, :, slot:slot + 1] = k.to(cache["k"].dtype)
        cache["v"][:, :, slot:slot + 1] = v.to(cache["v"].dtype)
        cache["slot_pos"][slot] = pos
        slot_pos = cache["slot_pos"]
        valid = (slot_pos >= 0) & (pos - slot_pos < cfg.local_window)
        o = _attn_scores_decode(cfg, q, cache["k"], cache["v"],
                                valid[None, None, None, :])
    # a 2-D product: a plain (B, 1, n) @ W folds to this one, while
    # DTensor's matmul of a (B, 1, n) takes another kernel, and a one-rank
    # mesh would part from one device in the last bit
    out = o.transpose(1, 2).reshape(b, cfg.n_heads * cfg.head_dim)
    return (out @ bp["wo"]).reshape(b, 1, -1), cache


def attn_prefill(bp, cfg: ModelConfig, kind: str, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], q_offset: int = 0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Parallel attention over the prompt + cache write.  x (B, S, d)."""
    b, s, _ = x.shape
    window, theta = attention_window(cfg, kind)
    q, k, v = attention_qkv(bp, cfg, x)
    posv = q_offset + torch.arange(s, device=x.device)
    q = rope(q, posv, theta)
    k = rope(k, posv, theta)
    o = attention(q, k, v, causal=True, window=window, q_offset=q_offset,
                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                  causal_skip=cfg.causal_skip)
    if layer_cache_kind(cfg, kind) == "dense":
        _write_slots(cache["k"], k, q_offset)
        _write_slots(cache["v"], v, q_offset)
    elif is_dtensor(cache["k"]):
        raise NotImplementedError(f"a {kind} cache is not placed on a mesh")
    else:
        w = cache["k"].shape[2]
        take = min(w, s)
        pos_tail = posv[-take:]
        slots = pos_tail % w
        cache["k"][:, :, slots] = k[:, :, -take:].to(cache["k"].dtype)
        cache["v"][:, :, slots] = v[:, :, -take:].to(cache["v"].dtype)
        cache["slot_pos"][slots] = pos_tail.to(torch.int32)
    out = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return out @ bp["wo"], cache


# ---------------------------------------------------------------------------
# Per-layer prefill / decode
# ---------------------------------------------------------------------------

def _recurrent_mix(bp, cfg: ModelConfig, kind: str, x: torch.Tensor,
                   cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A Mamba or RWKV-6 mixer over x (B, S, d) from the layer's states,
    which it advances in place."""
    if kind == "mamba":
        mix, (conv, hs) = mamba_apply(bp, cfg, x,
                                      state=(cache["conv"], cache["h"]),
                                      return_state=True)
        cache["conv"].copy_(conv)
        cache["h"].copy_(hs)
    elif kind == "rwkv6":
        mix, (shift, wkv) = rwkv6_time_mix(
            bp, cfg, x, shift_prev=cache["shift"], wkv_state=cache["wkv"],
            return_state=True)
        cache["shift"].copy_(shift)
        cache["wkv"].copy_(wkv)
    else:
        raise ValueError(kind)
    return mix


def _block(bp, cfg: ModelConfig, h, kind: str, is_moe: bool, cache,
           attn_fn, enc_out):
    hin = norm_apply(bp["norm1"], cfg, h)
    if kind.startswith("attn"):
        mix, cache = attn_fn(hin)
    else:
        mix = _recurrent_mix(bp["mix"], cfg, kind, hin, cache)
    h = h + mix
    if enc_out is not None and "cross" in bp:
        hx = norm_apply(bp["norm_x"], cfg, h)
        h = h + attention_apply(bp["cross"], cfg, hx, kv_input=enc_out,
                                causal=False)
    hf = norm_apply(bp["norm2"], cfg, h)
    out, _, cm_last = ffn_apply(
        bp, cfg, hf, kind, is_moe,
        cm_shift=cache["cm_shift"] if kind == "rwkv6" else None)
    if cm_last is not None:
        cache["cm_shift"].copy_(cm_last)
    return h + out, cache


def block_prefill(bp, cfg: ModelConfig, h, kind: str, is_moe: bool, cache,
                  *, enc_out=None, q_offset: int = 0):
    return _block(bp, cfg, h, kind, is_moe, cache,
                  lambda hin: attn_prefill(bp["mix"], cfg, kind, hin, cache,
                                           q_offset=q_offset), enc_out)


def block_decode(bp, cfg: ModelConfig, h, kind: str, is_moe: bool, cache,
                 pos: int, *, enc_out=None):
    return _block(bp, cfg, h, kind, is_moe, cache,
                  lambda hin: attn_decode(bp["mix"], cfg, kind, hin, cache,
                                          pos), enc_out)


# ---------------------------------------------------------------------------
# Whole-model prefill / decode
# ---------------------------------------------------------------------------

def _layers(params, cfg: ModelConfig, cache: CacheTree):
    """Every layer in order: (params, cache, kind, is_moe), stacked leaves
    taken at their repeat."""
    pattern, reps, tail_items = stack_layout(cfg)
    for r in range(reps):
        bp_slice = layer_slice(params["blocks"], r)
        cache_slice = layer_slice(cache.blocks, r)
        for posn, (kind, moe) in enumerate(pattern):
            yield bp_slice[posn], cache_slice[posn], kind, moe
    for bp, c, (kind, moe) in zip(params["tail"], cache.tail, tail_items):
        yield bp, c, kind, moe


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: CacheTree, *, prefix_embed=None, frames=None
            ) -> Tuple[torch.Tensor, CacheTree]:
    """Prompt (B, S) → (last-token logits (B, vocab_padded), the caches
    filled in place)."""
    with mesh_scope(params):
        enc_out = encode(params, cfg, frames) if cfg.encoder_layers else None
        h = embed(params, tokens, prefix_embed)
        for bp, c, kind, moe in _layers(params, cfg, cache):
            h, _ = block_prefill(bp, cfg, h, kind, moe, c, enc_out=enc_out)
        h = norm_apply(params["final_norm"], cfg, h)
        return unembed_logits(params, cfg, h[:, -1]), cache


def decode_step(params, cfg: ModelConfig, cache: CacheTree,
                tokens: torch.Tensor, pos: int, *, enc_out=None
                ) -> Tuple[torch.Tensor, CacheTree]:
    """One token per sequence.  tokens (B,), ``pos`` the host int position
    of the new token.  Returns (logits (B, vocab_padded), the caches
    written in place)."""
    pos = int(pos)
    with mesh_scope(params):
        h = embed(params, tokens[:, None])
        for bp, c, kind, moe in _layers(params, cfg, cache):
            h, _ = block_decode(bp, cfg, h, kind, moe, c, pos,
                                enc_out=enc_out)
        h = norm_apply(params["final_norm"], cfg, h)
        return unembed_logits(params, cfg, h[:, 0]), cache


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_tokens: int,
             max_seq: int, *, dtype: torch.dtype = torch.bfloat16,
             frames=None, prefix_embed=None) -> torch.Tensor:
    """Greedy generation driver (examples / tests): (B, n_tokens)."""
    b, s = prompt.shape
    device = params["embed"].device
    cache = init_cache(cfg, b, max_seq, dtype, device)
    logits, cache = prefill(params, cfg, prompt, cache, frames=frames,
                            prefix_embed=prefix_embed)
    enc_out = encode(params, cfg, frames) if cfg.encoder_layers else None
    tok = torch.argmax(logits, -1)
    tokens = [tok]
    pos = s + (prefix_embed.shape[1] if prefix_embed is not None else 0)
    for _ in range(n_tokens - 1):
        logits, cache = decode_step(params, cfg, cache, tok, pos,
                                    enc_out=enc_out)
        tok = torch.argmax(logits, -1)
        tokens.append(tok)
        pos += 1
    return torch.stack(tokens, 1)
