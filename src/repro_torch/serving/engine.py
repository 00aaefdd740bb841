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
decode's attention brings K and V to each rank's heads over the whole
sequence (exact, simple) and runs the single-device call on each rank's
batch rows and heads; prefill's attention is ``layers.mesh_attention``.
Tokens are the global batch, alike on every rank (or DTensors placed as
the batch); logits come back as DTensors.  A windowed ring is
batch-sharded and whole in its slots: each rank writes its rows into its
ring (:func:`_write_ring`) and attends over it by the replicated slot
positions.  The Mamba and RWKV-6 states take ``cache_pack``'s
placements, and each rank writes its shard of the new state
(:func:`_assign`).
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
    b, h, _, hd = q.shape
    kv = k_cache.shape[1]
    group = h // kv
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


def _local_pair(dst: torch.Tensor, src: torch.Tensor):
    """(``dst``'s local tensor, ``src`` in ``dst``'s placements, local):
    a cache leaf and the entries to write into it, on either path."""
    if not is_dtensor(dst):
        return dst, src
    if not is_dtensor(src):
        raise TypeError("a cache on a mesh takes DTensor entries")
    return dst.to_local(), src.redistribute(dst.device_mesh,
                                            dst.placements).to_local()


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for a state leaf; on a mesh each rank writes its
    shard."""
    dst, src = _local_pair(dst, src)
    dst.copy_(src)


def _write_ring(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor, slots, positions) -> None:
    """A windowed ring buffer's write: k/v (B, KV, n, D) into ``slots``
    (a slice or an index tensor of n slots) and their absolute positions
    into ``slot_pos``.  On a mesh the ring is batch-sharded and whole in
    its slots (``cache_pack``): each rank writes its rows."""
    for name, src in (("k", k), ("v", v)):
        dst, loc = _local_pair(cache[name], src)
        dst[:, :, slots] = loc.to(dst.dtype)
    slot_pos = cache["slot_pos"]
    slot_pos = slot_pos.to_local() if is_dtensor(slot_pos) else slot_pos
    if isinstance(positions, int):      # a tensor on every device type
        positions = torch.full((1,), positions, dtype=slot_pos.dtype,
                               device=slot_pos.device)
    slot_pos[slots] = positions


def _mesh_decode_attention(cfg: ModelConfig, q, k_cache, v_cache,
                           pos: int, slot_pos=None):
    """Decode attention of DTensor q (B, H, 1, D) over a DTensor cache, on
    each rank's batch rows and heads: the query heads split over
    ``model`` where it divides them, and K and V brought to each rank's
    KV heads over the whole sequence (a sequence-sharded dense cache
    regathered; a ring is whole in its slots already) — the KV heads
    split alike where ``model`` divides them, else whole, each rank
    taking the KV head of each of its query heads, as
    ``layers.mesh_attention`` does.  Then the single-device call.
    ``slot_pos`` (a ring's, replicated) masks by the window, as the
    single-device ring decode does."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_cache.device_mesh
    names = mesh.mesh_dim_names
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in k_cache.placements]
    h, hkv = q.shape[1], k_cache.shape[1]
    tp = mesh.size(names.index("model")) if "model" in names else 1
    heads = tp > 1 and h % tp == 0
    kv_heads = heads and hkv % tp == 0
    on_model = lambda pl: [pl if n == "model" else r
                           for n, r in zip(names, rows)]
    q_pl = on_model(Shard(1)) if heads else rows
    kv_pl = on_model(Shard(1)) if kv_heads else rows
    pick = None
    if heads and not kv_heads:
        rank, per_rank = mesh.get_local_rank("model"), h // tp
        pick = torch.arange(rank * per_rank,
                            (rank + 1) * per_rank) // (h // hkv)

    def local(ql, kl, vl, *ring):
        if pick is not None:
            idx = pick.to(kl.device)
            kl, vl = kl.index_select(1, idx), vl.index_select(1, idx)
        if ring:
            sp = ring[0]
            valid = (sp >= 0) & (pos - sp < cfg.local_window)
            return _attn_scores_decode(cfg, ql, kl, vl,
                                       valid[None, None, None, :])
        if uses_kernel(ql):
            return ops.attention(ql.to(kl.dtype).contiguous(),
                                 kl.contiguous(), vl.contiguous(),
                                 causal=True, q_offset=pos,
                                 backend="cuda").to(ql.dtype)
        mask = (torch.arange(kl.shape[2], device=kl.device)
                <= pos)[None, None, None, :]
        return _attn_scores_decode(cfg, ql, kl, vl, mask)

    args = (q, k_cache, v_cache)
    places = (q_pl, kv_pl, kv_pl)
    if slot_pos is not None:
        args += (slot_pos,)
        places += ([Replicate()] * mesh.ndim,)
    return local_map(local, out_placements=q_pl, in_placements=places,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


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

    dense = layer_cache_kind(cfg, kind) == "dense"
    if is_dtensor(cache["k"]) and dense:
        _write_slots(cache["k"], k, pos)
        _write_slots(cache["v"], v, pos)
        o = _mesh_decode_attention(cfg, q, cache["k"], cache["v"], pos)
    elif is_dtensor(cache["k"]):                # a ring on a mesh
        slot = pos % cache["k"].shape[2]
        _write_ring(cache, k, v, slice(slot, slot + 1), pos)
        o = _mesh_decode_attention(cfg, q, cache["k"], cache["v"], pos,
                                   cache["slot_pos"])
    elif dense:
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
        slot = pos % cache["k"].shape[2]
        _write_ring(cache, k, v, slice(slot, slot + 1), pos)
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
    else:
        w = cache["k"].shape[2]
        take = min(w, s)
        pos_tail = posv[-take:]
        _write_ring(cache, k[:, :, -take:], v[:, :, -take:], pos_tail % w,
                    pos_tail.to(torch.int32))
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
        _assign(cache["conv"], conv)
        _assign(cache["h"], hs)
    elif kind == "rwkv6":
        mix, (shift, wkv) = rwkv6_time_mix(
            bp, cfg, x, shift_prev=cache["shift"], wkv_state=cache["wkv"],
            return_state=True)
        _assign(cache["shift"], shift)
        _assign(cache["wkv"], wkv)
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
        _assign(cache["cm_shift"], cm_last)
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
