"""Model assembly: decoder-only LMs, hybrids and encoder-decoders (port
of the reference's ``models/transformer.py``).

The layer stack is expressed as (pattern × repeats) + tail: the smallest
repeating period of the per-layer schedule is detected and parameters for
each pattern position are *stacked* over the repeats, as in the reference,
so that its parameter tree carries over leaf for leaf
(``params.params_from_numpy``).  Where the reference scans over the
repeats, the forward pass here loops over them, taking each stacked leaf
at ``[r]``.  Non-periodic tails apply as individual layers.  A layer's
mixer is attention, RWKV-6 (which carries its own channel mix) or Mamba;
its feed-forward a dense MLP or MoE.

Where grad is enabled, every block (decoder, tail and encoder) runs
under ``torch.utils.checkpoint`` by ``cfg.remat``, as the reference wraps
its scanned blocks in ``jax.checkpoint`` (:func:`remat`); serving, under
``torch.inference_mode``, is not wrapped.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.parallel.sharding import (distribute, fit_spec,
                                           is_dtensor, logical_to_spec,
                                           mesh_axes, placements)

from . import layers, moe
from .config import ModelConfig
from .layers import (attention_apply, attention_defs, constrain,
                     constrain_seq, mlp_apply, mlp_defs, norm_apply,
                     norm_defs)
from .mamba import mamba_apply, mamba_defs
from .moe import moe_apply, moe_defs
from .params import ParamDef, is_tensor, tree_map
from .rwkv6 import rwkv6_channel_mix, rwkv6_defs, rwkv6_time_mix


# ---------------------------------------------------------------------------
# Schedule → (pattern, repeats, tail)
# ---------------------------------------------------------------------------

def schedule_items(cfg: ModelConfig) -> List[Tuple[str, bool]]:
    return list(zip(cfg.layer_schedule(), cfg.moe_layers()))


def find_period(items: List[Tuple[str, bool]]) -> Tuple[int, int, int]:
    """Smallest (period, repeats, tail) with items = pattern×repeats + tail
    and repeats ≥ 1."""
    n = len(items)
    for p in range(1, n + 1):
        reps = n // p
        body = items[:reps * p]
        if all(body[i] == body[i % p] for i in range(len(body))):
            tail_start = reps * p
            if all(items[tail_start + j] == items[j]
                   for j in range(n - tail_start)):
                return p, reps, n - tail_start
    return n, 1, 0


def stack_layout(cfg: ModelConfig
                 ) -> Tuple[List[Tuple[str, bool]], int,
                            List[Tuple[str, bool]]]:
    """(pattern, repeats, tail items) of the layer stack: the pattern is
    empty when nothing repeats (every layer in the tail)."""
    items = schedule_items(cfg)
    if cfg.scan_layers:
        p, reps, _ = find_period(items)
    else:
        p, reps = len(items), 1
    if reps <= 1:
        return [], 0, items
    return items[:p], reps, items[p * reps:]


# ---------------------------------------------------------------------------
# Per-layer defs
# ---------------------------------------------------------------------------

def block_defs(cfg: ModelConfig, kind: str, is_moe: bool, *,
               cross: bool = False) -> Dict[str, Any]:
    defs: Dict[str, Any] = {"norm1": norm_defs(cfg)}
    if kind.startswith("attn"):
        defs["mix"] = attention_defs(cfg)
    elif kind == "rwkv6":
        defs["mix"] = rwkv6_defs(cfg)
    elif kind == "mamba":
        defs["mix"] = mamba_defs(cfg)
    else:
        raise ValueError(kind)
    if cross:
        defs["norm_x"] = norm_defs(cfg)
        defs["cross"] = attention_defs(cfg, cross=True)
    defs["norm2"] = norm_defs(cfg)
    if kind != "rwkv6":                       # rwkv6 carries its channel mix
        defs["ffn"] = moe_defs(cfg) if is_moe else mlp_defs(cfg)
    return defs


def ffn_apply(bp, cfg: ModelConfig, hf: torch.Tensor, kind: str,
              is_moe: bool, cm_shift: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The feed-forward half of a layer on the normed ``hf``: RWKV-6's
    channel mix (its token shift from ``cm_shift``), MoE or the dense MLP.
    Returns (out, moe aux scalar, the channel mix's last input or None)."""
    aux = torch.zeros((), dtype=torch.float32, device=hf.device)
    if kind == "rwkv6":
        out, last = rwkv6_channel_mix(bp["mix"], cfg, hf,
                                      shift_prev=cm_shift, return_state=True)
        return out, aux, last
    if is_moe:
        out, moe_aux = moe_apply(bp["ffn"], cfg, hf)
        return (out, aux + moe_aux["load_balance"]
                + 1e-3 * moe_aux["router_z"], None)
    return mlp_apply(bp["ffn"], cfg, hf), aux, None


def block_apply(bp, cfg: ModelConfig, h: torch.Tensor, kind: str,
                is_moe: bool, *, enc_out: Optional[torch.Tensor] = None,
                q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer; returns (h, moe_aux_scalar)."""
    hin = norm_apply(bp["norm1"], cfg, h)
    if kind.startswith("attn"):
        mix = attention_apply(bp["mix"], cfg, hin, kind=kind,
                              q_offset=q_offset)
    elif kind == "rwkv6":
        mix = rwkv6_time_mix(bp["mix"], cfg, hin)
    elif kind == "mamba":
        mix = mamba_apply(bp["mix"], cfg, hin)
    else:
        raise ValueError(kind)
    h = h + mix
    if enc_out is not None and "cross" in bp:
        hx = norm_apply(bp["norm_x"], cfg, h)
        h = h + attention_apply(bp["cross"], cfg, hx, kv_input=enc_out,
                                causal=False)
    hf = norm_apply(bp["norm2"], cfg, h)
    out, aux, _ = ffn_apply(bp, cfg, hf, kind, is_moe)
    return constrain_seq(h + out), aux


# ---------------------------------------------------------------------------
# Whole-model defs
# ---------------------------------------------------------------------------

def _stack_defs(defs, k: int):
    return tree_map(lambda d: ParamDef((k,) + d.shape, (None,) + d.logical,
                                       init=d.init, scale=d.scale), defs)


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    cross = cfg.encoder_layers > 0
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_padded, d), ("tp", "fsdp"), scale=1.0),
        "final_norm": norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((d, cfg.vocab_padded), ("fsdp", "tp"))
    pattern, reps, tail = stack_layout(cfg)
    defs["blocks"] = [
        _stack_defs(block_defs(cfg, kind, moe, cross=cross), reps)
        for kind, moe in pattern]
    defs["tail"] = [block_defs(cfg, kind, moe, cross=cross)
                    for kind, moe in tail]
    if cfg.encoder_layers:
        enc_cfg = dataclasses.replace(cfg, qkv_bias=False)
        enc_block = {
            "norm1": norm_defs(cfg), "mix": attention_defs(enc_cfg),
            "norm2": norm_defs(cfg), "ffn": mlp_defs(cfg),
        }
        defs["encoder"] = {
            "pos": ParamDef((cfg.encoder_seq, d), (None, "fsdp"), scale=0.02),
            "blocks": _stack_defs(enc_block, cfg.encoder_layers),
            "final_norm": norm_defs(cfg),
        }
    return defs


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

# the reference's ``dots_with_no_batch_dims_saveable``: keep the outputs of
# products without batch dims (``x @ W`` reaches aten as ``mm``), recompute
# the rest (attention's and the experts' batched products among them)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) by
    ``cfg.remat`` where grad is enabled: ``"none"`` leaves it as it is,
    ``"full"`` keeps nothing of it for the backward pass but its inputs,
    ``"dots"`` keeps its ``mm`` outputs.  The recompute, which runs during
    ``backward()``, runs under the attention mode of the forward
    (``layers.attention_mode``) and dispatches each MoE call to the
    experts its forward took (``moe.block_routing``), adding nothing to an
    open ``moe.routing_log``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"remat must be none, dots or full, got "
                         f"{cfg.remat!r}")
    extra = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}
        if cfg.remat == "dots" else {})

    def wrapped(*args):
        plain = layers.plain_mode()
        taken: List[torch.Tensor] = []
        forward_done = False

        def run(*inner):
            nonlocal forward_done
            if not forward_done:            # the forward
                forward_done = True
                with moe.block_routing(taken):
                    return fn(*inner)
            with layers.attention_mode(plain), \
                    moe.routing_log(replay=taken):
                return fn(*inner)

        # the block draws no random numbers: no RNG state to restore
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra)

    return wrapped


def unstack(tree, reps: int) -> List[Any]:
    """The ``reps`` repeats of a stacked tree, one ``unbind`` a leaf
    (views): the gradient of a stacked leaf is then one ``stack`` of its
    repeats' gradients, not a leaf-sized zero tensor a repeat."""
    parts = tree_map(lambda x: x.unbind(0), tree, is_tensor)
    return [tree_map(lambda t, r=r: t[r], parts,
                     lambda x: isinstance(x, tuple)) for r in range(reps)]


def layer_slice(tree, r: int):
    """Repeat ``r`` of a stacked tree: every leaf indexed at ``[r]``
    (views, so a cache written through them is written in place)."""
    return tree_map(lambda x: x[r], tree, lambda x: isinstance(
        x, torch.Tensor))


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings (the conv
    frontend is a stub, as in the reference).  frames (B, T, d)."""
    enc = params["encoder"]
    h = constrain(frames + enc["pos"][None, :frames.shape[1]], "batch",
                  None, None)
    enc_cfg = dataclasses.replace(cfg, qkv_bias=False)

    def body(bp, h):
        hin = norm_apply(bp["norm1"], cfg, h)
        h = h + attention_apply(bp["mix"], enc_cfg, hin, causal=False)
        hf = norm_apply(bp["norm2"], cfg, h)
        return h + mlp_apply(bp["ffn"], cfg, hf)

    for bp in unstack(enc["blocks"], cfg.encoder_layers):
        h = remat(functools.partial(body, bp), cfg)(h)
    return norm_apply(enc["final_norm"], cfg, h)


def mesh_embed(table, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup of token ids (B, S) in a DTensor table (vocab, d) on its
    mesh.  The ids are placed as the batch (a plain tensor is the global
    batch, alike on every rank); the table is gathered over the axes that
    shard ``d`` (``fsdp``, as every weight is at its use) and keeps vocab
    over ``model``, where each rank looks up the ids its rows hold and
    zeros the rest: the rows sum over ``model`` (a ``Partial``
    placement), exactly, since one term of each sum is not zero."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    tok_spec = fit_spec(logical_to_spec(("batch", None), mesh),
                        tokens.shape, mesh)
    tok_pl = placements(tok_spec, mesh)
    if is_dtensor(tokens):
        tokens = tokens.redistribute(mesh, tok_pl)
    else:
        tokens = distribute(tokens.to(table.device), mesh, tok_spec)
    tab_spec = fit_spec(logical_to_spec(("tp", None), mesh), table.shape,
                        mesh)
    tab_pl = placements(tab_spec, mesh)
    out_pl, grad_pl = [], []
    for i, name in enumerate(names):
        if isinstance(tok_pl[i], Shard):
            out_pl.append(Shard(0))
            grad_pl.append(Partial())
        elif isinstance(tab_pl[i], Shard):
            out_pl.append(Partial())
            grad_pl.append(Shard(0))
        else:
            out_pl.append(Replicate())
            grad_pl.append(Replicate())
    split = isinstance(tab_pl[names.index("model")], Shard) \
        if "model" in names else False
    rows = table.shape[0] // (mesh_axes(mesh)["model"] if split else 1)
    lo = mesh.get_local_rank("model") * rows if split else 0

    def lookup(tab, ids):
        ids = ids.to(torch.long) - lo
        if not split:
            return tab[ids]
        keep = (ids >= 0) & (ids < rows)
        got = tab[torch.where(keep, ids, torch.zeros_like(ids))]
        return torch.where(keep[..., None], got, torch.zeros_like(got))

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(tuple(grad_pl), tok_pl),
                     device_mesh=mesh, redistribute_inputs=True)(table,
                                                                 tokens)


def embed(params, tokens: torch.Tensor,
          prefix_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (B, S) → embeddings, after an optional modality prefix
    (B, P, d)."""
    table = params["embed"]
    if is_dtensor(table):
        h = mesh_embed(table, tokens)
    else:
        h = table[tokens.to(device=table.device, dtype=torch.long)]
    if prefix_embed is not None:
        h = torch.cat([prefix_embed.to(h.dtype), h], dim=1)
    return h


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embed: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None,
            q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, S) [+ optional modality prefix embeddings (B, P, d)]
    → (hidden states (B, S(+P), d), moe aux loss scalar)."""
    pattern, reps, tail_items = stack_layout(cfg)
    h = constrain_seq(embed(params, tokens, prefix_embed))
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    layers_in_order = [
        (bp_slice[pos], kind, is_moe)
        for bp_slice in unstack(params["blocks"], reps)
        for pos, (kind, is_moe) in enumerate(pattern)]
    layers_in_order += [(bp, kind, is_moe) for bp, (kind, is_moe)
                        in zip(params["tail"], tail_items)]
    for bp, kind, is_moe in layers_in_order:
        block = functools.partial(block_apply, bp, cfg, kind=kind,
                                  is_moe=is_moe, enc_out=enc_out,
                                  q_offset=q_offset)
        h, a = remat(block, cfg)(h)
        aux_total = aux_total + a
    h = norm_apply(params["final_norm"], cfg, h)
    return h, aux_total


def unembed_logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h (..., d) → logits (..., vocab_padded); padding columns (≥ vocab)
    are masked to -1e30."""
    if cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["unembed"]
    if is_dtensor(logits):
        # vocab stays TP-sharded: the padding mask is a where, not a write
        # into a slice of one rank's shard
        if cfg.vocab_padded != cfg.vocab:
            keep = torch.arange(cfg.vocab_padded,
                                device=logits.device) < cfg.vocab
            logits = torch.where(keep, logits, torch.full(
                (), -1e30, dtype=logits.dtype, device=logits.device))
        return constrain(logits, "batch", None, "vocab")
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits
