"""KV caches and recurrent states for LM serving (port of the reference's
``serving/cache.py``).

Cache kinds, chosen per layer from the architecture's schedule:

* **dense**    — (B, KV, S_max, D) k/v for global-attention layers;
* **windowed** — (B, KV, W, D) ring buffer with absolute-position slots
  (``slot_pos``, shared across the batch) for SWA / local-attention layers;
* **recurrent** — Mamba (``conv`` tail + SSM state ``h``) or RWKV-6
  (``shift``, ``wkv`` state, ``cm_shift``): O(1) in sequence length, the
  SSM and WKV states in float32 whatever the cache's dtype.

Caches are built with the same (pattern × repeats) stacking as the model
parameters, on an explicit device; :mod:`repro_torch.serving.engine`
writes them in place.  On a mesh (``init_cache(..., mesh=mesh)``) each
leaf is a DTensor with ``launch.specs.cache_pack``'s placements — a dense
cache's batch over ``data`` and its sequence over ``model`` — and each
rank allocates only its shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import mamba_init_state
from repro_torch.models.rwkv6 import rwkv6_init_state
from repro_torch.models.transformer import stack_layout


def layer_cache_kind(cfg: ModelConfig, kind: str) -> str:
    if kind == "attn":
        return "dense"
    if kind in ("attn_local", "attn_swa"):
        return "windowed"
    return kind                               # mamba | rwkv6


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None) -> Dict[str, Any]:
    device = resolve_device(device)
    ck = layer_cache_kind(cfg, kind)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    if ck == "dense":
        return {"k": torch.zeros((batch, kv, max_seq, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, kv, max_seq, hd), dtype=dtype,
                                 device=device)}
    if ck == "windowed":
        w = min(cfg.local_window, max_seq)
        return {"k": torch.zeros((batch, kv, w, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, kv, w, hd), dtype=dtype,
                                 device=device),
                "slot_pos": torch.full((w,), -1, dtype=torch.int32,
                                       device=device)}
    if ck == "mamba":
        conv, h = mamba_init_state(cfg, batch, dtype, device)
        return {"conv": conv, "h": h}
    if ck == "rwkv6":
        return rwkv6_init_state(cfg, batch, dtype, device)
    raise ValueError(kind)


def cache_logical(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """Logical sharding of each cache leaf (the reference's names)."""
    ck = layer_cache_kind(cfg, kind)
    if ck == "dense":
        return {"k": ("batch", None, "seq", None),
                "v": ("batch", None, "seq", None)}
    if ck == "windowed":
        return {"k": ("batch", None, None, None),
                "v": ("batch", None, None, None),
                "slot_pos": (None,)}
    if ck == "mamba":
        return {"conv": ("batch", None, "tp"), "h": ("batch", "tp", None)}
    if ck == "rwkv6":
        return {"shift": ("batch", None), "wkv": ("batch", None, None, None),
                "cm_shift": ("batch", None)}
    raise ValueError(kind)


@dataclasses.dataclass
class CacheTree:
    """blocks: list (pattern position) of stacked caches (leading repeats
    dim); tail: list of per-layer caches.  Mirrors params structure."""

    blocks: List[Any]
    tail: List[Any]


def _stack(trees: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {key: torch.stack([t[key] for t in trees]) for key in trees[0]}


def _mesh_cache(cfg: ModelConfig, batch: int, max_seq: int,
                dtype: torch.dtype, device: torch.device, mesh,
                seq_all: bool) -> CacheTree:
    from repro_torch.launch.specs import cache_pack
    from repro_torch.parallel.sharding import walk, is_spec, zeros_on
    abstract, specs = cache_pack(cfg, mesh, batch, max_seq, dtype,
                                 seq_all=seq_all)
    leaves = []
    walk(abstract, leaves.append, lambda x: isinstance(x, torch.Tensor))
    it = iter(leaves)

    def make(spec):
        like = next(it)
        leaf = zeros_on(like.shape, spec, mesh, like.dtype, device)
        if like.dtype == torch.int32:       # a ring's empty slots
            leaf.to_local().fill_(-1)
        return leaf

    return walk(specs, make, is_spec)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None, mesh=None, *,
               seq_all: bool = False) -> CacheTree:
    """Zero caches (a ring's slot positions -1).  On ``mesh``: DTensors
    with ``cache_pack``'s placements (``seq_all``: a dense cache's
    sequence over every in-pod axis, for a batch of one)."""
    device = resolve_device(device)
    if mesh is not None:
        return _mesh_cache(cfg, batch, max_seq, dtype, device, mesh,
                           seq_all)
    pattern, reps, tail = stack_layout(cfg)
    blocks = [_stack([init_layer_cache(cfg, kind, batch, max_seq, dtype,
                                       device) for _ in range(reps)])
              for kind, _ in pattern]
    tail_caches = [init_layer_cache(cfg, kind, batch, max_seq, dtype, device)
                   for kind, _ in tail]
    return CacheTree(blocks=blocks, tail=tail_caches)


def cache_logical_tree(cfg: ModelConfig) -> CacheTree:
    pattern, _, tail = stack_layout(cfg)

    def stacked(kind):
        return {key: (None,) + lg
                for key, lg in cache_logical(cfg, kind).items()}

    return CacheTree(blocks=[stacked(kind) for kind, _ in pattern],
                     tail=[cache_logical(cfg, kind) for kind, _ in tail])
