"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch (port
of the reference's ``models/moe.py``).

Tokens are reshaped to (G, T/G) groups; every routing, cumsum, gather and
scatter step runs per group.  The reference takes G from the mesh's
batch-sharding extent; the port runs on one device, so G is 1
(:func:`_n_groups` keeps the seat for a sharded slice).

Per group:
  1. router: top-k softmax gates per token (ties go to the lower expert
     index, as ``jax.lax.top_k`` breaks them);
  2. slot assignment: position-in-expert via cumsum over the flattened
     (slot-major) assignment list — first-choice assignments win capacity;
  3. gather ``x[idx]`` → (E, C, d); batched expert FFN ``gecd,edf->gecf``;
     scatter-add back with the gate weights.

Tokens beyond an expert's capacity are dropped.  The reference writes each
dropped assignment to its expert's last slot (``capacity - 1``) with the
pad row and gate 0, after the kept ones, so an expert that overflows also
loses the token it kept in that slot (XLA's in-order scatter); the port
makes the same two writes in the same order.  Aux losses: Switch-style
load balance + router z-loss.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .params import ParamDef


_ROUTES = contextvars.ContextVar("moe_routes", default=None)


@contextlib.contextmanager
def routing_log(replay: Optional[List[torch.Tensor]] = None
                ) -> Iterator[List[torch.Tensor]]:
    """Inside this scope every :func:`moe_apply` call appends the experts
    its router picks, (G, tokens, k), to the list this yields.  With
    ``replay`` (the list of an earlier scope), call i dispatches to
    ``replay[i]``'s experts instead, gated by its own router
    probabilities: the card's kernel-against-plain comparisons run the
    plain path on the kernel path's routing, so that a near-tie that bf16
    rounding flips does not hide the difference they measure (the flips
    are counted from the two logs)."""
    log: List[torch.Tensor] = []
    token = _ROUTES.set((log, replay))
    try:
        yield log
    finally:
        _ROUTES.reset(token)


@contextlib.contextmanager
def block_routing(taken: List[torch.Tensor]) -> Iterator[None]:
    """The forward of a checkpointed block: inside this scope every
    :func:`moe_apply` call routes as it would outside it (logged to an open
    :func:`routing_log`, replaying its ``replay``), and ``taken`` receives
    the experts each call dispatched to.  The block's recompute runs inside
    ``routing_log(replay=taken)``: the same dispatch, and nothing added to
    the outer log a second time."""
    outer = _ROUTES.get()
    log: List[torch.Tensor] = []
    replay = None
    if outer is not None and outer[1] is not None:
        replay = outer[1][len(outer[0]):]
    token = _ROUTES.set((log, replay))
    try:
        yield
    finally:
        _ROUTES.reset(token)
        if outer is not None:
            outer[0].extend(log)
        taken.extend(log if replay is None else replay[:len(log)])


def moe_defs(cfg: ModelConfig, *, expert_parallel: bool = False
             ) -> Dict[str, ParamDef]:
    d = cfg.d_model
    m = cfg.moe
    e_ax = "expert" if expert_parallel else None
    defs: Dict[str, ParamDef] = {
        "router": ParamDef((d, m.n_experts), (None, None), scale=0.02),
    }
    ff = m.d_ff_expert
    if cfg.act in ("swiglu", "geglu"):
        defs["wg"] = ParamDef((m.n_experts, d, ff), (e_ax, "fsdp", "tp"))
        defs["wu"] = ParamDef((m.n_experts, d, ff), (e_ax, "fsdp", "tp"))
    else:
        defs["wu"] = ParamDef((m.n_experts, d, ff), (e_ax, "fsdp", "tp"))
    defs["wd"] = ParamDef((m.n_experts, ff, d), (e_ax, "tp", "fsdp"))
    if m.n_shared_experts:
        sff = ff * m.n_shared_experts
        defs["shared_wg"] = ParamDef((d, sff), ("fsdp", "tp"))
        defs["shared_wu"] = ParamDef((d, sff), ("fsdp", "tp"))
        defs["shared_wd"] = ParamDef((sff, d), ("tp", "fsdp"))
    return defs


def _n_groups(t: int) -> int:
    """Dispatch groups for ``t`` tokens: the batch-sharding extent of the
    mesh in the reference; 1 on one device."""
    return 1


def _gelu(t: torch.Tensor) -> torch.Tensor:
    return F.gelu(t, approximate="tanh")


def _expert_ffn(p, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """Batched expert FFN: xe (G, E, C, d) → (G, E, C, d)."""
    if cfg.act in ("swiglu", "geglu"):
        g = torch.einsum("gecd,edf->gecf", xe, p["wg"])
        u = torch.einsum("gecd,edf->gecf", xe, p["wu"])
        act = F.silu if cfg.act == "swiglu" else _gelu
        h = act(g) * u
    elif cfg.act == "sq_relu":
        r = torch.clamp(torch.einsum("gecd,edf->gecf", xe, p["wu"]), min=0)
        h = r * r
    else:
        h = _gelu(torch.einsum("gecd,edf->gecf", xe, p["wu"]))
    return torch.einsum("gecf,efd->gecd", h, p["wd"])


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dim and their indices, equal
    values in ascending index order (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) → (same shape, aux-loss dict)."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    n_g = _n_groups(t)
    tg = t // n_g                                            # tokens/group
    e, k = m.n_experts, m.top_k
    dev = x.device
    xt = x.reshape(n_g, tg, d)

    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                    # (G, tg, E)
    _, expert_ids = top_k(probs, k)                          # (G, tg, k)
    routes = _ROUTES.get()
    if routes is not None:
        log, replay = routes
        log.append(expert_ids)
        if replay is not None:
            expert_ids = replay[len(log) - 1]
    # the top-k values, read back at the experts dispatched to: the same
    # operations whether the experts were picked or replayed (a
    # checkpointed block's recompute replays its forward's)
    gate_vals = torch.gather(probs, -1, expert_ids)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    if capacity is None:
        capacity = int(tg * k * m.capacity_factor / e) or 1

    # ---- slot assignment, per group (slot-major priority) ----
    flat_expert = expert_ids.transpose(1, 2).reshape(n_g, -1)  # (G, k·tg)
    # the one-hot cumsum along the assignments, taken as (G, E, k·tg) so
    # that the scan runs along the innermost dim (an outer-dim scan of
    # (k·tg, E) took 60 % of moonshot's prefill on the card)
    onehot = F.one_hot(flat_expert, e).transpose(1, 2).contiguous()
    slot = torch.cumsum(onehot, dim=2) - 1                   # (G, E, k·tg)
    flat_slot = torch.gather(slot, 1, flat_expert[:, None, :])[:, 0]
    keep = flat_slot < capacity
    flat_token = torch.arange(tg, device=dev).repeat(n_g, k)
    flat_gate = gate_vals.transpose(1, 2).reshape(n_g, -1) * keep

    # ---- index buffer (G, E, C): which local token feeds each slot ----
    # the reference's one scatter in its order: each kept assignment to
    # its slot, then each dropped one to slot capacity - 1 (pad row, gate
    # 0).  Writes a pass skips go to a spare slot C, cut off after, so no
    # mask is read back to the host.
    gidx = torch.arange(n_g, device=dev)[:, None].expand_as(flat_expert)
    idx = torch.full((n_g, e, capacity + 1), tg, dtype=torch.long,
                     device=dev)
    gates = torch.zeros((n_g, e, capacity + 1), dtype=torch.float32,
                        device=dev)
    spare = torch.full_like(flat_slot, capacity)
    kept_at = (gidx, flat_expert, torch.where(keep, flat_slot, spare))
    idx[kept_at] = flat_token
    gates[kept_at] = flat_gate
    dropped_at = (gidx, flat_expert, torch.where(keep, spare, spare - 1))
    idx[dropped_at] = tg
    gates[dropped_at] = 0.0
    idx, gates = idx[..., :capacity], gates[..., :capacity]

    # ---- dispatch / expert FFN / combine ----
    xt_pad = torch.cat([xt, xt.new_zeros((n_g, 1, d))], 1)
    flat_idx = idx.reshape(n_g, -1)
    xe = torch.gather(xt_pad, 1, flat_idx[..., None].expand(-1, -1, d)
                      ).reshape(n_g, e, capacity, d)
    ye = _expert_ffn(p, cfg, xe)
    ye = ye * gates[..., None].to(ye.dtype)
    out = ye.new_zeros((n_g, tg + 1, d))
    for g in range(n_g):
        out[g].index_add_(0, flat_idx[g], ye[g].reshape(-1, d))
    out = out[:, :tg]

    if m.n_shared_experts:
        act = F.silu if cfg.act == "swiglu" else _gelu
        if "shared_wg" in p:
            h = act(xt @ p["shared_wg"]) * (xt @ p["shared_wu"])
        else:
            h = act(xt @ p["shared_wu"])
        out = out + h @ p["shared_wd"]

    # ---- aux losses (means over every group) ----
    density = F.one_hot(expert_ids[..., 0], e).float().mean((0, 1))
    router_prob = probs.mean((0, 1))
    aux = {
        "load_balance": (e * torch.sum(density * router_prob)).float(),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2).float(),
    }
    return out.reshape(b, s, d).to(x.dtype), aux
