"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch (port
of the reference's ``models/moe.py``).

Tokens are reshaped to (G, T/G) groups; every routing, cumsum, gather and
scatter step runs per group.  G is the reference's: 1 on one device and
below 4096 tokens, else the mesh's batch-sharding extent, each rank
routing its own group (:func:`_mesh_moe`).

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

from repro_torch.parallel.sharding import is_dtensor

from .config import ModelConfig, MoEConfig
from .layers import constrain
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


def _n_groups(t: int, mesh=None) -> int:
    """Dispatch groups for ``t`` tokens: 1 on one device, or for fewer
    than 4096 tokens; on a mesh the extent of its (pod, data) axes that
    divides ``t`` (the reference's rule)."""
    if mesh is None or t < 4096:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    g = 1
    for a in ("pod", "data"):
        if a in sizes and t % (g * sizes[a]) == 0:
            g *= sizes[a]
    return g


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


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(ids, n)`` as a comparison (int64): ``F.one_hot`` on
    CPU tensors reads their min and max back to check the range, a host
    read in the middle of a step."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def _capacity(tg: int, m: MoEConfig) -> int:
    return int(tg * m.top_k * m.capacity_factor / m.n_experts) or 1


def _dispatch(xt: torch.Tensor, router: torch.Tensor, m: MoEConfig,
              capacity: int):
    """Route the groups xt (G, tg, d) and gather each expert's slots:
    (xe (G, E, C, d), slot token index (G, E·C), slot gates (G, E, C),
    router logits (G, tg, E) f32, probs, expert ids (G, tg, k))."""
    n_g, tg, d = xt.shape
    e, k = m.n_experts, m.top_k
    dev = xt.device
    logits = (xt @ router.to(xt.dtype)).float()
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

    # ---- slot assignment, per group (slot-major priority) ----
    flat_expert = expert_ids.transpose(1, 2).reshape(n_g, -1)  # (G, k·tg)
    # the one-hot cumsum along the assignments, taken as (G, E, k·tg) so
    # that the scan runs along the innermost dim (an outer-dim scan of
    # (k·tg, E) took 60 % of moonshot's prefill on the card)
    onehot = _one_hot(flat_expert, e).transpose(1, 2).contiguous()
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
    # 0-d tensors, not Python numbers: a number is lifted to a tensor by
    # other ops on the CPU than on other devices
    idx[dropped_at] = torch.full((), tg, dtype=torch.long, device=dev)
    gates[dropped_at] = torch.zeros((), dtype=torch.float32, device=dev)
    idx, gates = idx[..., :capacity], gates[..., :capacity]

    # ---- dispatch ----
    xt_pad = torch.cat([xt, xt.new_zeros((n_g, 1, d))], 1)
    flat_idx = idx.reshape(n_g, -1)
    xe = torch.gather(xt_pad, 1, flat_idx[..., None].expand(-1, -1, d)
                      ).reshape(n_g, e, capacity, d)
    return xe, flat_idx, gates, logits, probs, expert_ids


def _combine(ye: torch.Tensor, flat_idx: torch.Tensor, gates: torch.Tensor,
             tg: int) -> torch.Tensor:
    """Scatter-add each slot's output (G, E, C, d), weighted by its gate,
    back to its token: (G, tg, d)."""
    n_g, d = ye.shape[0], ye.shape[-1]
    ye = ye * gates[..., None].to(ye.dtype)
    out = ye.new_zeros((n_g, tg + 1, d))
    for g in range(n_g):
        out[g].index_add_(0, flat_idx[g], ye[g].reshape(-1, d))
    return out[:, :tg]


def _shared_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = F.silu if cfg.act == "swiglu" else _gelu
    if "shared_wg" in p:
        h = act(x @ p["shared_wg"]) * (x @ p["shared_wu"])
    else:
        h = act(x @ p["shared_wu"])
    return h @ p["shared_wd"]


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) → (same shape, aux-loss dict)."""
    if is_dtensor(x):
        return _mesh_moe(p, cfg, x, capacity)
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    n_g = _n_groups(t)
    tg = t // n_g                                            # tokens/group
    e = m.n_experts
    xt = x.reshape(n_g, tg, d)
    if capacity is None:
        capacity = _capacity(tg, m)
    xe, flat_idx, gates, logits, probs, expert_ids = _dispatch(
        xt, p["router"], m, capacity)
    out = _combine(_expert_ffn(p, cfg, xe), flat_idx, gates, tg)
    if m.n_shared_experts:
        out = out + _shared_ffn(p, cfg, xt)

    # ---- aux losses (means over every group) ----
    density = _one_hot(expert_ids[..., 0], e).float().mean((0, 1))
    router_prob = probs.mean((0, 1))
    aux = {
        "load_balance": (e * torch.sum(density * router_prob)).float(),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2).float(),
    }
    return out.reshape(b, s, d).to(x.dtype), aux


def _mesh_moe(p, cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int]):
    """:func:`moe_apply` of a DTensor x (B, S, d) on its mesh.

    Groups are the reference's: one a batch shard for 4096 tokens or
    more (each rank routes, dispatches and combines its own rows), else
    one over every token (x gathered; each rank routes all of them).  The
    routing and the slot gather, and the weighted scatter back, run on
    each rank's local group through ``local_map``; the expert FFN is
    tensor-parallel over ``model`` on ``d_ff`` (:func:`_fsdp_experts`
    for a group a rank, :func:`_split_d_experts` for the one group every
    rank holds).  The aux losses are means over the groups, summed over
    the batch shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    m: MoEConfig = cfg.moe
    e = m.n_experts
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    b, s, d = x.shape
    t = b * s
    n_g = _n_groups(t, mesh)
    x = constrain(x, "batch", None, None)
    batch_dims = [i for i, pl in enumerate(x.placements)
                  if isinstance(pl, Shard) and pl.dim == 0]
    ext = 1
    for i in batch_dims:
        ext *= mesh.size(i)
    if n_g == 1:
        batch_dims, ext = [], 1
    elif n_g != ext:
        raise NotImplementedError(f"{n_g} dispatch groups over a batch "
                                  f"split {ext} ways")
    tg = t // n_g
    if capacity is None:
        capacity = _capacity(tg, m)
    rep = tuple(Replicate() for _ in names)
    grp = tuple(Shard(0) if i in batch_dims else Replicate()
                for i in range(len(names)))
    summed = tuple(Partial() if i in batch_dims else Replicate()
                   for i in range(len(names)))
    inv = 1.0 / ext

    def route(xl, router):
        xe, flat_idx, gates, logits, probs, expert_ids = _dispatch(
            xl.reshape(1, -1, d), router, m, capacity)
        density = _one_hot(expert_ids[..., 0], e).float().mean((0, 1))
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2).float()
        return (xe, flat_idx, gates, density * inv, probs.mean((0, 1)) * inv,
                z * inv)

    xe, flat_idx, gates, density, router_prob, z = local_map(
        route, out_placements=(grp, grp, grp, summed, summed, summed),
        in_placements=(grp, rep), in_grad_placements=(grp, summed),
        device_mesh=mesh, redistribute_inputs=True)(x, p["router"])

    if n_g == 1:
        ye = _split_d_experts(p, cfg, xe)
    else:
        ye = _fsdp_experts(p, cfg, xe, grp, summed, batch_dims)

    def combine(ye_l, idx_l, gates_l):
        return _combine(ye_l, idx_l, gates_l, tg).reshape(-1, s, d)

    out = local_map(combine, out_placements=list(grp),
                    in_placements=(grp, grp, grp),
                    in_grad_placements=(grp, grp, grp), device_mesh=mesh,
                    redistribute_inputs=True)(ye, flat_idx, gates)
    if m.n_shared_experts:
        out = out + _shared_ffn(p, cfg, x)
    aux = {"load_balance": (e * torch.sum(density * router_prob)).float(),
           "router_z": z}
    return constrain(out, "batch", None, None).to(x.dtype), aux


def _split_d_experts(p, cfg: ModelConfig, xe):
    """The expert FFN of one group that every rank holds: the slots'
    ``d`` split as the weights' ``d`` is (over ``data``), so each product
    contracts or makes its rank's part of ``d`` against the weights' own
    shards (DTensor's products: partial sums over ``data`` reduced before
    the activation, the output ``d`` split) — no expert weight is
    gathered."""
    from torch.distributed.tensor import Shard
    w = p["wd"]
    places = [Shard(3) if isinstance(pl, Shard) and pl.dim == 2 else pl
              for pl in w.placements]
    places = [pl if isinstance(pl, Shard) else xe.placements[i]
              for i, pl in enumerate(places)]
    places = [Shard(3) if pl == Shard(3) else xe.placements[i]
              for i, pl in enumerate(places)]
    return _expert_ffn(p, cfg, xe.redistribute(xe.device_mesh, places))


def _fsdp_experts(p, cfg: ModelConfig, xe, grp, summed, batch_dims):
    """The expert FFN of each rank's own group, on local tensors: the
    weights gathered over the batch axes (FSDP) and split over ``model``
    on ``d_ff``; the output a partial sum over ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xe.device_mesh
    names = mesh.mesh_dim_names
    rep = tuple(Replicate() for _ in names)

    def on_model(pl, base=rep):
        return tuple(pl if n == "model" else base[i]
                     for i, n in enumerate(names))

    up = [k for k in ("wg", "wu") if k in p]

    def experts(xe_l, *ws):
        return _expert_ffn(dict(zip(up + ["wd"], ws)), cfg, xe_l)

    col, row = on_model(Shard(2)), on_model(Shard(1))
    w_grad = lambda pl: tuple(summed[i] if i in batch_dims else pl[i]
                              for i in range(len(names)))
    return local_map(
        experts, out_placements=list(on_model(Partial(), grp)),
        in_placements=(grp,) + (col,) * len(up) + (row,),
        in_grad_placements=(on_model(Partial(), grp),)
        + (w_grad(col),) * len(up) + (w_grad(row),),
        device_mesh=mesh, redistribute_inputs=True)(
            xe, *(p[k] for k in up), p["wd"])
