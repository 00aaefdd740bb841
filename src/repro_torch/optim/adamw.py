"""AdamW with float32 or block-wise 8-bit moments (port of the reference's
``optim/adamw.py``).

8-bit moments are stored int8 with one float32 absmax scale per
256-element block along the last axis, on a power-law code (power 2 for
the first moment, 4 for the second), rounded half to even as
``jnp.round`` rounds.  State mirrors the parameter tree: ``AdamWState``
holds the step and two trees of moments, each leaf a float32 tensor or a
:class:`Moment8`.

:func:`apply_updates` works leaf by leaf in float32 under
``torch.no_grad()`` with the reference's operations in the reference's
order.  It writes the new parameters and moments into the tensors it is
given and returns the same trees: a leaf is taken ``UPDATE_CHUNK``
values (whole rows of its last axis) at a time, so the float32
temporaries of the largest leaf (a stacked expert leaf is 1.6 B values
in mixtral-8x22b) are never held at once beside the parameters,
gradients and moments.

On a mesh the leaves are DTensors, and the moments take their
parameter's placements (an 8-bit moment's block scales those of
``launch.specs._moment_spec``).  The update is elementwise, so it runs on
each rank's local shards, ``UPDATE_CHUNK`` rows of the shard at a time.
Two parts are not local: the global norm counts every element once — a
rank adds a leaf's local sum of squares only where it holds the first
copy of each replicated shard, and one all-reduce a mesh dim sums them —
and an 8-bit moment whose 256-value blocks cross its shards' edges (a
last dim sharded where the scales are not) is updated on that dim
gathered, then its own shard taken back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import (is_tensor, tensors, tree_items,
                                       tree_map)
from repro_torch.parallel.sharding import (fit_spec, is_dtensor, spec_of,
                                           zeros_on)

BLOCK = 256
# values of a leaf updated at once (whole rows of its leading axis): the
# update's float32 temporaries stay a few of these, not a few leaves
UPDATE_CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    eightbit: bool = False
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32 on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


# ---------------------------------------------------------------------------
# Block-wise int8 moment quantisation
# ---------------------------------------------------------------------------

def scale_blocks(last: int) -> int:
    return -(-last // BLOCK)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """(..., L) → (..., L/BLOCK, BLOCK), zero-padded along the last axis."""
    last = x.shape[-1]
    nb = scale_blocks(last)
    xp = torch.nn.functional.pad(x, (0, nb * BLOCK - last))
    return xp.reshape(x.shape[:-1] + (nb, BLOCK))


def _q8(x: torch.Tensor, power: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., L) float32 → (int8 (..., L), float32 scales (..., L/BLOCK)):
    value = sign·(|q|/127)^power·scale."""
    last = x.shape[-1]
    xp = _blocks(x)
    scale = torch.amax(torch.abs(xp), dim=-1) / (127.0 ** power)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    mag = (torch.abs(xp) / safe[..., None]) ** (1.0 / power)
    q = (torch.sign(xp) * torch.clamp(torch.round(mag), 0, 127)).to(
        torch.int8)
    q = q.reshape(x.shape[:-1] + (-1,))[..., :last]
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, power: int = 2
         ) -> torch.Tensor:
    last = q.shape[-1]
    qp = _blocks(q).to(torch.float32)
    mag = torch.abs(qp)
    mag = mag * mag if power == 2 else (mag * mag) * (mag * mag)
    out = torch.sign(qp) * mag * scale[..., None]
    return out.reshape(q.shape[:-1] + (-1,))[..., :last]


class Moment8(NamedTuple):
    q: torch.Tensor        # int8, parameter-shaped
    scale: torch.Tensor    # float32, (..., last/BLOCK)


def _is_moment(x) -> bool:
    return isinstance(x, (torch.Tensor, Moment8))


def _moments(tree) -> List[Any]:
    return [m for _, m in tree_items(tree, _is_moment)]


def _scale_spec(p: torch.Tensor):
    """The spec of a DTensor parameter's 8-bit block scales."""
    shape = tuple(p.shape[:-1]) + (scale_blocks(p.shape[-1]),)
    return shape, fit_spec(spec_of(p), shape, p.device_mesh)


def _zeros_moment(p: torch.Tensor, eightbit: bool):
    if is_dtensor(p):
        if not eightbit:
            return torch.zeros_like(p, dtype=torch.float32)
        shape, spec = _scale_spec(p)
        return Moment8(torch.zeros_like(p, dtype=torch.int8),
                       zeros_on(shape, spec, p.device_mesh, torch.float32,
                                p.to_local().device))
    if not eightbit:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return Moment8(torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                   torch.zeros(p.shape[:-1] + (scale_blocks(p.shape[-1]),),
                               dtype=torch.float32, device=p.device))


def _read_moment(m, power: int) -> torch.Tensor:
    if isinstance(m, Moment8):
        return _dq8(m.q, m.scale, power)
    return m


def _write_moment(dst, val: torch.Tensor, power: int) -> None:
    if isinstance(dst, Moment8):
        q, s = _q8(val, power)
        dst.q.copy_(q)
        dst.scale.copy_(s)
    else:
        dst.copy_(val)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def init(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments beside each parameter, on its device."""
    leaves = [_local(p) for p in tensors(params)]
    device = leaves[0].device if leaves else torch.device("cpu")
    mk = lambda p: _zeros_moment(p, cfg.eightbit)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(mk, params, is_tensor),
                      nu=tree_map(mk, params, is_tensor))


def _rows(shape: Tuple[int, ...]) -> List[slice]:
    """Slices of the leading axis of ``UPDATE_CHUNK`` values or fewer (a
    1-D leaf in one piece: its last axis carries the 8-bit blocks)."""
    if len(shape) < 2:
        return [slice(None)]
    per_row = int(np.prod(shape[1:]))
    step = max(1, UPDATE_CHUNK // max(1, per_row))
    return [slice(lo, lo + step) for lo in range(0, shape[0], step)]


def _fold(x):
    """``x`` (a tensor or a :class:`Moment8`) with every axis but the last
    folded into its leading one, a view: the rows of ``_rows`` are then
    last-axis rows, whatever the leaf's stacking (a stacked expert leaf
    (L, E, d, f) has rows of E·d·f values).  The 8-bit blocks lie along
    the last axis, so the update is the same.  Left as it is where it has
    two axes or fewer or is not contiguous."""
    if isinstance(x, Moment8):
        return Moment8(_fold(x.q), _fold(x.scale))
    if x.dim() <= 2 or not x.is_contiguous():
        return x
    return x.view(-1, x.shape[-1])


def _foldable(*xs) -> bool:
    parts = [t for x in xs for t in (x if isinstance(x, Moment8) else (x,))]
    return all(t.dim() > 2 and t.is_contiguous() for t in parts)


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def _first_copy(x) -> bool:
    """True where this rank holds the first copy of its shard of ``x``:
    coordinate 0 on every mesh dim that does not shard it."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    return all(isinstance(pl, Shard) or mesh.get_local_rank(i) == 0
               for i, pl in enumerate(x.placements))


def global_norm(tree) -> torch.Tensor:
    """√(Σ g²) over every leaf in float32, a leaf ``UPDATE_CHUNK`` values
    at a time (no leaf-sized square is held).  DTensor leaves count each
    element once: local sums where this rank holds the first copy, summed
    over the mesh."""
    total = 0
    mesh = device = None
    for g in tensors(tree):
        if is_dtensor(g):
            mesh = g.device_mesh
            device = g.to_local().device
            if not _first_copy(g):
                continue
            g = g.to_local()
        g = _fold(g)
        for sl in _rows(tuple(g.shape)):
            total = total + torch.sum(torch.square(g[sl].to(torch.float32)))
    total = torch.as_tensor(total, dtype=torch.float32)
    if mesh is not None:
        # the shards' device: a card, the CPU, or ``meta`` in a dry run
        total = total.to(device)
        for i in range(mesh.ndim):
            if mesh.size(i) > 1:
                dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


def _crosses_blocks(p, mu) -> bool:
    """True where an 8-bit moment's blocks cross its shards' edges."""
    from torch.distributed.tensor import Shard
    if not (is_dtensor(p) and isinstance(mu, Moment8)):
        return False
    last = p.ndim - 1
    for pl, spl in zip(p.placements, mu.scale.placements):
        if isinstance(pl, Shard) and pl.dim == last:
            if spl != pl:
                return True
    return p.to_local().shape[-1] % BLOCK != 0 and any(
        isinstance(pl, Shard) and pl.dim == last for pl in p.placements)


def _gathered_last(x):
    """A DTensor with its last dim gathered (its other shards kept)."""
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
        for pl in x.placements])


def _take_back(dst, full) -> None:
    """Write this rank's shard of ``full`` (``dst`` with its last dim
    gathered) into ``dst``'s local tensor."""
    from torch.distributed.tensor import DTensor
    whole = DTensor.from_local(full, dst.device_mesh,
                               _gathered_last(dst).placements,
                               shape=dst.shape, stride=dst.stride())
    dst.to_local().copy_(whole.redistribute(dst.device_mesh,
                                            dst.placements).to_local())


def _at(m, sl: slice):
    return Moment8(m.q[sl], m.scale[sl]) if isinstance(m, Moment8) else m[sl]


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and the moments of ``state`` are written
    in place and returned with the new step; metrics ``grad_norm`` and
    ``lr`` stay on the device."""
    step = state.step + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full((), cfg.b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.full((), cfg.b2, device=t.device), t)

    def leaf(p, g, mu, nu):
        g = g.to(torch.float32) * clip
        m = cfg.b1 * _read_moment(mu, 2) + (1 - cfg.b1) * g
        v = cfg.b2 * _read_moment(nu, 4) + (1 - cfg.b2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if p.dim() >= 2:
            update = update + cfg.weight_decay * pf
        p.copy_((pf - lr * update).to(p.dtype))
        _write_moment(mu, m, 2)
        _write_moment(nu, v, 4)

    flat_p = tensors(params)
    flat_g = tensors(grads)
    flat_mu = _moments(state.mu)
    flat_nu = _moments(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError(f"{len(flat_p)} parameters, {len(flat_g)} "
                         f"gradients, {len(flat_mu)} and {len(flat_nu)} "
                         f"moments")
    for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu):
        if _crosses_blocks(p, mu):
            gathered = [_gathered_last(x).to_local()
                        for x in (p, g, mu.q, nu.q)]
            pl, gl, mq, nq = gathered
            # the block scales with their last dim whole too, where it is
            # sharded: the blocks of the gathered rows are all here
            ms, ns = (_gathered_last(x).to_local()
                      for x in (mu.scale, nu.scale))
            mu_l, nu_l = Moment8(mq, ms), Moment8(nq, ns)
            for sl in _rows(tuple(pl.shape)):
                leaf(pl[sl], gl[sl], _at(mu_l, sl), _at(nu_l, sl))
            for dst, full in ((p, pl), (mu.q, mq), (nu.q, nq),
                              (mu.scale, ms), (nu.scale, ns)):
                _take_back(dst, full)
            continue
        p, g = _local(p), _local(g)
        mu = (Moment8(_local(mu.q), _local(mu.scale))
              if isinstance(mu, Moment8) else _local(mu))
        nu = (Moment8(_local(nu.q), _local(nu.scale))
              if isinstance(nu, Moment8) else _local(nu))
        if _foldable(p, g, mu, nu):
            p, g, mu, nu = (_fold(x) for x in (p, g, mu, nu))
        for sl in _rows(tuple(p.shape)):
            leaf(p[sl], g[sl], _at(mu, sl), _at(nu, sl))
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}


def state_from_numpy(state, *, device: DeviceLike = None) -> AdamWState:
    """The reference's ``AdamWState`` as numpy (its moment leaves arrays or
    ``Moment8`` pairs of arrays) → the port's, on ``device`` (the card
    unless named), each leaf in its own dtype."""
    device = resolve_device(device)
    carry = lambda a: torch.from_numpy(np.array(a)).to(device)

    def moment(m):
        if hasattr(m, "q") and hasattr(m, "scale"):
            return Moment8(carry(m.q), carry(m.scale))
        return carry(m)

    is_leaf = lambda x: isinstance(x, np.ndarray) or (
        hasattr(x, "q") and hasattr(x, "scale"))
    step, mu, nu = state
    return AdamWState(carry(step), tree_map(moment, mu, is_leaf),
                      tree_map(moment, nu, is_leaf))
