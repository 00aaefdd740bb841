"""Mamba-1 selective-state-space block (for the Jamba hybrid,
arXiv:2403.19887; port of the reference's ``models/mamba.py``).

in_proj → causal depthwise conv → selective scan (data-dependent Δ, B, C)
→ SiLU gate → out_proj.  Prefill runs a **chunked scan**: a log-depth
(Hillis–Steele) scan within each chunk, where the reference takes
``lax.associative_scan``, and the recurrent carry across chunks, so the
live ``(B, L, d_inner, d_state)`` tensor is bounded by the chunk length;
decode is the same call on one token, a single-step state update.

On a mesh (DTensor parameters, the reference's placements) ``d_inner``
is split over ``model`` from the input projection to the output one:
the two halves of ``in_proj`` are separate products
(:func:`_in_proj`), the depthwise conv runs on each rank's channels
(:func:`_conv`), and so does the scan, elementwise in ``d_inner``
(:func:`_scan`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import (fit_spec, is_dtensor,
                                           logical_to_spec, placements)

from .config import ModelConfig
from .layers import constrain
from .params import ParamDef

MAMBA_CHUNK = 128


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    r = _dt_rank(cfg)
    return {
        "in_proj": ParamDef((d, 2 * di), ("fsdp", "tp")),
        "conv_w": ParamDef((di, cfg.mamba_conv), ("tp", None), scale=0.5),
        "conv_b": ParamDef((di,), ("tp",), init="zeros"),
        "x_proj": ParamDef((di, r + 2 * ds), ("tp", None)),
        "dt_w": ParamDef((r, di), (None, "tp")),
        "dt_bias": ParamDef((di,), ("tp",), init="ones"),
        "A_log": ParamDef((di, ds), ("tp", None), init="ones"),
        "D": ParamDef((di,), ("tp",), init="ones"),
        "out_proj": ParamDef((di, d), ("tp", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d in float32.  x (B,S,di); w (di,K); prev
    (B,K-1,di), the left context (zeros when None)."""
    _, s, di = x.shape
    k = w.shape[1]
    pad = (x.new_zeros((x.shape[0], k - 1, di)) if prev is None
           else prev.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                          # (B, S+K-1, di)
    out = F.conv1d(xp.float().transpose(1, 2), w.float()[:, None, :],
                   groups=di).transpose(1, 2)                # (B, S, di)
    return (out + b.float()).to(x.dtype)[:, :s]


def _in_proj(p, x: torch.Tensor, di: int):
    """(x_in, z), each (B, S, di): the two halves of ``x @ in_proj``.  On
    a mesh each half is its own product with ``di`` split over ``model``
    (the weight's columns gathered over ``model`` and each half split
    again: its ``model`` shards hold the halves' columns out of order)."""
    w = p["in_proj"]
    if not is_dtensor(w):
        return torch.chunk(x @ w, 2, dim=-1)
    x = constrain(x, "batch", None, None)
    w = constrain(w, "fsdp", None)
    return [constrain(x @ constrain(half, "fsdp", "tp"), "batch", None,
                      "tp") for half in (w[:, :di], w[:, di:])]


def _conv(x_in: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          prev: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`_causal_conv`; of DTensors, on each rank's batch rows and
    ``di`` channels (a depthwise conv is channel-local) through
    ``local_map``."""
    if not is_dtensor(x_in):
        return _causal_conv(x_in, w, b, prev)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x_in.device_mesh
    spec = lambda lg, t: placements(fit_spec(logical_to_spec(lg, mesh),
                                             t.shape, mesh), mesh)
    x_pl = spec(("batch", None, "tp"), x_in)
    w_pl = spec(("tp", None), w)
    b_pl = spec(("tp",), b)
    rows = [isinstance(pl, Shard) and pl.dim == 0 for pl in x_pl]
    grad = lambda pls: tuple(Partial() if r else pl
                             for r, pl in zip(rows, pls))
    args, ins, grads = [x_in, w, b], [x_pl, w_pl, b_pl], \
        [x_pl, grad(w_pl), grad(b_pl)]
    if prev is not None:
        args.append(prev)
        ins.append(x_pl)
        grads.append(x_pl)

    def local(xl, wl, bl, *pl):
        return _causal_conv(xl, wl, bl, pl[0] if pl else None)

    return local_map(local, out_placements=list(x_pl), in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _ssm_params(p, cfg: ModelConfig, xc: torch.Tensor):
    """xc (B,S,di) → (decay (B,S,di,ds), Bx (B,S,di,ds), C (B,S,ds))."""
    ds = cfg.mamba_d_state
    r = _dt_rank(cfg)
    # summed over the split ``d_inner`` before it is split three ways
    proj = constrain(xc @ p["x_proj"], "batch", None, None)  # (B,S,r+2ds)
    dt, Bc, Cc = torch.split(proj, [r, ds, ds], dim=-1)
    dt = F.softplus((dt @ p["dt_w"] + p["dt_bias"]).float())
    A = -torch.exp(p["A_log"].float())                       # (di, ds)
    decay = torch.exp(dt[..., None] * A[None, None])         # (B,S,di,ds)
    Bx = (dt * xc.float())[..., None] \
        * Bc.float()[:, :, None, :]                          # (B,S,di,ds)
    return decay, Bx, Cc.float()


def _scan_chunk(decay: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = decay_t·h_{t-1} + bx_t along dim 1 of one
    chunk (log-depth: each round combines every element with the one
    ``off`` steps before it); h0 (B,di,ds) carry."""
    d_cum, x_cum = decay, bx
    off, n = 1, decay.shape[1]
    while off < n:
        x_cum = torch.cat([x_cum[:, :off], x_cum[:, off:]
                           + d_cum[:, off:] * x_cum[:, :-off]], dim=1)
        d_cum = torch.cat([d_cum[:, :off],
                           d_cum[:, off:] * d_cum[:, :-off]], dim=1)
        off *= 2
    h = x_cum + d_cum * h0[:, None]                          # inject carry
    return h, h[:, -1]


def _scan_local(decay, bx, cc, dd, xc, h_prev, chunk: int):
    """The chunked scan and its read-out: (y (B,S,di) f32, the last state
    (B,di,ds)); zeros for a missing ``h_prev``."""
    b, s, di, ds = decay.shape
    if h_prev is None:
        h_prev = torch.zeros((b, di, ds), dtype=torch.float32,
                             device=decay.device)
    h0 = h_prev.float()
    ys = []
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        hh, h0 = _scan_chunk(decay[:, sl], bx[:, sl], h0)
        y = torch.einsum("blds,bls->bld", hh, cc[:, sl])     # (B,L,di)
        ys.append(y + dd * xc[:, sl].float())
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y, h0


def _scan(decay, bx, cc, dd, xc, h_prev, chunk: int):
    """:func:`_scan_local`; of DTensors, on each rank's batch rows and
    ``d_inner`` channels through ``local_map`` (the scan is elementwise
    in ``d_inner``; as DTensor ops its chunk loop would be thousands of
    sharded ops a layer)."""
    if not is_dtensor(decay):
        return _scan_local(decay, bx, cc, dd, xc, h_prev, chunk)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = decay.device_mesh
    names = mesh.mesh_dim_names
    rows = [isinstance(pl, Shard) and pl.dim == 0 for pl in decay.placements]
    di = decay.shape[2]
    split = "model" in names and di % mesh.size(names.index("model")) == 0

    def place(channel_dim):
        return tuple(Shard(0) if row else
                     Shard(channel_dim) if split and n == "model" and
                     channel_dim is not None else Replicate()
                     for row, n in zip(rows, names))

    bl_pl, c_pl, x_pl, h_pl = place(2), place(None), place(2), place(1)
    d_pl = tuple(Shard(0) if split and n == "model" else Replicate()
                 for n in names)
    c_grad = tuple(Partial() if split and n == "model" else pl
                   for n, pl in zip(names, c_pl))
    d_grad = tuple(Partial() if row else pl for row, pl in zip(rows, d_pl))
    args = [decay, bx, cc, dd, xc]
    ins = [bl_pl, bl_pl, c_pl, d_pl, x_pl]
    grads = [bl_pl, bl_pl, c_grad, d_grad, x_pl]
    if h_prev is not None:
        args.append(h_prev)
        ins.append(h_pl)
        grads.append(h_pl)

    def local(dl, bl, cl, ddl, xl, *hl):
        return _scan_local(dl, bl, cl, ddl, xl, hl[0] if hl else None,
                           chunk)

    return local_map(local, out_placements=(x_pl, h_pl), in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def mamba_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_state: bool = False):
    """x (B,S,d) → (B,S,d).  state = (conv_tail (B,K-1,di), h (B,di,ds)).
    S must be a multiple of ``MAMBA_CHUNK``, or at most one chunk."""
    b, s, d = x.shape
    di = cfg.mamba_expand * d
    conv_prev, h_prev = (None, None) if state is None else state

    x_in, z = _in_proj(p, x, di)
    xc = F.silu(_conv(x_in, p["conv_w"], p["conv_b"], conv_prev)
                .float()).to(x.dtype)

    decay, bx, cc = _ssm_params(p, cfg, xc)

    chunk = min(MAMBA_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"scan chunk {chunk}")
    y, h0 = _scan(decay, bx, cc, p["D"].float(), xc, h_prev, chunk)
    y = (y * F.silu(z.float())).to(x.dtype)
    out = constrain(y @ p["out_proj"], "batch", None, None)
    if return_state:
        k = cfg.mamba_conv
        prev = (x_in.new_zeros((b, k - 1, di)) if conv_prev is None
                else conv_prev.to(x_in.dtype))
        conv_tail = torch.cat([prev, x_in], 1)[:, -(k - 1):]
        return out, (conv_tail, h0)
    return out


def mamba_decode_step(p, cfg: ModelConfig, x: torch.Tensor,
                      state: Tuple[torch.Tensor, torch.Tensor]):
    """Single token: x (B, d) + (conv_tail, h) → (out (B, d), new state)."""
    out, new_state = mamba_apply(p, cfg, x[:, None], state=state,
                                 return_state=True)
    return out[:, 0], new_state


def mamba_init_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero (conv tail in ``dtype``, SSM state ``h`` in float32 whatever
    ``dtype`` is)."""
    device = resolve_device(device)
    di = cfg.mamba_expand * cfg.d_model
    return (torch.zeros((batch, cfg.mamba_conv - 1, di), dtype=dtype,
                        device=device),
            torch.zeros((batch, di, cfg.mamba_d_state), dtype=torch.float32,
                        device=device))
