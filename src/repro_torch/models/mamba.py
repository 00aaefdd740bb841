"""Mamba-1 selective-state-space block (for the Jamba hybrid,
arXiv:2403.19887; port of the reference's ``models/mamba.py``).

in_proj → causal depthwise conv → selective scan (data-dependent Δ, B, C)
→ SiLU gate → out_proj.  Prefill runs a **chunked scan**: a log-depth
(Hillis–Steele) scan within each chunk, where the reference takes
``lax.associative_scan``, and the recurrent carry across chunks, so the
live ``(B, L, d_inner, d_state)`` tensor is bounded by the chunk length;
decode is the same call on one token, a single-step state update.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device

from .config import ModelConfig
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


def _ssm_params(p, cfg: ModelConfig, xc: torch.Tensor):
    """xc (B,S,di) → (decay (B,S,di,ds), Bx (B,S,di,ds), C (B,S,ds))."""
    ds = cfg.mamba_d_state
    r = _dt_rank(cfg)
    proj = xc @ p["x_proj"]                                  # (B,S,r+2ds)
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


def mamba_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_state: bool = False):
    """x (B,S,d) → (B,S,d).  state = (conv_tail (B,K-1,di), h (B,di,ds)).
    S must be a multiple of ``MAMBA_CHUNK``, or at most one chunk."""
    b, s, d = x.shape
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    conv_prev, h_prev = (None, None) if state is None else state

    xz = x @ p["in_proj"]
    x_in, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"], conv_prev)
                .float()).to(x.dtype)

    decay, bx, cc = _ssm_params(p, cfg, xc)

    chunk = min(MAMBA_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"scan chunk {chunk}")
    if h_prev is None:
        h_prev = torch.zeros((b, di, ds), dtype=torch.float32,
                             device=x.device)
    h0 = h_prev.float()
    dd = p["D"].float()
    ys = []
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        hh, h0 = _scan_chunk(decay[:, sl], bx[:, sl], h0)
        y = torch.einsum("blds,bls->bld", hh, cc[:, sl])     # (B,L,di)
        ys.append(y + dd * xc[:, sl].float())
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
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
