"""RWKV-6 "Finch" (attention-free, data-dependent decay) — arXiv:2404.05892
(port of the reference's ``models/rwkv6.py``).

Time-mix with per-channel data-dependent decay ``w_t`` (LoRA-parameterised),
bonus ``u``, token-shift lerps, per-head group-norm and SiLU gate; channel-
mix with squared-ReLU.  Prefill runs the **chunked-parallel WKV**
(intra-chunk matmuls + inter-chunk recurrent state; the reference's
``lax.scan`` over chunks is a loop here); decode is the same call on one
token, an O(1)-state recurrence.

The WKV recurrence per head (key dim = value dim = N):

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ
    o_t = r_tᵀ · (S_{t-1} + diag(u) k_t v_tᵀ)

Chunked form (chunk L, log-space cumulated decays for stability):
``r̃_t = r_t ⊙ A⁻_t``, ``k̃_i = k_i / A_i`` with ``A_t = Π_{s≤t} w_s``,
intra-chunk scores ``r̃ k̃ᵀ`` strictly-lower-masked + ``u`` diagonal, and
state carry ``S' = diag(A_L) S + (k ⊙ A_L/A_i)ᵀ v``.

On a mesh the input's sequence is gathered first (the token shift runs
along it), the projections are DTensor products and the WKV runs on each
rank's batch rows and heads through ``local_map`` (:func:`_wkv`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device

from repro_torch.parallel.sharding import is_dtensor

from .config import ModelConfig
from .layers import constrain
from .params import ParamDef

W_LORA = 64
WKV_CHUNK = 64


def rwkv6_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    return {
        # token-shift lerp coefficients (r, k, v, w, g)
        "mu_r": ParamDef((d,), (None,), init="zeros"),
        "mu_k": ParamDef((d,), (None,), init="zeros"),
        "mu_v": ParamDef((d,), (None,), init="zeros"),
        "mu_w": ParamDef((d,), (None,), init="zeros"),
        "mu_g": ParamDef((d,), (None,), init="zeros"),
        # projections
        "wr": ParamDef((d, d), ("fsdp", "tp")),
        "wk": ParamDef((d, d), ("fsdp", "tp")),
        "wv": ParamDef((d, d), ("fsdp", "tp")),
        "wg": ParamDef((d, d), ("fsdp", "tp")),
        "wo": ParamDef((d, d), ("tp", "fsdp")),
        # data-dependent decay (LoRA) + base, and the bonus u
        "w_base": ParamDef((d,), (None,), init="zeros"),
        "w1": ParamDef((d, W_LORA), ("fsdp", None), scale=0.01),
        "w2": ParamDef((W_LORA, d), (None, "tp"), scale=0.01),
        "u": ParamDef((h, n), (None, None), scale=0.5),
        # per-head group norm
        "ln_scale": ParamDef((d,), (None,), init="ones"),
        "ln_bias": ParamDef((d,), (None,), init="zeros"),
        # channel mix
        "mu_ck": ParamDef((d,), (None,), init="zeros"),
        "mu_cr": ParamDef((d,), (None,), init="zeros"),
        "ck": ParamDef((d, cfg.d_ff), ("fsdp", "tp")),
        "cv": ParamDef((cfg.d_ff, d), ("tp", "fsdp")),
        "cr": ParamDef((d, d), ("fsdp", "tp")),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x (B,S,d) → x shifted right by one (x_{t-1}); prev fills t=0."""
    pad = (torch.zeros_like(x[:, :1]) if prev is None
           else prev[:, None].to(x.dtype))
    return torch.cat([pad, x[:, :-1]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def chunked_wkv(r, k, v, w, u, *, chunk: int = WKV_CHUNK,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (B, H, S, N) — returns (out (B,H,S,N), final state (B,H,N,N)).

    float32 throughout (decay ratios within a chunk stay representable for
    chunk ≤ 64).  S must be a multiple of the chunk, or at most one."""
    b, h, s, n = r.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the WKV "
                         f"chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    r, k, v = r.to(f32), k.to(f32), v.to(f32)
    lw = torch.log(torch.clamp(w.to(f32), 1e-8, 1.0))       # (B,H,S,N) ≤ 0
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=f32, device=r.device)
    S = state.to(f32)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    uu = u.to(f32)[None, :, None, :]
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        rr, kk, vv, lww = r[:, :, sl], k[:, :, sl], v[:, :, sl], lw[:, :, sl]
        cum = torch.cumsum(lww, dim=2)                       # A_t (incl. t)
        a_excl = torch.exp(cum - lww)                        # A_{t-1}·(≤1)
        r_t = rr * a_excl
        k_t = kk * torch.exp(-cum)                           # k / A_t
        # inter-chunk: r̃ @ S
        inter = torch.einsum("bhln,bhnm->bhlm", r_t, S)
        # intra-chunk: strictly-lower scores + u-diagonal
        scores = torch.einsum("bhln,bhmn->bhlm", r_t, k_t)
        scores = torch.where(mask[None, None], scores,
                             scores.new_zeros(()))
        intra = torch.einsum("bhlm,bhmn->bhln", scores, vv)
        diag = torch.einsum("bhln,bhln->bhl", rr * uu, kk)
        intra = intra + diag[..., None] * vv
        outs.append(inter + intra)
        # state advance
        a_total = torch.exp(cum[:, :, -1])                   # (B,H,N)
        k_scale = kk * torch.exp(cum[:, :, -1:, :] - cum)    # k ⊙ A_L/A_t
        S = S * a_total[..., None] + torch.einsum(
            "bhln,bhlm->bhnm", k_scale, vv)
    out = outs[0] if nc == 1 else torch.cat(outs, dim=2)
    return out, S


def _wkv_heads(r, k, v, w, u, n: int, state):
    """:func:`chunked_wkv` of (B, S, d) inputs split into heads of ``n``:
    (out (B, S, d), state (B, H, N, N))."""
    b, s, d = r.shape
    heads = lambda t: t.reshape(b, s, d // n, n).transpose(1, 2)
    out, state = chunked_wkv(heads(r), heads(k), heads(v), heads(w),
                             u.float(), state=state)
    return out.transpose(1, 2).reshape(b, s, d), state


def _wkv(r, k, v, w, u, n: int, state):
    """:func:`_wkv_heads`; of DTensors, on each rank's batch rows and the
    heads ``model`` splits (all heads where it does not divide them)
    through ``local_map``: the recurrence is head-local, and DTensor's
    views of a head split after a transpose do not hold on the local
    shards."""
    if not is_dtensor(r):
        return _wkv_heads(r, k, v, w, u, n, state)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = r.device_mesh
    names = mesh.mesh_dim_names
    rows = [isinstance(pl, Shard) and pl.dim == 0 for pl in r.placements]
    h = r.shape[-1] // n
    split = "model" in names and h % mesh.size(names.index("model")) == 0

    def place(head_dim):
        return tuple(Shard(0) if row else
                     Shard(head_dim) if split and name == "model" else
                     Replicate() for row, name in zip(rows, names))

    x_pl, st_pl = place(2), place(1)
    u_pl = tuple(Shard(0) if split and name == "model" else Replicate()
                 for name in names)
    u_grad = tuple(Partial() if row else pl for row, pl in zip(rows, u_pl))
    args = [r, k, v, w, u]
    ins, grads = [x_pl] * 4 + [u_pl], [x_pl] * 4 + [u_grad]
    if state is not None:
        args.append(state)
        ins.append(st_pl)
        grads.append(st_pl)

    def local(rl, kl, vl, wl, ul, *st):
        return _wkv_heads(rl, kl, vl, wl, ul, n, st[0] if st else None)

    return local_map(local, out_placements=(x_pl, st_pl), in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay w_t ∈ (0,1): exp(-exp(base + LoRA))."""
    lora = torch.tanh(xw @ p["w1"]) @ p["w2"]
    return torch.exp(-torch.exp((p["w_base"] + lora).float()))


def _group_norm(p, x: torch.Tensor, n: int, eps: float = 64e-5
                ) -> torch.Tensor:
    """Per-head LayerNorm over the flattened (B,S,d) with head groups."""
    b, s, d = x.shape
    xg = x.reshape(b, s, d // n, n).float()
    mu = xg.mean(-1, keepdim=True)
    var = ((xg - mu) ** 2).mean(-1, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(b, s, d) * p["ln_scale"].float() \
        + p["ln_bias"].float()


def rwkv6_time_mix(p, cfg: ModelConfig, x: torch.Tensor, *,
                   shift_prev: Optional[torch.Tensor] = None,
                   wkv_state: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """x (B,S,d) → (B,S,d) [, (last_x, wkv_state)]."""
    n = cfg.rwkv_head_dim
    x = constrain(x, "batch", None, None)    # the sequence whole: the shift
    xs = _token_shift(x, shift_prev)
    r = _lerp(x, xs, p["mu_r"]) @ p["wr"]
    k = _lerp(x, xs, p["mu_k"]) @ p["wk"]
    v = _lerp(x, xs, p["mu_v"]) @ p["wv"]
    g = _lerp(x, xs, p["mu_g"]) @ p["wg"]
    w = _decay(p, _lerp(x, xs, p["mu_w"]))                   # (B,S,d) f32

    out, state = _wkv(r, k, v, w, p["u"], n, wkv_state)
    out = _group_norm(p, out, n)
    out = constrain((out * F.silu(g.float())).to(x.dtype) @ p["wo"],
                    "batch", None, None)
    if return_state:
        return out, (x[:, -1], state)
    return out


def rwkv6_channel_mix(p, cfg: ModelConfig, x: torch.Tensor, *,
                      shift_prev: Optional[torch.Tensor] = None,
                      return_state: bool = False):
    x = constrain(x, "batch", None, None)
    xs = _token_shift(x, shift_prev)
    xk = _lerp(x, xs, p["mu_ck"])
    xr = _lerp(x, xs, p["mu_cr"])
    kk = torch.clamp(xk @ p["ck"], min=0)
    kk = kk * kk
    # the gate whole and the product summed before they meet (a product
    # of a split and a partial operand has no placement without them)
    out = constrain(torch.sigmoid((xr @ p["cr"]).float()).to(x.dtype),
                    "batch", None, None) \
        * constrain(kk @ p["cv"], "batch", None, None)
    if return_state:
        return out, x[:, -1]
    return out


# ---------------------------------------------------------------------------
# O(1) decode step (serving)
# ---------------------------------------------------------------------------

def rwkv6_decode_step(p, cfg: ModelConfig, x: torch.Tensor,
                      shift_prev: torch.Tensor, wkv_state: torch.Tensor,
                      cm_shift_prev: torch.Tensor):
    """Single-token recurrent step.  x (B, d); states threaded explicitly.

    Returns (out (B, d) *time-mix only*, new (shift, wkv_state)); channel
    mix is a separate call so the block wrapper can place the norms."""
    out, (new_shift, new_state) = rwkv6_time_mix(
        p, cfg, x[:, None], shift_prev=shift_prev, wkv_state=wkv_state,
        return_state=True)
    return out[:, 0], (new_shift, new_state)


def rwkv6_channel_decode_step(p, cfg: ModelConfig, x: torch.Tensor,
                              shift_prev: torch.Tensor):
    out, new_shift = rwkv6_channel_mix(
        p, cfg, x[:, None], shift_prev=shift_prev, return_state=True)
    return out[:, 0], new_shift


def rwkv6_init_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zero states of one layer: token shifts in ``dtype``, the WKV state
    in float32 whatever ``dtype`` is."""
    device = resolve_device(device)
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    return {
        "shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, h, n, n), dtype=torch.float32,
                           device=device),
        "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
    }
