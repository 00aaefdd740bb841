"""Losses (port of the reference's ``train/losses.py``).  Chunked
cross-entropy: the (B, S, vocab) logits are never built — the sequence
axis is taken ``chunk`` positions at a time, so the largest live logits
are (B, chunk, vocab) in float32, and their gradients beside them in the
backward pass.

On a mesh ``h`` is a DTensor: it is gathered over the sequence axis once
(the residual stream is sequence-sharded) and the logits stay
vocab-sharded over ``model`` (B, chunk, vocab/tp).  There the log-sum-exp
is max + log Σ exp over the shards, the target logit a masked sum (one
term not zero: exact), and the prediction the first index of the row's
maximum, as ``argmax`` takes it — each a reduction over the vocab shards
that DTensor completes with an all-reduce.  Logits whose vocab is not
sharded (a 1×1 mesh) take the single-device operations."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import constrain
from repro_torch.models.transformer import unembed_logits
from repro_torch.parallel.sharding import is_dtensor


def _vocab_sharded(logits: torch.Tensor) -> bool:
    from torch.distributed.tensor import Shard
    return is_dtensor(logits) and any(
        isinstance(pl, Shard) and pl.dim == logits.ndim - 1
        for pl in logits.placements)


def _sharded_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(log-sum-exp, target logit, prediction) of vocab-sharded logits."""
    vocab = logits.shape[-1]
    m = logits.detach().amax(-1, keepdim=True)
    lse = (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))[..., 0]
    cols = torch.arange(vocab, device=logits.device)
    tgt = torch.where(labels[..., None] == cols, logits,
                      torch.zeros((), dtype=logits.dtype,
                                  device=logits.device)).sum(-1)
    pred = torch.where(logits.detach() == m, cols,
                       torch.full((), vocab, dtype=cols.dtype,
                                  device=cols.device)).amin(-1)
    return lse, tgt, pred


def chunked_softmax_xent(params, cfg: ModelConfig, h: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512,
                         mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, d), labels (B, S) → (mean nll, mean accuracy), both over
    the positions ``mask`` keeps (all without one)."""
    _, s, _ = h.shape
    chunk = min(chunk, s)
    while s % chunk:            # largest divisor of s ≤ chunk (VLM: 3840)
        chunk -= 1
    labels = labels.to(device=h.device, dtype=torch.long)
    h = constrain(h, "batch", None, None)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    correct = torch.zeros((), dtype=torch.int32, device=h.device)
    count = torch.zeros((), dtype=torch.int32, device=h.device)
    for lo in range(0, s, chunk):
        ll = labels[:, lo:lo + chunk]
        logits = unembed_logits(params, cfg, h[:, lo:lo + chunk]).float()
        if _vocab_sharded(logits):
            lse, tgt, pred = _sharded_terms(logits, ll)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, ll[..., None])[..., 0]
            pred = logits.argmax(-1)
        hit = pred == ll
        if mask is None:
            nll = lse - tgt
            kept = ll.numel()
        else:
            mm = mask[:, lo:lo + chunk].to(h.device)
            nll = (lse - tgt) * mm
            hit = hit & mm
            kept = mm.sum(dtype=torch.int32)
        nll_sum = nll_sum + nll.sum()
        correct = correct + hit.sum(dtype=torch.int32)
        count = count + kept
    count = torch.clamp(count, min=1).to(torch.float32)
    return nll_sum / count, correct.to(torch.float32) / count
