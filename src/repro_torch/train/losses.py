"""Losses (port of the reference's ``train/losses.py``).  Chunked
cross-entropy: the (B, S, vocab) logits are never built — the sequence
axis is taken ``chunk`` positions at a time, so the largest live logits
are (B, chunk, vocab) in float32, and their gradients beside them in the
backward pass."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import unembed_logits


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
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    correct = torch.zeros((), dtype=torch.int32, device=h.device)
    count = torch.zeros((), dtype=torch.int32, device=h.device)
    for lo in range(0, s, chunk):
        ll = labels[:, lo:lo + chunk]
        logits = unembed_logits(params, cfg, h[:, lo:lo + chunk]).float()
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
