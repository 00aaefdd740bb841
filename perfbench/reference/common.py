"""Integer arithmetic of the VTA's int8 networks in plain PyTorch.

Activations and accumulators are int64 tensors.  A GEMM runs in float64
(``unfold`` and ``matmul``): every product of two int8 values and every
partial sum of a layer is an integer far below 2**53, so float64 holds
them exactly, on the CPU and on the card alike (TF32 touches float32
only).  A commit to int8 keeps the low 8 bits (the VTA's truncation).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def wrap8(v: torch.Tensor) -> torch.Tensor:
    """The ACC → OUT commit: the low 8 bits as a signed value."""
    return ((v + 128) & 255) - 128


def shift_for(m: int) -> int:
    """The smallest shift ``s`` with ``m >> s <= 127``."""
    s = 0
    while (m >> s) > 127:
        s += 1
    return s


def drop_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` with its ``bits`` low bits cleared (fewer bits of precision at
    the same scale; the lower-precision control)."""
    return (x >> bits) << bits if bits else x


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
         pad: int) -> torch.Tensor:
    """``(n, c, h, w)`` int64 activations, ``(f, c, k, k)`` weights, ``(f,)``
    bias → ``(n, f, ho, wo)`` int64 accumulators."""
    n, _, h, _ = x.shape
    f, _, k, _ = w.shape
    cols = F.unfold(x.to(torch.float64), (k, k), padding=pad, stride=stride)
    acc = torch.matmul(w.reshape(f, -1).to(torch.float64), cols)
    ho = (h + 2 * pad - k) // stride + 1
    return acc.to(torch.int64).reshape(n, f, ho, -1) + b.view(1, f, 1, 1)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(n, d)`` activations, ``(d, f)`` weights, ``(f,)`` bias → ``(n, f)``."""
    return torch.matmul(x.to(torch.float64),
                        w.to(torch.float64)).to(torch.int64) + b


def tensors(weights: Dict[str, np.ndarray],
            device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v.astype(np.int64), device=device)
            for k, v in weights.items()}


def blocks(images: np.ndarray, block: int,
           device: torch.device) -> Iterator[Tuple[int, torch.Tensor]]:
    """``images`` in blocks of ``block`` rows, as int64 on ``device``."""
    for lo in range(0, len(images), block):
        yield lo, torch.as_tensor(images[lo:lo + block]).to(
            device=device, dtype=torch.int64)


def weight_drop(config: dict, bits: int) -> int:
    """Low bits to clear from the weights so that they fit ``bits`` signed
    bits: none where the configuration's range already fits."""
    need = config["weights"]["range"].bit_length() + 1
    return max(0, need - bits)


def layers(config: dict) -> Dict[str, dict]:
    return {layer["name"]: layer for layer in config["layers"]}
