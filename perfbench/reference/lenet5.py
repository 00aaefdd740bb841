"""LeNet-5 as the VTA computes it, in plain PyTorch.

Each layer: int8 input × int8 weights + bias in int32, ReLU, a 2×2 average
pool as the sum of its four values, then a right shift by the layer's
requant shift (plus 2 for the pool's ÷4) and the int8 commit.  The shifts
are calibrated on the configuration's calibration images: the smallest
that lands the largest pooled accumulator in int8, plus the margin, each
layer on the images advanced through the layers before it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .common import (blocks, conv, dense, drop_bits, shift_for, tensors,
                     weight_drop, wrap8)

POOL_DIV = {"avg2x2": 2}


def _acc(x: torch.Tensor, layer: dict, W: Dict[str, torch.Tensor],
         act_drop: int, w_drop: int):
    name = layer["name"]
    w = drop_bits(W[name + "_w"], w_drop)
    x = drop_bits(x, act_drop)
    if layer["kind"] == "conv":
        acc = conv(x, w, W[name + "_b"], layer["stride"], layer["pad"])
    else:
        acc = dense(x.reshape(x.shape[0], -1), w, W[name + "_b"])
    if layer["relu"]:
        acc = acc.clamp(min=0)
    pool = layer.get("pool")
    if pool == "avg2x2":
        acc = (acc[:, :, 0::2, 0::2] + acc[:, :, 0::2, 1::2]
               + acc[:, :, 1::2, 0::2] + acc[:, :, 1::2, 1::2])
    return acc, POOL_DIV.get(pool, 0)


def calibrate(config: dict, weights: Dict[str, np.ndarray],
              calib: np.ndarray) -> dict:
    """``{"shifts": {layer: shift}}`` from the first
    ``calibration.images`` of ``calib`` (the last is the compile-time
    input, which LeNet-5's shifts do not read)."""
    n = config["calibration"]["images"]
    margin = config["calibration"]["margin"]
    W = tensors(weights, torch.device("cpu"))
    x = torch.as_tensor(calib[:n]).to(torch.int64)
    shifts = {}
    for layer in config["layers"]:
        acc, pool_div = _acc(x, layer, W, 0, 0)
        s = shift_for(int((acc >> pool_div).abs().max())) + margin
        shifts[layer["name"]] = s
        x = wrap8(acc >> (pool_div + s))
    return {"shifts": shifts}


def forward(config: dict, weights: Dict[str, np.ndarray], plan: dict,
            images: np.ndarray, device, *, block: int = 4096,
            bits: int = 8) -> np.ndarray:
    """Int8 logits ``(n, 10)`` of ``images`` on ``device``, ``block``
    images at a time.  ``bits=4`` is the lower-precision control: every
    GEMM operand keeps 4 significant bits."""
    device = torch.device(device)
    W = tensors(weights, device)
    act_drop = 8 - bits
    w_drop = weight_drop(config, bits) if bits < 8 else 0
    out = np.empty((len(images), config["layers"][-1]["out"]), np.int8)
    for lo, x in blocks(images, block, device):
        for layer in config["layers"]:
            acc, pool_div = _acc(x, layer, W, act_drop, w_drop)
            x = wrap8(acc >> (pool_div + plan["shifts"][layer["name"]]))
        out[lo:lo + len(x)] = x.reshape(len(x), -1).cpu().numpy()
    return out


