"""resnet8 as the VTA computes it, in plain PyTorch.

The network (``configs/resnet8.json``): a stem conv, an identity block,
two stride-2 transitions with k2/s2 projection shortcuts, a 1×1 mixing
conv with ReLU and a global-average pool, and the 64 → 10 dense layer.
Every requant is a right shift; an activation that a later layer reads is
committed to int8 (low 8 bits).  A block's second conv is not committed:
its shifted sum goes straight into the residual join, where the operand
of the larger scale exponent is shifted right by the difference, then
ReLU, the join's shift and the commit.  The pool sums its 64 positions
and its requant shifts by at least 6 (÷64).

The shifts come from two calibration passes, as the port's compiler
plans them:

1. with every weight exponent 0, over the first ``calibration.images``
   images: each requant gets the smallest shift that lands its largest
   value in int8, plus the margin (at least the pool's 6 after the pool),
   and each layer's weight exponent is its requant's shift, less one for
   the layers of ``calibration.octave_keep``;
2. with those weight exponents, over all the calibration images and the
   compile-time input, the same rule gives the shifts and, at each join,
   the pre-shift that brings both operands to one scale exponent (a
   conv's exponent is its input's plus its weight exponent, a requant's
   its input's less its shift, the pool's its input's plus 6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import common
from .common import blocks, conv, dense, drop_bits, shift_for, tensors, wrap8


@dataclasses.dataclass
class _Walk:
    """One pass over the network: calibrating (shifts and pre-shifts
    chosen as values arrive, nothing committed) or applying a plan."""

    W: Dict[str, torch.Tensor]
    layers: Dict[str, dict]
    wexp: Dict[str, int]
    margin: int = 1
    shifts: Optional[Dict[str, int]] = None
    pre: Optional[Dict[str, Tuple[int, int]]] = None
    act_drop: int = 0
    w_drop: int = 0

    def __post_init__(self):
        self.calibrating = self.shifts is None
        if self.calibrating:
            self.shifts, self.pre = {}, {}

    def linear(self, name: str, x: torch.Tensor, e: int):
        layer = self.layers[name]
        w = drop_bits(self.W[name + "_w"], self.w_drop)
        x = drop_bits(x, self.act_drop)
        if layer["kind"] == "conv":
            acc = conv(x, w, self.W[name + "_b"], layer["stride"],
                       layer["pad"])
        else:
            acc = dense(x.reshape(x.shape[0], -1), w, self.W[name + "_b"])
        if layer["relu"]:
            acc = acc.clamp(min=0)
        return acc, e + self.wexp[name]

    def requant(self, name: str, v: torch.Tensor, e: int, *, floor: int = 0,
                commit: bool = True):
        if self.calibrating:
            self.shifts[name] = max(
                shift_for(int(v.abs().max())) + self.margin, floor)
        s = self.shifts[name]
        out = v >> s
        return (wrap8(out) if commit and not self.calibrating else out), e - s

    def join(self, name: str, branch: torch.Tensor, eb: int,
             skip: torch.Tensor, es: int):
        if self.calibrating:
            self.pre[name] = (max(0, eb - es), max(0, es - eb))
        pa, pb = self.pre[name]
        return ((branch >> pa) + (skip >> pb)).clamp(min=0), eb - pa

    def identity_block(self, n: str, x: torch.Tensor, e: int):
        a, ea = self.linear(n + "a", x, e)
        h, eh = self.requant(n + "a_q", a, ea)
        a, ea = self.linear(n + "b", h, eh)
        br, eb = self.requant(n + "b_q", a, ea, commit=False)
        s, es = self.join(n + "_join", br, eb, x, e)
        return self.requant(n + "_q", s, es)

    def downsample_block(self, n: str, x: torch.Tensor, e: int):
        a, ea = self.linear(n + "a", x, e)
        h, eh = self.requant(n + "a_q", a, ea)
        p, ep = self.linear(n + "p", x, e)
        proj, epr = self.requant(n + "p_q", p, ep)
        a, ea = self.linear(n + "b", h, eh)
        br, eb = self.requant(n + "b_q", a, ea, commit=False)
        s, es = self.join(n + "_join", br, eb, proj, epr)
        return self.requant(n + "_q", s, es)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        a, e = self.linear("stem", images, 0)
        x, e = self.requant("stem_q", a, e)
        x, e = self.identity_block("b1", x, e)
        x, e = self.downsample_block("t2", x, e)
        x, e = self.downsample_block("t3", x, e)
        a, e = self.linear("head", x, e)
        hw = a.shape[2] * a.shape[3]
        gap_div = hw.bit_length() - 1
        x, e = self.requant("head_q", a.sum(dim=(2, 3), keepdim=True),
                            e + gap_div, floor=gap_div)
        a, e = self.linear("fc", x, e)
        logits, _ = self.requant("fc_q", a, e)
        return logits


def calibrate(config: dict, weights: Dict[str, np.ndarray],
              calib: np.ndarray) -> dict:
    """``{"shifts", "pre_shifts", "weight_exps"}`` from ``calib``: the
    calibration images and, last, the compile-time input."""
    cal = config["calibration"]
    layers = common.layers(config)
    W = tensors(weights, torch.device("cpu"))
    x = torch.as_tensor(calib).to(torch.int64)
    probe = _Walk(W, layers, {name: 0 for name in layers}, cal["margin"])
    probe(x[:cal["images"]])
    wexp = {name: probe.shifts[name + "_q"] for name in layers}
    for name in cal.get("octave_keep", ()):
        wexp[name] -= 1
    final = _Walk(W, layers, wexp, cal["margin"])
    final(x)
    return {"shifts": final.shifts, "pre_shifts": final.pre,
            "weight_exps": wexp}


def forward(config: dict, weights: Dict[str, np.ndarray], plan: dict,
            images: np.ndarray, device, *, block: int = 1024,
            bits: int = 8) -> np.ndarray:
    """Int8 logits ``(n, 10)`` of ``images`` on ``device``, ``block``
    images at a time.  ``bits=4`` is the lower-precision control: every
    GEMM operand keeps 4 significant bits."""
    device = torch.device(device)
    walk = _Walk(tensors(weights, device), common.layers(config),
                 plan["weight_exps"], shifts=plan["shifts"],
                 pre=plan["pre_shifts"], act_drop=8 - bits,
                 w_drop=common.weight_drop(config, bits) if bits < 8 else 0)
    out = np.empty((len(images), config["layers"][-1]["out"]), np.int8)
    for lo, x in blocks(images, block, device):
        out[lo:lo + len(x)] = walk(x).cpu().numpy()
    return out
