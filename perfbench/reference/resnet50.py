"""ResNet-50 v1.5 as the VTA computes it, in plain PyTorch.

The network (``configs/resnet50.json``): the stem conv with ReLU, a 3×3
stride-2 max pool (padding left out of a window) and its requant; 16
bottleneck blocks, each a 1×1 conv, a 3×3 conv (stride 2 in the first
block of stages 2–4) and a 1×1 conv, each of the first two with ReLU and
a requant, the third requantised but not committed and joined with the
block's input or, in a stage's first block, with a 1×1 projection of it
at the block's stride; ReLU after the join, then the join's requant, but
after the last join a sum over the 7×7 map whose requant shifts by at
least 5 (floor(log2 49)); the 2048 → 1000 dense layer.  Every requant is
a right shift; an activation a later layer reads is committed to int8
(low 8 bits).  At a join the operand of the larger scale exponent is
shifted right by the difference.

The shifts come from two calibration passes, as the port's compiler
plans them (see ``reference/resnet8.py``): with every weight exponent 0
over the first ``calibration.images`` images, each layer's weight
exponent is its requant's shift; with those, over all the calibration
images and the compile-time input, the shifts and pre-shifts.  A conv's
exponent is its input's plus its weight exponent, a requant's its
input's less its shift, the pool's its input's, the sum's its input's
plus 5.

The calibration runs on the card where there is one (float64 GEMMs are
exact on either).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import common
from .common import blocks, conv, dense, drop_bits, shift_for, tensors, wrap8


@dataclasses.dataclass
class _Walk:
    """One pass over the network: calibrating (shifts and pre-shifts
    chosen as values arrive, nothing committed) or applying a plan."""

    W: Dict[str, torch.Tensor]
    config: dict
    wexp: Dict[str, int]
    margin: int = 1
    shifts: Optional[Dict[str, int]] = None
    pre: Optional[Dict[str, Tuple[int, int]]] = None
    act_drop: int = 0
    w_drop: int = 0

    def __post_init__(self):
        self.layers = common.layers(self.config)
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

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        a, e = self.linear("stem", images, 0)
        pool = self.config["stem_pool"]
        a = F.max_pool2d(a.to(torch.float64), pool["window"], pool["step"],
                         pool["padding"]).to(torch.int64)
        x, e = self.requant("stem_q", a, e)
        arch = self.config["architecture"]
        last = (len(arch["blocks"]), arch["blocks"][-1])
        for i, count in enumerate(arch["blocks"], 1):
            for j in range(1, count + 1):
                n = f"s{i}b{j}"
                h, eh = self.requant(n + "a_q", *self.linear(n + "a", x, e))
                h, eh = self.requant(n + "b_q", *self.linear(n + "b", h, eh))
                skip, es = x, e
                if n + "p" in self.layers:
                    skip, es = self.requant(n + "p_q",
                                            *self.linear(n + "p", x, e))
                br, eb = self.requant(n + "c_q", *self.linear(n + "c", h, eh),
                                      commit=False)
                s, e = self.join(n + "_join", br, eb, skip, es)
                if (i, j) != last:
                    x, e = self.requant(n + "_q", s, e)
        gap_div = (s.shape[2] * s.shape[3]).bit_length() - 1
        x, e = self.requant("head_q", s.sum(dim=(2, 3), keepdim=True),
                            e + gap_div, floor=gap_div)
        a, e = self.linear("fc", x, e)
        logits, _ = self.requant("fc_q", a, e)
        return logits


def _calibration_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def calibrate(config: dict, weights: Dict[str, np.ndarray],
              calib: np.ndarray) -> dict:
    """``{"shifts", "pre_shifts", "weight_exps"}`` from ``calib``: the
    calibration images and, last, the compile-time input."""
    cal = config["calibration"]
    dev = _calibration_device()
    W = tensors(weights, dev)
    x = torch.as_tensor(calib).to(device=dev, dtype=torch.int64)
    names = list(common.layers(config))
    probe = _Walk(W, config, {name: 0 for name in names}, cal["margin"])
    probe(x[:cal["images"]])
    wexp = {name: probe.shifts[name + "_q"] for name in names}
    final = _Walk(W, config, wexp, cal["margin"])
    final(x)
    return {"shifts": final.shifts, "pre_shifts": final.pre,
            "weight_exps": wexp}


def forward(config: dict, weights: Dict[str, np.ndarray], plan: dict,
            images: np.ndarray, device, *, block: int = 64,
            bits: int = 8) -> np.ndarray:
    """Int8 logits ``(n, classes)`` of ``images`` on ``device``, ``block``
    images at a time.  ``bits=4`` is the lower-precision control: every
    GEMM operand keeps 4 significant bits."""
    device = torch.device(device)
    walk = _Walk(tensors(weights, device), config, plan["weight_exps"],
                 shifts=plan["shifts"], pre=plan["pre_shifts"],
                 act_drop=8 - bits,
                 w_drop=common.weight_drop(config, bits) if bits < 8 else 0)
    out = np.empty((len(images), config["layers"][-1]["out"]), np.int8)
    for lo, x in blocks(images, block, device):
        out[lo:lo + len(x)] = walk(x).reshape(len(x), -1).cpu().numpy()
    return out
