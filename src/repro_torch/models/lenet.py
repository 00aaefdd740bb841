"""LeNet-5 (paper §4.3) — the paper's demonstration workload.

Architecture (LeCun et al. 1998, as the paper uses it):

  L1 conv 1→6   k5  + ReLU + avgpool 2×2     (1,1,32,32) → (1,6,14,14)
  L2 conv 6→16  k5  + ReLU + avgpool 2×2     → (1,16,5,5)
  L3 conv 16→120 k5 + ReLU                   → (1,120,1,1)
  L4 fc  120→84 + ReLU
  L5 fc  84→10

Two references live here:

* ``lenet5_specs`` + ``reference_forward_int8`` — the exact integer
  semantics of the VTA execution (int8 weights, int32 accumulate, static
  power-of-2 requant, truncation), numpy as in the reference package.  The
  compiled network must match this bit-for-bit.
* :class:`LeNet5Float` — a float32 ``nn.Module`` over the same
  (integer-valued) weights, ``F.conv2d`` on NCHW/OIHW: the classification
  reference.  Its forward, :func:`lenet5_forward`, is also the trainable
  float LeNet-5's (:mod:`repro_torch.quantize.train`).

Weights travel between the two packages as a mapping of named numpy
arrays (``dataclasses.asdict`` of either package's :class:`LeNetWeights`);
:func:`lenet_weights_from_arrays` checks names, shapes and dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.conv_lowering import conv2d_reference
from repro_torch.core.layer_compiler import LayerSpec
from repro_torch.core.layout import truncate_int8

from .weights import WeightsError, checked_arrays  # noqa: F401


@dataclasses.dataclass
class LeNetWeights:
    conv1_w: np.ndarray   # (6, 1, 5, 5)  int8
    conv1_b: np.ndarray   # (6,)          int32
    conv2_w: np.ndarray   # (16, 6, 5, 5)
    conv2_b: np.ndarray
    conv3_w: np.ndarray   # (120, 16, 5, 5)
    conv3_b: np.ndarray
    fc4_w: np.ndarray     # (120, 84)
    fc4_b: np.ndarray
    fc5_w: np.ndarray     # (84, 10)
    fc5_b: np.ndarray


LENET5_SHAPES: Dict[str, Tuple[int, ...]] = {
    "conv1_w": (6, 1, 5, 5), "conv1_b": (6,),
    "conv2_w": (16, 6, 5, 5), "conv2_b": (16,),
    "conv3_w": (120, 16, 5, 5), "conv3_b": (120,),
    "fc4_w": (120, 84), "fc4_b": (84,),
    "fc5_w": (84, 10), "fc5_b": (10,),
}


def lenet_weights_from_arrays(arrays: Mapping[str, np.ndarray]
                              ) -> LeNetWeights:
    """Checked :class:`LeNetWeights` from named arrays: every name of
    :data:`LENET5_SHAPES` present and no other, each of its shape, ``*_w``
    int8 and ``*_b`` int32 (:func:`~repro_torch.models.weights.
    checked_arrays`)."""
    return LeNetWeights(**checked_arrays(arrays, LENET5_SHAPES, "LeNet-5"))


def lenet5_random_weights(seed: int = 0, scale: int = 16) -> LeNetWeights:
    """Deterministic int8 weights in a narrow range (so activations stay
    well-behaved under the static power-of-2 requant discipline)."""
    rng = np.random.default_rng(seed)
    w = lambda *s: rng.integers(-scale, scale + 1, s, dtype=np.int64).astype(np.int8)
    b = lambda n: rng.integers(-64, 65, (n,), dtype=np.int64).astype(np.int32)
    return LeNetWeights(
        conv1_w=w(6, 1, 5, 5), conv1_b=b(6),
        conv2_w=w(16, 6, 5, 5), conv2_b=b(16),
        conv3_w=w(120, 16, 5, 5), conv3_b=b(120),
        fc4_w=w(120, 84), fc4_b=b(84),
        fc5_w=w(84, 10), fc5_b=b(10),
    )


def lenet5_specs(weights: LeNetWeights,
                 requant_shifts: Optional[Sequence[Optional[int]]] = None
                 ) -> List[LayerSpec]:
    """The five LayerSpecs of §4.3.  ``requant_shifts`` pins the per-layer
    shifts (None entries = choose statically at compile time)."""
    s = list(requant_shifts) if requant_shifts is not None else [None] * 5
    return [
        LayerSpec("l1_conv", "conv", weights.conv1_w, weights.conv1_b,
                  relu=True, pool="avg2x2", requant_shift=s[0]),
        LayerSpec("l2_conv", "conv", weights.conv2_w, weights.conv2_b,
                  relu=True, pool="avg2x2", requant_shift=s[1]),
        LayerSpec("l3_conv", "conv", weights.conv3_w, weights.conv3_b,
                  relu=True, requant_shift=s[2]),
        LayerSpec("l4_fc", "fc", weights.fc4_w, weights.fc4_b,
                  relu=True, requant_shift=s[3]),
        LayerSpec("l5_fc", "fc", weights.fc5_w, weights.fc5_b,
                  relu=False, requant_shift=s[4]),
    ]


# ---------------------------------------------------------------------------
# Integer reference (the semantics the VTA must match bit-for-bit)
# ---------------------------------------------------------------------------

def _requant(acc: np.ndarray, pool_div: int, shift: int) -> np.ndarray:
    return truncate_int8(acc >> (pool_div + shift))


def _avgpool_sum(t: np.ndarray) -> np.ndarray:
    """Sum over 2×2 windows (division folded into the requant shift)."""
    return (t[:, :, 0::2, 0::2] + t[:, :, 0::2, 1::2]
            + t[:, :, 1::2, 0::2] + t[:, :, 1::2, 1::2])


def reference_forward_int8(weights: LeNetWeights, image: np.ndarray,
                           shifts: Sequence[int]
                           ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Bit-exact integer forward pass; returns (logits_int8 (1,10),
    per-layer activations)."""
    acts: Dict[str, np.ndarray] = {}
    x = image.astype(np.int64)

    def conv_block(x, w, b, shift, pool):
        acc = conv2d_reference(x.astype(np.int8), w) + b[None, :, None, None]
        acc = np.maximum(acc, 0)
        if pool:
            acc = _avgpool_sum(acc)
            return _requant(acc, 2, shift).astype(np.int64)
        return _requant(acc, 0, shift).astype(np.int64)

    x = conv_block(x, weights.conv1_w, weights.conv1_b.astype(np.int64),
                   shifts[0], True);  acts["l1"] = x.astype(np.int8)
    x = conv_block(x, weights.conv2_w, weights.conv2_b.astype(np.int64),
                   shifts[1], True);  acts["l2"] = x.astype(np.int8)
    x = conv_block(x, weights.conv3_w, weights.conv3_b.astype(np.int64),
                   shifts[2], False); acts["l3"] = x.astype(np.int8)

    v = x.reshape(1, -1)                      # (1, 120)
    acc = v @ weights.fc4_w.astype(np.int64) + weights.fc4_b.astype(np.int64)
    acc = np.maximum(acc, 0)
    v = _requant(acc, 0, shifts[3]).astype(np.int64); acts["l4"] = v.astype(np.int8)

    acc = v @ weights.fc5_w.astype(np.int64) + weights.fc5_b.astype(np.int64)
    logits = _requant(acc, 0, shifts[4]);  acts["l5"] = logits
    return logits, acts


# ---------------------------------------------------------------------------
# Float reference
# ---------------------------------------------------------------------------

def lenet5_forward(p: Mapping[str, torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """Float logits ``(B, 10)`` for ``(B, 1, 32, 32)`` images from the named
    float tensors ``p`` (:data:`LENET5_SHAPES`' names; fc weights ``(in,
    out)``, used as ``x @ w``) — the reference's ``lenet5_apply`` op for
    op: conv + bias + ReLU, the 2×2 average as the mean of four strided
    views, then fc + ReLU, fc.  :class:`LeNet5Float` and the trainable
    :class:`~repro_torch.quantize.train.LeNet5Net` both run it."""

    def conv(x, w, b, pool):
        y = torch.relu(F.conv2d(x, w) + b[None, :, None, None])
        if pool:
            y = (y[:, :, 0::2, 0::2] + y[:, :, 0::2, 1::2]
                 + y[:, :, 1::2, 0::2] + y[:, :, 1::2, 1::2]) / 4.0
        return y

    x = conv(x, p["conv1_w"], p["conv1_b"], True)
    x = conv(x, p["conv2_w"], p["conv2_b"], True)
    x = conv(x, p["conv3_w"], p["conv3_b"], False)
    v = torch.relu(x.reshape(x.shape[0], -1) @ p["fc4_w"] + p["fc4_b"])
    return v @ p["fc5_w"] + p["fc5_b"]


class LeNet5Float(nn.Module):
    """Float32 LeNet-5 over the (integer-valued) int8 weights
    (:func:`lenet5_forward`).  Input ``(B, 1, 32, 32)``, output ``(B, 10)``
    logits.

    On a card, float32 convolutions go through cuDNN in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is off; a caller comparing logits
    across devices runs it inside :func:`repro_torch.device.strict_float32`."""

    def __init__(self, arrays: Mapping[str, np.ndarray]):
        super().__init__()
        weights = lenet_weights_from_arrays(arrays)
        for name in LENET5_SHAPES:
            self.register_buffer(name, torch.as_tensor(
                getattr(weights, name).astype(np.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lenet5_forward(dict(self.named_buffers()), x)


def synthetic_digit(seed: int = 0) -> np.ndarray:
    """A deterministic 32×32 int8 test image (MNIST-like dynamic range)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 128, (1, 1, 32, 32), dtype=np.int64)
    return img.astype(np.int8)


def calibrate_shifts(weights: LeNetWeights, images: Sequence[np.ndarray],
                     margin: int = 1) -> List[int]:
    """Static per-layer requant shifts from a calibration set (§4.2
    discipline; see :func:`repro_torch.core.network_compiler.
    calibrate_network_shifts` for the model-agnostic implementation)."""
    from repro_torch.core.network_compiler import calibrate_network_shifts
    return calibrate_network_shifts(lenet5_specs(weights), images,
                                    margin=margin)
