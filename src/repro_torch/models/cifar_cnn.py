"""CIFAR-10-scale CNN — the first workload past LeNet-5 (DESIGN.md §3).

A VGG-style int8 CNN sized so that layer 1 genuinely exceeds the VTA's
SRAM (the scaling step the paper's conclusion promises and the YOLO-NAS
follow-up work requires — same-padded convolutions, max pooling, and
multi-chunk matrices):

  L1 conv 3→64  k5 same-pad + ReLU + max-pool 2×2   (1,3,32,32) → (1,64,16,16)
  L2 conv 64→32 k3 same-pad + ReLU + avg-pool 2×2   → (1,32,8,8)
  L3 conv 32→64 k3 same-pad + ReLU + max-pool 2×2   → (1,64,4,4)
  L4 fc 1024→128 + ReLU
  L5 fc 128→10

Layer 1's input matrix is 1024×75 → 64×5 INP blocks = 5120 vectors, far
beyond the 2048-vector INP buffer of the default profile, so its program
is multi-chunk *by construction* and the pool/requant ALU uops are
re-indexed against each chunk's local ACC window (DESIGN.md §3).  Layer 2
is multi-chunk too (9216 INP vectors), exercising the avg-pool ADD/SHR
program across chunks.

The bit-exact integer forward pass the VTA execution must reproduce lives
here.  The reference's float32 forward (``reference_forward_float``, a JAX
program standing in for a framework-trained model) is left out of this
copy: it arrives with the port's float front door.

Weights travel from the reference as a mapping of named numpy arrays
(``dataclasses.asdict`` of its :class:`CifarCNNWeights`);
:func:`cifar_cnn_weights_from_arrays` checks names, shapes and dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.conv_lowering import conv2d_reference
from repro_torch.core.layer_compiler import LayerSpec

from .weights import checked_arrays


@dataclasses.dataclass
class CifarCNNWeights:
    conv1_w: np.ndarray   # (64, 3, 5, 5)   int8
    conv1_b: np.ndarray   # (64,)           int32
    conv2_w: np.ndarray   # (32, 64, 3, 3)
    conv2_b: np.ndarray
    conv3_w: np.ndarray   # (64, 32, 3, 3)
    conv3_b: np.ndarray
    fc4_w: np.ndarray     # (1024, 128)
    fc4_b: np.ndarray
    fc5_w: np.ndarray     # (128, 10)
    fc5_b: np.ndarray


CIFAR_CNN_SHAPES: Dict[str, Tuple[int, ...]] = {
    "conv1_w": (64, 3, 5, 5), "conv1_b": (64,),
    "conv2_w": (32, 64, 3, 3), "conv2_b": (32,),
    "conv3_w": (64, 32, 3, 3), "conv3_b": (64,),
    "fc4_w": (1024, 128), "fc4_b": (128,),
    "fc5_w": (128, 10), "fc5_b": (10,),
}


def cifar_cnn_weights_from_arrays(arrays: Mapping[str, np.ndarray]
                                  ) -> CifarCNNWeights:
    """Checked :class:`CifarCNNWeights` from named arrays (the reference's
    weight dataclass as ``dataclasses.asdict``): every name of
    :data:`CIFAR_CNN_SHAPES` present and no other, each of its shape,
    ``*_w`` int8 and ``*_b`` int32; a fault raises
    :class:`~repro_torch.models.weights.WeightsError`."""
    return CifarCNNWeights(**checked_arrays(arrays, CIFAR_CNN_SHAPES,
                                            "the CIFAR CNN"))


def cifar_cnn_random_weights(seed: int = 0, scale: int = 8) -> CifarCNNWeights:
    """Deterministic int8 weights in a narrow range (the static power-of-2
    requant discipline keeps activations healthy for any scale ≤ 16)."""
    rng = np.random.default_rng(seed)
    w = lambda *s: rng.integers(-scale, scale + 1, s,
                                dtype=np.int64).astype(np.int8)
    b = lambda n: rng.integers(-64, 65, (n,), dtype=np.int64).astype(np.int32)
    return CifarCNNWeights(
        conv1_w=w(64, 3, 5, 5), conv1_b=b(64),
        conv2_w=w(32, 64, 3, 3), conv2_b=b(32),
        conv3_w=w(64, 32, 3, 3), conv3_b=b(64),
        fc4_w=w(1024, 128), fc4_b=b(128),
        fc5_w=w(128, 10), fc5_b=b(10),
    )


def cifar_cnn_specs(weights: CifarCNNWeights,
                    requant_shifts: Optional[Sequence[Optional[int]]] = None
                    ) -> List[LayerSpec]:
    """The five LayerSpecs; ``requant_shifts`` pins the per-layer shifts
    (None entries = choose statically at compile time)."""
    s = list(requant_shifts) if requant_shifts is not None else [None] * 5
    return [
        LayerSpec("c1_conv", "conv", weights.conv1_w, weights.conv1_b,
                  padding=2, relu=True, pool="max2x2", requant_shift=s[0]),
        LayerSpec("c2_conv", "conv", weights.conv2_w, weights.conv2_b,
                  padding=1, relu=True, pool="avg2x2", requant_shift=s[1]),
        LayerSpec("c3_conv", "conv", weights.conv3_w, weights.conv3_b,
                  padding=1, relu=True, pool="max2x2", requant_shift=s[2]),
        LayerSpec("f4_fc", "fc", weights.fc4_w, weights.fc4_b,
                  relu=True, requant_shift=s[3]),
        LayerSpec("f5_fc", "fc", weights.fc5_w, weights.fc5_b,
                  relu=False, requant_shift=s[4]),
    ]


# ---------------------------------------------------------------------------
# Integer reference (the semantics the VTA must match bit-for-bit)
# ---------------------------------------------------------------------------

def _requant(acc: np.ndarray, pool_div: int, shift: int) -> np.ndarray:
    from repro_torch.core.layout import truncate_int8
    return truncate_int8(acc >> (pool_div + shift))


def _avgpool_sum(t: np.ndarray) -> np.ndarray:
    """Sum over 2×2 windows (division folded into the requant shift)."""
    return (t[:, :, 0::2, 0::2] + t[:, :, 0::2, 1::2]
            + t[:, :, 1::2, 0::2] + t[:, :, 1::2, 1::2])


def _maxpool(t: np.ndarray) -> np.ndarray:
    return np.maximum(np.maximum(t[:, :, 0::2, 0::2], t[:, :, 0::2, 1::2]),
                      np.maximum(t[:, :, 1::2, 0::2], t[:, :, 1::2, 1::2]))


def reference_forward_int8(weights: CifarCNNWeights, image: np.ndarray,
                           shifts: Sequence[int]
                           ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Bit-exact integer forward pass; returns (logits_int8 (1,10),
    per-layer activations)."""
    acts: Dict[str, np.ndarray] = {}
    x = image.astype(np.int64)

    def conv_block(x, w, b, shift, pad, pool):
        acc = (conv2d_reference(x.astype(np.int8), w, pad=pad)
               + b[None, :, None, None])
        acc = np.maximum(acc, 0)
        if pool == "avg":
            return _requant(_avgpool_sum(acc), 2, shift).astype(np.int64)
        if pool == "max":
            return _requant(_maxpool(acc), 0, shift).astype(np.int64)
        return _requant(acc, 0, shift).astype(np.int64)

    x = conv_block(x, weights.conv1_w, weights.conv1_b.astype(np.int64),
                   shifts[0], 2, "max");  acts["c1"] = x.astype(np.int8)
    x = conv_block(x, weights.conv2_w, weights.conv2_b.astype(np.int64),
                   shifts[1], 1, "avg");  acts["c2"] = x.astype(np.int8)
    x = conv_block(x, weights.conv3_w, weights.conv3_b.astype(np.int64),
                   shifts[2], 1, "max");  acts["c3"] = x.astype(np.int8)

    v = x.reshape(1, -1)                      # (1, 1024), NCHW order
    acc = v @ weights.fc4_w.astype(np.int64) + weights.fc4_b.astype(np.int64)
    acc = np.maximum(acc, 0)
    v = _requant(acc, 0, shifts[3]).astype(np.int64)
    acts["f4"] = v.astype(np.int8)

    acc = v @ weights.fc5_w.astype(np.int64) + weights.fc5_b.astype(np.int64)
    logits = _requant(acc, 0, shifts[4]);  acts["f5"] = logits
    return logits, acts


def synthetic_cifar_image(seed: int = 0) -> np.ndarray:
    """A deterministic 3×32×32 int8 test image (centred dynamic range)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(-64, 64, (1, 3, 32, 32), dtype=np.int64)
    return img.astype(np.int8)


def calibrate_shifts(weights: CifarCNNWeights,
                     images: Sequence[np.ndarray],
                     margin: int = 1) -> List[int]:
    """Static per-layer requant shifts over a calibration set (§4.2)."""
    from repro_torch.core.network_compiler import calibrate_network_shifts
    return calibrate_network_shifts(cifar_cnn_specs(weights), images,
                                    margin=margin)


def compile_cifar_cnn():
    """Calibrate + compile the CIFAR CNN as the reference's
    ``examples/cifar10_cnn_e2e.py`` does: seed-0 weights, shifts over the
    images of seeds 1-8, the network compiled serialized against
    ``synthetic_cifar_image(0)``.  Returns ``(weights, shifts, net)``."""
    from repro_torch.core.network_compiler import compile_network
    weights = cifar_cnn_random_weights(seed=0)
    shifts = calibrate_shifts(
        weights, [synthetic_cifar_image(s) for s in range(1, 9)])
    net = compile_network(cifar_cnn_specs(weights, shifts),
                          synthetic_cifar_image(0))
    return weights, shifts, net
