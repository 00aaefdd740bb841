"""Deterministic procedurally-generated digit dataset (DESIGN.md
§Quantization).

The accuracy-validation story needs thousands of labelled images without
network access, so the dataset is *generated*, MNIST-style: 5×7 digit
glyphs randomly scaled (×3/×4 per axis), sheared, placed on a 32×32
canvas, intensity-jittered and noised.  Every image is a pure function
of ``(seed, split, index)`` — a Philox stream keyed on that tuple — so

* train/test splits are disjoint by construction (different ``split``
  keys, not different slices of one stream);
* the dataset is identical across machines, runs and dataset sizes
  (image ``i`` does not depend on how many images were requested);
* labels are exactly balanced (``label = index % 10``).

Images are float32 in [0, 1], shaped ``(n, 1, 32, 32)`` (or
``(n, 3, 32, 32)`` with ``channels=3``, where a per-image random colour
tints the glyph — shape, not colour, carries the class).  This is the
float front door's input; :func:`repro_torch.quantize.ptq.quantize_images`
maps it onto the device's int8 input scale.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CANVAS = 32

# 5×7 glyph bitmaps, one per digit class.
_GLYPH_ROWS = {
    0: ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    1: ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    2: ("01110", "10001", "00001", "00110", "01000", "10000", "11111"),
    3: ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    4: ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    5: ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    6: ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    7: ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    8: ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    9: ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
}

GLYPHS = {d: np.array([[int(c) for c in row] for row in rows],
                      dtype=np.float32)
          for d, rows in _GLYPH_ROWS.items()}

_SPLIT_KEYS = {"train": 0, "test": 1, "calib": 2}


def digit_image(seed: int, split: str, index: int, *,
                channels: int = 1) -> Tuple[np.ndarray, int]:
    """One ``(image, label)`` pair — a pure function of its arguments."""
    if split not in _SPLIT_KEYS:
        raise ValueError(f"split must be one of {sorted(_SPLIT_KEYS)}, "
                         f"got {split!r}")
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    label = index % 10
    rng = np.random.default_rng((seed, _SPLIT_KEYS[split], index))
    fy = int(rng.integers(3, 5))
    fx = int(rng.integers(3, 5))
    glyph = np.kron(GLYPHS[label], np.ones((fy, fx), dtype=np.float32))
    h, w = glyph.shape
    slant = int(rng.integers(-2, 3))            # horizontal shear, ±2 px
    ws = w + abs(slant)
    sheared = np.zeros((h, ws), dtype=np.float32)
    for r in range(h):
        off = round(slant * r / max(h - 1, 1))
        off = off - min(0, slant)               # keep offsets non-negative
        sheared[r, off:off + w] = glyph[r]
    top = int(rng.integers(0, CANVAS - h + 1))
    left = int(rng.integers(0, CANVAS - ws + 1))
    intensity = float(rng.uniform(0.55, 1.0))
    canvas = rng.uniform(0.0, 0.12, (CANVAS, CANVAS)).astype(np.float32)
    canvas[top:top + h, left:left + ws] += intensity * sheared
    canvas += rng.normal(0.0, 0.03, (CANVAS, CANVAS)).astype(np.float32)
    gray = np.clip(canvas, 0.0, 1.0).astype(np.float32)
    if channels == 1:
        return gray[None, :, :], label
    tint = rng.uniform(0.5, 1.0, (3,)).astype(np.float32)
    img = np.clip(gray[None, :, :] * tint[:, None, None], 0.0, 1.0)
    return img.astype(np.float32), label


def digit_dataset(n: int, *, seed: int = 0, split: str = "train",
                  channels: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """``(images (n, C, 32, 32) float32 in [0,1], labels (n,) int64)``."""
    if n < 1:
        raise ValueError(f"dataset size must be >= 1, got {n}")
    pairs = [digit_image(seed, split, i, channels=channels)
             for i in range(n)]
    images = np.stack([p[0] for p in pairs])
    labels = np.array([p[1] for p in pairs], dtype=np.int64)
    return images, labels
