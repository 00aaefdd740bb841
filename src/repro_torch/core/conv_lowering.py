"""Tensor → matrix lowering: im2row / ker2col / mat2tensor (paper §4.1, Def. 3).

Conventions (NCHW, batch = 1 as in the paper's experiments):

* ``im2row``  — input tensor ``(1, C, H, W)`` with a ``kh×kw`` kernel,
  stride ``s`` and symmetric zero-padding ``pad`` becomes the
  ``(H'·W') × (C·kh·kw)`` input matrix ``A``; one row per output spatial
  position (row-major over (i, j)), patch elements channel-major then
  kernel-row then kernel-col — matching ``ker2col``.  ``pad > 0`` is the
  zero-padded ("same") convolution needed past LeNet-5 (DESIGN.md §3): the
  padding is materialised host-side before patch extraction, so the VTA
  program is unchanged — only the A matrix grows.
* ``ker2col`` — weight tensor ``(F, C, kh, kw)`` becomes the
  ``(C·kh·kw) × F`` weight matrix ``B`` (filter ``f`` in column ``f``).
* ``mat2tensor`` — output matrix ``(H'·W') × F`` back to ``(1, F, H', W')``.

``T_C = mat2tensor(im2row(T_A) × ker2col(T_B))`` (Def. 3) is asserted by
property tests against a direct convolution oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """Spatial geometry of one convolution (``pad=0`` → valid padding;
    ``pad=(k-1)//2`` with stride 1 → same padding)."""

    in_channels: int
    in_h: int
    in_w: int
    kh: int
    kw: int
    stride: int = 1
    pad: int = 0

    @property
    def out_h(self) -> int:
        return (self.in_h + 2 * self.pad - self.kh) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.in_w + 2 * self.pad - self.kw) // self.stride + 1

    @property
    def patch_len(self) -> int:
        return self.in_channels * self.kh * self.kw

    @property
    def n_positions(self) -> int:
        return self.out_h * self.out_w


def _pad_spatial(tensor: np.ndarray, pad: int) -> np.ndarray:
    if pad == 0:
        return tensor
    if pad < 0:
        raise ValueError(f"negative padding {pad}")
    return np.pad(tensor, ((0, 0), (0, 0), (pad, pad), (pad, pad)))


def im2row(tensor: np.ndarray, kh: int, kw: int, stride: int = 1,
           pad: int = 0) -> np.ndarray:
    """Input tensor ``(1, C, H, W)`` → input matrix ``(H'·W', C·kh·kw)``."""
    if tensor.ndim != 4 or tensor.shape[0] != 1:
        raise ValueError(f"expected (1, C, H, W) tensor, got {tensor.shape}")
    return im2row_batch(tensor, kh, kw, stride, pad)[0]


def im2row_batch(tensor: np.ndarray, kh: int, kw: int, stride: int = 1,
                 pad: int = 0) -> np.ndarray:
    """Batched im2row: ``(B, C, H, W)`` → ``(B, H'·W', C·kh·kw)``.

    One strided window view + transpose per batch — the per-request
    staging of the serving path (DESIGN.md §Batching) runs through here.
    Row ``b`` equals ``im2row(tensor[b:b+1], ...)`` exactly: patch rows
    ordered (i, j) row-major, each patch flattened channel-major.
    """
    if tensor.ndim != 4:
        raise ValueError(f"expected (B, C, H, W) tensor, got {tensor.shape}")
    b, c, h, w = tensor.shape
    geo = ConvGeometry(c, h, w, kh, kw, stride, pad)
    oh, ow = geo.out_h, geo.out_w
    if oh <= 0 or ow <= 0:
        raise ValueError("kernel larger than (padded) input")
    x = _pad_spatial(tensor, pad)
    win = np.lib.stride_tricks.sliding_window_view(x, (kh, kw), axis=(2, 3))
    win = win[:, :, ::stride, ::stride]          # (B, C, oh, ow, kh, kw)
    return np.ascontiguousarray(
        win.transpose(0, 2, 3, 1, 4, 5)).reshape(b, oh * ow, geo.patch_len)


def ker2col(weights: np.ndarray) -> np.ndarray:
    """Weight tensor ``(F, C, kh, kw)`` → weight matrix ``(C·kh·kw, F)``."""
    if weights.ndim != 4:
        raise ValueError(f"expected (F, C, kh, kw) tensor, got {weights.shape}")
    f = weights.shape[0]
    return np.ascontiguousarray(weights.reshape(f, -1).T)


def mat2tensor(mat: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Output matrix ``(H'·W', F)`` → output tensor ``(1, F, H', W')``."""
    if mat.ndim != 2 or mat.shape[0] != out_h * out_w:
        raise ValueError(
            f"matrix {mat.shape} incompatible with {out_h}×{out_w} output")
    f = mat.shape[1]
    return np.ascontiguousarray(
        mat.reshape(out_h, out_w, f).transpose(2, 0, 1)[None])


def tensor2mat(tensor: np.ndarray) -> np.ndarray:
    """Inverse of ``mat2tensor`` — ``(1, F, H, W)`` → ``(H·W, F)``.

    This is the host-side reshaping entry point when the *next* layer is
    fully connected on a 1×1 spatial map, or when re-running ``im2row``.
    """
    if tensor.ndim != 4 or tensor.shape[0] != 1:
        raise ValueError(f"expected (1, F, H, W) tensor, got {tensor.shape}")
    _, f, h, w = tensor.shape
    return np.ascontiguousarray(tensor[0].transpose(1, 2, 0).reshape(h * w, f))


def flatten_tensor(tensor: np.ndarray) -> np.ndarray:
    """Tensor ``(1, C, H, W)`` → FC input row ``(1, C·H·W)`` (NCHW order) —
    the conv→FC transition of §4.3 ("thanks to the fully-connected
    layers")."""
    return np.ascontiguousarray(tensor.reshape(1, -1))


def conv2d_reference(tensor: np.ndarray, weights: np.ndarray,
                     stride: int = 1, pad: int = 0) -> np.ndarray:
    """Direct int64 convolution oracle for Def.-3 property tests."""
    _, c, h, w = tensor.shape
    f, cw, kh, kw = weights.shape
    assert c == cw, (c, cw)
    geo = ConvGeometry(c, h, w, kh, kw, stride, pad)
    out = np.zeros((1, f, geo.out_h, geo.out_w), dtype=np.int64)
    x = _pad_spatial(tensor, pad)[0].astype(np.int64)
    wt = weights.astype(np.int64)
    for i in range(geo.out_h):
        for j in range(geo.out_w):
            patch = x[:, i * stride:i * stride + kh, j * stride:j * stride + kw]
            out[0, :, i, j] = (patch[None] * wt).sum(axis=(1, 2, 3))
    return out


# ---------------------------------------------------------------------------
# Pooling index plans (region-based non-linear op, §4.1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """Pooling / spatial reduction as a VTA ALU program over ACC vectors.

    The conv-output matrix has one ACC vector per spatial position (per
    block column; for β > 1 the indices scale by the block geometry —
    handled by the layer compiler).  ``mode="avg"`` accumulates the 4
    window members into the *first* member's vector (3 ADD pairs), then
    divides by 4 with one SHR-2 (exact for the sum of four int32s in
    range).  ``mode="max"`` reduces the window with 3 MAX pairs and needs
    no division.  ``mode="gap"`` is global average pooling (DESIGN.md
    §Strided-lowering): a binary tree of ADD pairs folds every spatial
    position into row 0, then one SHR by ``div_shift = log2(H·W)`` divides
    exactly — which is why GAP requires a power-of-two position count.
    ``keep_rows`` lists the surviving matrix rows, in pooled row-major
    order — the host-side decode extracts exactly these rows (which is how
    the paper's layer-1 output is "decoded into a 196×6 matrix").  On
    multi-chunk results the GEMM compiler keeps each window's pairs inside
    one SRAM chunk (DESIGN.md §3); the GAP tree spans *every* row, so its
    pair groups pin the whole α range into a single chunk — a result too
    large for one ACC residency raises at compile time, never wrong bytes.

    ``rounds`` (GAP only) groups ``add_pairs`` into dependency levels of
    the reduction tree: pairs within one round touch disjoint vectors, so
    each round lowers to one vectorisable ALU instruction, while pairs in
    *different* rounds carry the read-after-write chain of the tree.
    Empty ``rounds`` means all pairs are independent (the 2×2 windows).
    """

    add_pairs: Tuple[Tuple[int, int], ...]
    shr_indices: Tuple[int, ...]
    keep_rows: Tuple[int, ...]
    out_h: int
    out_w: int
    mode: str = "avg"              # "avg" | "max" | "gap"
    div_shift: int = 2             # log2 of the ÷ folded into the requant SHR
    rounds: Tuple[Tuple[Tuple[int, int], ...], ...] = ()


def _pool2x2_windows(in_h: int, in_w: int):
    if in_h % 2 or in_w % 2:
        raise ValueError("2x2 pooling requires even spatial dims")
    oh, ow = in_h // 2, in_w // 2
    pairs = []
    keep = []
    for i in range(oh):
        for j in range(ow):
            base = (2 * i) * in_w + (2 * j)
            members = (base, base + 1, base + in_w, base + in_w + 1)
            for src in members[1:]:
                pairs.append((base, src))
            keep.append(base)
    return oh, ow, tuple(pairs), tuple(keep)


def avgpool2x2_plan(in_h: int, in_w: int) -> PoolPlan:
    """Average-pool 2×2/stride-2: 3 ADD pairs per window + SHR-2 (÷4)."""
    oh, ow, pairs, keep = _pool2x2_windows(in_h, in_w)
    return PoolPlan(add_pairs=pairs, shr_indices=keep, keep_rows=keep,
                    out_h=oh, out_w=ow, mode="avg", div_shift=2)


def maxpool2x2_plan(in_h: int, in_w: int) -> PoolPlan:
    """Max-pool 2×2/stride-2: 3 MAX pairs per window, no division —
    the ALU MAX pair program of DESIGN.md §3 (YOLO-style downsampling)."""
    oh, ow, pairs, keep = _pool2x2_windows(in_h, in_w)
    return PoolPlan(add_pairs=pairs, shr_indices=keep, keep_rows=keep,
                    out_h=oh, out_w=ow, mode="max", div_shift=0)


def global_avgpool_plan(in_h: int, in_w: int) -> PoolPlan:
    """Global average pooling over an ``in_h × in_w`` map (DESIGN.md
    §Strided-lowering): a ``log2(H·W)``-round binary tree of ADD pairs
    reduces every position's ACC vector into row 0, and one SHR by
    ``log2(H·W)`` turns the sum into the (floor) average — the ResNet/
    YOLO-NAS classification head, entirely on the TensorAlu.

    Requires a square power-of-two map so the division is exact in a
    single arithmetic shift; the layer compiler turns violations into
    typed :class:`~repro_torch.core.errors.CompileError`\\ s.
    """
    n = in_h * in_w
    if in_h != in_w:
        raise ValueError(f"global avg pool needs a square map, got "
                         f"{in_h}x{in_w}")
    if n <= 0 or n & (n - 1):
        raise ValueError(f"global avg pool needs a power-of-two position "
                         f"count for the SHR division, got {in_h}x{in_w}")
    rounds: list = []
    step = 1
    while step < n:
        rounds.append(tuple((base, base + step)
                            for base in range(0, n, 2 * step)))
        step *= 2
    flat = tuple(p for rnd in rounds for p in rnd)
    return PoolPlan(add_pairs=flat, shr_indices=(0,), keep_rows=(0,),
                    out_h=1, out_w=1, mode="gap",
                    div_shift=n.bit_length() - 1, rounds=tuple(rounds))
