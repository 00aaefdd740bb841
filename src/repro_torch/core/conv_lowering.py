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
from typing import Optional, Tuple

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
    position into row 0, then one SHR of at least ``div_shift =
    floor(log2(H·W))`` — exact division on a power-of-two count, the sum at
    a power-of-two scale on any other (:func:`global_avgpool_plan`).
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

    ``mode="max3x3"`` is the 3×3/stride-2/pad-1 max pool (ResNet's stem,
    :func:`maxpool3x3s2_plan`): each window folds its members into its
    centre row with MAX pairs.  ``input_rows`` (None: the conv's own rows)
    lays the conv's result out in tiles, each holding its windows' rows, so
    that no window straddles two SRAM chunks: entry ``r`` names the im2row
    row that result row ``r`` computes, -1 a zero row that pads a tile to
    whole block rows.
    """

    add_pairs: Tuple[Tuple[int, int], ...]
    shr_indices: Tuple[int, ...]
    keep_rows: Tuple[int, ...]
    out_h: int
    out_w: int
    mode: str = "avg"              # "avg" | "max" | "gap" | "max3x3"
    div_shift: int = 2             # log2 of the ÷ folded into the requant SHR
    rounds: Tuple[Tuple[Tuple[int, int], ...], ...] = ()
    input_rows: Optional[Tuple[int, ...]] = None
    in_w: int = 0                  # the pooled map's width (max3x3)


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
    §Strided-lowering): a ``ceil(log2(H·W))``-round binary tree of ADD
    pairs reduces every position's ACC vector into row 0 (a position
    without a partner in a round waits for the next), and one SHR of at
    least ``floor(log2(H·W))`` requantises the sum — the ResNet/YOLO-NAS
    classification head, entirely on the TensorAlu.

    On a power-of-two count the SHR's ``log2(H·W)`` is the exact floor
    average; on any other (ResNet-50's 7×7 = 49) no shift divides, so the
    head is the sum at a power-of-two scale, which the planned requant
    shift sets.  The map must be square; the layer compiler turns
    violations into typed :class:`~repro_torch.core.errors.CompileError`\\ s.
    """
    n = in_h * in_w
    if in_h != in_w or n <= 0:
        raise ValueError(f"global avg pool needs a square map, got "
                         f"{in_h}x{in_w}")
    rounds: list = []
    step = 1
    while step < n:
        rounds.append(tuple((base, base + step)
                            for base in range(0, n - step, 2 * step)))
        step *= 2
    flat = tuple(p for rnd in rounds for p in rnd)
    return PoolPlan(add_pairs=flat, shr_indices=(0,), keep_rows=(0,),
                    out_h=1, out_w=1, mode="gap",
                    div_shift=n.bit_length() - 1, rounds=tuple(rounds))


def maxpool3x3s2_out(extent: int) -> int:
    """Output extent of the 3×3/stride-2/pad-1 max pool over ``extent``."""
    return (extent - 1) // 2 + 1


def _pool3x3_tile(in_h: int, in_w: int, th: int, tw: int,
                  block: int) -> int:
    """Result rows an interior tile of ``th × tw`` windows takes, padded to
    whole blocks of ``block`` rows."""
    rows = min(in_h, 2 * th + 1) * min(in_w, 2 * tw + 1)
    return -(-rows // block) * block


def maxpool3x3s2_plan(in_h: int, in_w: int, *,
                      max_rows: Optional[int] = None,
                      block: int = 1) -> PoolPlan:
    """Max-pool 3×3/stride-2/pad-1 (ResNet's stem) over an ``in_h × in_w``
    map: output ``(i, j)`` is the MAX of map positions ``(2i + di, 2j + dj)``
    for ``di, dj`` in ``{-1, 0, 1}`` that lie inside the map (the padding
    never wins: a padded position is left out, as −∞ would be).

    Windows overlap, so a window cannot fold into a row another window
    reads.  Each folds into its centre ``(2i, 2j)``, which no other window
    holds, with one MAX pair a member; no src is then a dst, and the pairs
    form one flat ALU op whose order does not matter.

    The windows are cut into tiles of ``th × tw`` windows, and the result
    holds each tile's map rows in turn, those its windows share with a
    neighbouring tile computed twice (``input_rows``), each tile padded to
    whole ``block`` rows: a chunk boundary may then fall between any two
    tiles.  Where the whole map fits ``max_rows`` result rows (one SRAM
    chunk; None: no limit) it is the one tile, whose rows are the conv's
    own (``input_rows`` None).  Otherwise the tile shape is the one with
    the most windows a result row that fits ``max_rows``."""
    oh, ow = maxpool3x3s2_out(in_h), maxpool3x3s2_out(in_w)
    th, tw = oh, ow
    if max_rows is not None and _pool3x3_tile(in_h, in_w, oh, ow,
                                              block) > max_rows:
        best = None
        for a in range(1, oh + 1):
            for b in range(1, ow + 1):
                rows = _pool3x3_tile(in_h, in_w, a, b, block)
                if rows > max_rows:
                    break
                key = (a * b / rows, a * b)
                if best is None or key > best[0]:
                    best = (key, a, b)
        if best is None:
            raise ValueError(f"no 3x3/s2 pooling window of a {in_h}x{in_w} "
                             f"map fits {max_rows} result rows")
        _, th, tw = best
    pairs, keep = [], [0] * (oh * ow)
    rows_map: list = []
    for i0 in range(0, oh, th):
        for j0 in range(0, ow, tw):
            i1, j1 = min(oh, i0 + th), min(ow, j0 + tw)
            r_lo, r_hi = max(0, 2 * i0 - 1), min(in_h, 2 * i1)
            c_lo, c_hi = max(0, 2 * j0 - 1), min(in_w, 2 * j1)
            base, width = len(rows_map), c_hi - c_lo
            slot = lambda r, c: base + (r - r_lo) * width + (c - c_lo)
            rows_map.extend(r * in_w + c for r in range(r_lo, r_hi)
                            for c in range(c_lo, c_hi))
            rows_map.extend([-1] * (-len(rows_map) % block))
            for i in range(i0, i1):
                for j in range(j0, j1):
                    centre = slot(2 * i, 2 * j)
                    keep[i * ow + j] = centre
                    for r in range(max(0, 2 * i - 1), min(in_h, 2 * i + 2)):
                        for c in range(max(0, 2 * j - 1),
                                       min(in_w, 2 * j + 2)):
                            if (r, c) != (2 * i, 2 * j):
                                pairs.append((centre, slot(r, c)))
    keep_t = tuple(keep)
    return PoolPlan(add_pairs=tuple(pairs), shr_indices=keep_t,
                    keep_rows=keep_t, out_h=oh, out_w=ow, mode="max3x3",
                    div_shift=0,
                    input_rows=(None if (th, tw) == (oh, ow)
                                else tuple(rows_map)),
                    in_w=in_w)


def maxpool3x3s2_matrix(acc: np.ndarray, in_w: int) -> np.ndarray:
    """The 3×3/s2/p1 max pool of an ``(H·W, F)`` map matrix (rows
    row-major over ``(i, j)``, ``W = in_w``) as an ``(H'·W', F)`` matrix,
    padding left out of every window."""
    h = acc.shape[0] // in_w
    oh, ow = maxpool3x3s2_out(h), maxpool3x3s2_out(in_w)
    low = np.iinfo(np.int64).min
    grid = np.full((2 * oh + 1, 2 * ow + 1, acc.shape[1]), low, np.int64)
    grid[1:h + 1, 1:in_w + 1] = acc.reshape(h, in_w, -1)
    out = np.full((oh, ow, acc.shape[1]), low, np.int64)
    for di in range(3):
        for dj in range(3):
            out = np.maximum(out, grid[di:di + 2 * oh:2, dj:dj + 2 * ow:2])
    return out.reshape(oh * ow, -1)


def expand_rows(mat: np.ndarray, rows: Optional[Tuple[int, ...]]
                ) -> np.ndarray:
    """``mat``'s rows laid out as ``rows`` names them (-1: a zero row), or
    ``mat`` itself where ``rows`` is None (:attr:`PoolPlan.input_rows`)."""
    if rows is None:
        return mat
    idx = np.asarray(rows, dtype=np.int64)
    out = np.zeros((len(idx),) + mat.shape[1:], dtype=mat.dtype)
    out[idx >= 0] = mat[idx[idx >= 0]]
    return out
