"""Data definition stage: padding, splitting, binarisation (paper §3.2).

All functions are pure numpy — this is host-side compiler code (the paper's
certification argument depends on it staying simple and traceable).  The
inverse transformations (``unsplit``/``unpad``/decode) implement the
host-side reshaping used for layer chaining (§4.2).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def truncate_int8(x: np.ndarray) -> np.ndarray:
    """The ACC→OUT truncation (§2.1): keep the low 8 bits, reinterpreted
    as int8.  The single definition of the idiom — the simulators' commit,
    the layer references and the model references all route through it.
    (A C-style integer downcast keeps exactly the low byte, so this is the
    former ``(x & 0xFF).astype(uint8)`` in one pass.)"""
    return np.asarray(x).astype(np.uint8).view(np.int8)


def exact_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The integer product ``a @ b`` as int64, exactly.  Where no partial
    sum can reach 2**53 (``max|a| · max|b| · K``, the bound of every
    int8 layer), it runs in float64, whose BLAS is many times numpy's
    integer loop and holds every such integer exactly; otherwise in
    int64."""
    k = a.shape[-1]
    bound = (int(np.abs(a).max(initial=0)) * int(np.abs(b).max(initial=0))
             * k)
    if bound < 2 ** 53:
        return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64)
    return a.astype(np.int64) @ b.astype(np.int64)


def requant_int8(x: np.ndarray, *, saturate: bool = False) -> np.ndarray:
    """Post-SHR ACC→OUT narrowing under the device's semantics: wrap
    (:func:`truncate_int8`) by default, clip with ``saturate=True`` —
    the same two modes the simulators expose.  The single definition
    shared by execution *and* calibration (DESIGN.md §Quantization):
    calibration advancing its images through any other narrowing would
    choose shifts for a machine that does not exist."""
    if saturate:
        return np.clip(np.asarray(x), -128, 127).astype(np.int8)
    return truncate_int8(x)


def matrix_padding(mat: np.ndarray, block_size: int, *,
                   pad_height: bool = True) -> np.ndarray:
    """Zero-pad ``mat`` on the right/bottom to ``block_size`` multiples.

    §3.2: WGT matrices pad both dimensions; INP/ACC are vector sets, so only
    the width is *constrained*, but heights are "(generally)" padded too as
    it simplifies instruction generation.  The one exception — reproducing
    the paper's LeNet-5 loop counts — is a single-row matrix (batch-1 FC
    input), which stays a single vector row (``pad_height=False``).
    """
    if mat.ndim != 2:
        raise ValueError("matrix_padding expects a 2-D array")
    h, w = mat.shape
    new_w = pad_to_multiple(w, block_size)
    new_h = pad_to_multiple(h, block_size) if pad_height else h
    if (new_h, new_w) == (h, w):
        return mat.copy()
    out = np.zeros((new_h, new_w), dtype=mat.dtype)
    out[:h, :w] = mat
    return out


def should_pad_height(mat: np.ndarray) -> bool:
    """The paper's "(generally)" rule, as reverse-engineered from the §5.1
    loop counts: multi-row matrices are height-padded (LP_IN = block_size);
    single-row matrices are kept as one vector row (LP_IN = 1)."""
    return mat.shape[0] > 1


@dataclasses.dataclass(frozen=True)
class SplitMatrix:
    """Result of ``matrix_splitting``: row-major list of blocks.

    ``block_rows``/``block_cols`` are the block-grid dims (α×λ for INP, λ×β
    for WGT).  ``row_height`` is the height of each block row — equal to
    ``block_size`` except for unpadded single-row matrices (height 1).
    """

    blocks: List[np.ndarray]
    block_rows: int
    block_cols: int
    row_height: int
    block_size: int

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return (self.block_rows * self.row_height,
                self.block_cols * self.block_size)

    def block(self, i: int, j: int) -> np.ndarray:
        return self.blocks[i * self.block_cols + j]


def matrix_splitting(mat: np.ndarray, block_size: int) -> SplitMatrix:
    """§3.2: split a padded matrix into ``block_size``-wide blocks, row-major.

    Blocks are square except when the matrix is a single unpadded vector row
    (height < block_size), in which case each "block" is ``h × block_size``.
    """
    h, w = mat.shape
    if w % block_size:
        raise ValueError(f"width {w} not a multiple of block_size {block_size}")
    row_height = block_size if h % block_size == 0 else h
    if h % row_height:
        raise ValueError(f"height {h} not splittable into rows of {row_height}")
    block_rows = h // row_height
    block_cols = w // block_size
    blocks = [
        np.ascontiguousarray(mat[i * row_height:(i + 1) * row_height,
                                 j * block_size:(j + 1) * block_size])
        for i in range(block_rows) for j in range(block_cols)
    ]
    return SplitMatrix(blocks=blocks, block_rows=block_rows,
                       block_cols=block_cols, row_height=row_height,
                       block_size=block_size)


def matrix_unsplit(split: SplitMatrix) -> np.ndarray:
    """Inverse of ``matrix_splitting`` (layer-chaining reshape, §4.2)."""
    h, w = split.padded_shape
    out = np.zeros((h, w), dtype=split.blocks[0].dtype)
    for i in range(split.block_rows):
        for j in range(split.block_cols):
            out[i * split.row_height:(i + 1) * split.row_height,
                j * split.block_size:(j + 1) * split.block_size] = split.block(i, j)
    return out


def remove_padding(mat: np.ndarray, orig_shape: Tuple[int, int]) -> np.ndarray:
    h, w = orig_shape
    return np.ascontiguousarray(mat[:h, :w])


# ---------------------------------------------------------------------------
# Binarisation (§3.2)
# ---------------------------------------------------------------------------

def binarize_blocks(split: SplitMatrix, dtype: np.dtype, *,
                    transpose: bool = False) -> bytes:
    """Encode blocks to little-endian bytes in list order (left→right,
    top→bottom).  WGT blocks are stored transposed (``transpose=True``),
    the block *order* is unchanged (§3.2)."""
    dtype = np.dtype(dtype).newbyteorder("<")
    chunks = []
    for blk in split.blocks:
        data = blk.T if transpose else blk
        chunks.append(np.ascontiguousarray(data).astype(dtype, copy=False).tobytes())
    return b"".join(chunks)


def debinarize_blocks(raw: bytes, dtype: np.dtype, block_rows: int,
                      block_cols: int, row_height: int, block_size: int, *,
                      transpose: bool = False) -> SplitMatrix:
    """Inverse of ``binarize_blocks`` — used when decoding VTA output for
    layer chaining (§4.2 stage (i))."""
    dtype = np.dtype(dtype).newbyteorder("<")
    shape = (block_size, row_height) if transpose else (row_height, block_size)
    per_block = shape[0] * shape[1] * dtype.itemsize
    expected = per_block * block_rows * block_cols
    if len(raw) != expected:
        raise ValueError(f"binary size {len(raw)} != expected {expected}")
    blocks = []
    for k in range(block_rows * block_cols):
        blk = np.frombuffer(raw[k * per_block:(k + 1) * per_block],
                            dtype=dtype).reshape(shape)
        blocks.append(blk.T.copy() if transpose else blk.copy())
    return SplitMatrix(blocks=blocks, block_rows=block_rows,
                       block_cols=block_cols, row_height=row_height,
                       block_size=block_size)


def matrix_to_binary(mat: np.ndarray, block_size: int, dtype: np.dtype, *,
                     transpose: bool = False,
                     pad_height: bool | None = None) -> Tuple[bytes, SplitMatrix]:
    """Full data-definition pipeline for one matrix: pad → split → binarise."""
    if pad_height is None:
        pad_height = should_pad_height(mat)
    padded = matrix_padding(mat, block_size, pad_height=pad_height)
    split = matrix_splitting(padded, block_size)
    return binarize_blocks(split, dtype, transpose=transpose), split


def batch_matrix_to_binary(mats: np.ndarray, block_size: int,
                           dtype: np.dtype) -> np.ndarray:
    """Batched pad → split → binarise: ``(B, M, K)`` → ``(B, nbytes)`` uint8.

    Row ``b`` is byte-identical to ``matrix_to_binary(mats[b], ...)[0]`` —
    all images share one geometry, so the block split is a single reshape/
    transpose over the stack instead of B × per-block Python loops.  This
    is the INP-staging kernel of the serving path (DESIGN.md §Batching);
    the WGT-side ``transpose`` variant is not needed there (weights are
    staged once at compile time) and is intentionally not replicated.
    """
    if mats.ndim != 3:
        raise ValueError(f"expected a (B, M, K) stack, got {mats.shape}")
    b, h, w = mats.shape
    # all images share one geometry — derive it through the single-image
    # helpers (one representative pass) so the rules can never drift
    split0 = matrix_splitting(
        matrix_padding(mats[0], block_size,
                       pad_height=should_pad_height(mats[0])), block_size)
    new_h, new_w = split0.padded_shape
    row_height, br, bc = (split0.row_height, split0.block_rows,
                          split0.block_cols)
    padded = np.zeros((b, new_h, new_w), dtype=mats.dtype)
    padded[:, :h, :w] = mats
    blocks = padded.reshape(b, br, row_height, bc, block_size)
    blocks = blocks.transpose(0, 1, 3, 2, 4)      # block-major, row-major
    dt = np.dtype(dtype).newbyteorder("<")
    raw = np.ascontiguousarray(blocks).astype(dt, copy=False)
    return raw.view(np.uint8).reshape(b, -1)
