"""A batch of matrices padded, split and binarised as the reference's
``layout.batch_matrix_to_binary`` does it, built from the torch staging
functions: the bytes a layer's INP (int8) or RES (int32) region holds.
Served, the ``vta_stage`` gather writes those bytes through its tables
(``staging.operand_table``, ``staging.residual_table``); the CPU tests
hold the gather and the staging functions to this.  Imports no ``jax``."""

import torch

from repro_torch.core import staging


def batch_matrix_to_binary(mats: torch.Tensor, block_size: int,
                           dtype: torch.dtype) -> torch.Tensor:
    """``(B, M, K)`` → ``(B, nbytes)`` uint8, blocks in row-major block
    order (§3.2), each element ``dtype`` (int8 INP, int32 ACC) in
    little-endian bytes: the uint8 view of an int32 tensor is its memory,
    little-endian on the host and the card."""
    padded, row_height = staging.pad_matrix_batch(mats, block_size, dtype)
    raw = staging.matrix_blocks_batch(padded, row_height,
                                      block_size).contiguous()
    return raw.view(torch.uint8).reshape(mats.shape[0], -1)
