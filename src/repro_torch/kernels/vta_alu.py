"""Plan, build, load and launch the hand-written ``vta_alu`` CUDA kernel.

The kernel (``csrc/vta_alu.cu``) runs a compiled program's TensorAlu
epilogue over a batch of DRAM images in one launch: it reads ``vta_gemm``'s
int32 result, the ACC region of one image (the compiled image's preload,
shared by the batch) and the images' RES regions, runs the ALU program in
registers (or, for pair and indexed ops, in shared memory an image) and
writes the int8 OUT region in place.  Its plain version is
``core/cuda_backend.py``'s torch epilogue.

The program reaches the kernel as an :class:`AluTable`: ``ROW`` int64
words an op (:data:`KINDS`, the ALU op, the immediate, offsets into the
index data that follows), built once per program and device by
``cuda_backend``.  :func:`plan` picks the launch from what the table
holds: a table of element-wise ops only streams, any other takes one block
an image.  The source is compiled with ``nvcc`` for ``sm_90a`` at first use
and loaded with ``ctypes``, as ``build.py`` describes.

Nothing here runs at import time: the CPU tests import this module on a
host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
from typing import Optional, Tuple

import torch

from . import build as _build
from .build import KernelLaunchError

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "vta_alu.cu"
KERNEL = _build.Kernel(SOURCE, "vta_alu_launch",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p]
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
                       + [ctypes.c_int] * 12 + [ctypes.c_void_p])

ROW = 8                         # int64 words an op takes (csrc: ROW)
# the table's op kinds, in csrc's order (enum Kind): immediate and residual
# ops are element-wise; indexed, pair (no src is a dst: grouped by dst) and
# sequential pair ops need the whole image
KINDS = ("imm", "res", "indexed", "pair", "pair_seq")
ELEMENTWISE = ("imm", "res")
MODES = ("stream", "shared", "global")  # csrc: enum Mode
THREADS = 256
SMEM_LIMIT = 232_448            # shared memory a block may use (csrc: same)
GRID_LIMIT = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class AluTable:
    """An ALU program as the kernel reads it: ``words`` (int64, on the
    program's device), ``n_ops`` op rows; ops ``[0, lead)`` and ``[tail,
    n_ops)`` are element-wise (applied as an element is loaded and as it
    is committed); ``residual`` is whether an op reads RES."""

    words: torch.Tensor
    n_ops: int
    lead: int
    tail: int
    residual: bool

    @property
    def streams(self) -> bool:
        """Every op is element-wise: no image needs a block of its own."""
        return self.lead == self.n_ops


@dataclasses.dataclass(frozen=True)
class AluPlan:
    """How one launch runs: ``mode`` (:data:`MODES`), ``vec`` lanes a
    thread loads at once (4: one 16-byte load; 1), the shared memory a
    block (``shared`` mode) and the grid's blocks."""

    mode: str
    vec: int
    smem: int
    blocks: int


def plan(table: AluTable, batch: int, n_vec: int, block_size: int,
         aligned: bool) -> AluPlan:
    """The launch of ``table`` over ``batch`` images of ``n_vec`` vectors:
    a streaming grid (``THREADS`` threads a block, one thread ``vec``
    lanes) where every op is element-wise; else one block an image, its
    vectors in shared memory where ``n_vec · block_size · 4`` bytes fit,
    in place in the GEMM's result where they do not.  ``aligned``: the
    operands allow 16-byte loads."""
    n = n_vec * block_size
    vec = 4 if aligned and block_size % 4 == 0 else 1
    if table.streams:
        blocks = batch * -(-n // vec // THREADS)
        mode, smem = "stream", 0
    else:
        blocks = batch
        mode, smem = (("shared", n * 4) if n * 4 <= SMEM_LIMIT
                      else ("global", 0))
    if blocks > GRID_LIMIT:
        raise ValueError(f"{batch} images of {n} elements need {blocks} "
                         f"blocks, over the grid limit {GRID_LIMIT}")
    return AluPlan(mode, vec, smem, blocks)


def _offset(region: Optional[Tuple[int, int]], size: int, stride: int,
            name: str) -> int:
    if region is None:
        return -1
    start, nbytes = region
    if nbytes != size or start < 0 or start + size > stride:
        raise ValueError(f"{name} region {region} does not hold {size} "
                         f"bytes inside a {stride}-byte image")
    return start


def _rows(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name} must be a (B, nbytes) uint8 tensor with "
                         f"unit column stride, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")


def vta_alu(gemm: torch.Tensor, stack: torch.Tensor, table: AluTable, *,
            blocks: Tuple[int, int, int, int],
            acc: Optional[Tuple[int, int]], res: Optional[Tuple[int, int]],
            out: Tuple[int, int], saturate: bool,
            acc_image: torch.Tensor) -> None:
    """Launch the kernel: OUT of every image of ``stack`` from ``gemm``.

    ``gemm`` int32, contiguous, ``B · α · rh · β · bs`` elements: the
    GEMM's (B, α·rh, β·bs) result, which the kernel may overwrite (an
    image too large for shared memory works in it).  ``stack`` uint8
    (B, nbytes) with unit column stride, on ``gemm``'s device.
    ``blocks`` is (α, β, rh, bs); ``acc``, ``res``, ``out`` the regions'
    (byte offset, byte size) in an image, ``acc``/``res`` None where the
    program has none.  ``acc_image`` is one image (uint8 (1, nbytes), on
    ``gemm``'s device) whose ACC region every image of the stack reads.
    Launches on the current stream and does not synchronise."""
    if table.residual and res is None:
        raise ValueError("the ALU program reads RES; the program has no RES "
                         "region")
    dev = gemm.device
    if (dev.type != "cuda" or stack.device != dev
            or acc_image.device != dev or table.words.device != dev):
        raise ValueError(f"vta_alu launches on one CUDA device; got gemm on "
                         f"{dev}, stack on {stack.device}, ACC image on "
                         f"{acc_image.device}, table on "
                         f"{table.words.device}")
    alpha, beta, rh, bs = blocks
    batch = stack.shape[0]
    n = alpha * beta * rh * bs
    if (gemm.dtype != torch.int32 or not gemm.is_contiguous()
            or gemm.numel() != batch * n):
        raise ValueError(f"gemm must be a contiguous int32 tensor of "
                         f"{batch} x {n} elements, got {gemm.dtype} "
                         f"{tuple(gemm.shape)}")
    _rows(stack, "stack")
    _rows(acc_image, "acc_image")
    if acc_image.shape[0] != 1:
        raise ValueError(f"acc_image must be one image, got "
                         f"{tuple(acc_image.shape)}")
    stride = stack.stride(0) if batch > 1 else stack.shape[1]
    acc_off = _offset(acc, 4 * n, acc_image.shape[1], "ACC")
    res_off = _offset(res, 4 * n, stack.shape[1], "RES")
    out_off = _offset(out, n, stack.shape[1], "OUT")
    # the ACC image may be a row of the stack (a simulator's), which the
    # launch writes OUT into
    for other in (acc, res):
        if other is not None and (other[0] < out_off + n
                                  and out_off < other[0] + other[1]):
            raise ValueError(f"OUT {out} overlaps a region it is computed "
                             f"from, {other}")
    aligned = (gemm.data_ptr() % 16 == 0 and stack.data_ptr() % 16 == 0
               and acc_image.data_ptr() % 16 == 0 and stride % 16 == 0
               and out_off % 4 == 0
               and all(off % 16 == 0 for off in (acc_off, res_off)
                       if off >= 0))
    p = plan(table, batch, alpha * beta * rh, bs, aligned)
    fn = KERNEL.launcher()
    args = (gemm.data_ptr(), stack.data_ptr(), stride,
            acc_image.data_ptr(), acc_off, res_off,
            out_off, table.words.data_ptr(), table.n_ops, table.lead,
            table.tail, batch, alpha, beta, rh, bs, int(saturate),
            MODES.index(p.mode), p.vec, p.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:                       # launch from the operands' device context
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise KernelLaunchError(
            f"vta_alu launch failed: cudaError {err} over {batch} images of "
            f"{n} elements, {p} (a launch the library does not take is "
            f"refused with cudaErrorInvalidValue, 1)")
