"""Plan, build, load and launch the hand-written ``vta_stage`` CUDA kernel.

The kernel (``csrc/vta_stage.cu``) gathers a layer's GEMM operand, or its
RES region, in one pass from the bytes its producer committed:
``dst[b, i] = index[i] < 0 ? 0 : src[b, index[i]]``, int8 destinations
as they are and int32 ones sign-extended.  The index reaches it as a
:class:`StageTable`, built once per compiled network by ``core/staging.py``
(:func:`make_table` marks the chunks whose sources are one aligned run);
:func:`plan` picks the launch's tiles and how many images a block walks.
Its plain version is ``ref.vta_stage_ref``.  The source is compiled with
``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``, as
``build.py`` describes.

Nothing here runs at import time: the CPU tests import this module on a
host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
from typing import Tuple

import torch

from repro_torch.device import device_sm_count

from . import build as _build
from .build import KernelLaunchError

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "vta_stage.cu"
KERNEL = _build.Kernel(SOURCE, "vta_stage_launch",
                       [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])

THREADS = 256                   # csrc: THREADS
CHUNK = 16                      # destination bytes a thread stores
MAX_TILE_COLS = 16              # a tile's columns of chunks, at most
BLOCKS_PER_SM = 2048 // THREADS
WAVES = 4                       # the grid's blocks, in full waves of the card
MIN_IMAGES = 16                 # images a block walks, where the batch has them
GROUP_LIMIT = 65535             # the grid's second dimension


@dataclasses.dataclass(frozen=True)
class StageTable:
    """One destination's gather: ``index`` (int32, a source byte each
    destination element, -1 for a zero), ``runs`` (int32, each 16-byte
    destination chunk's first source byte where its sources are one run
    of consecutive bytes aligned to the run's length, else -1), the
    destination's ``rows`` of chunks (the operand's Mp; the chunks
    themselves for a block-ordered region), its element bytes ``elem``
    (1 int8, 4 int32), the ``[lo, hi)`` ``span`` of source bytes read,
    and ``contiguous``, the chunks served by one load."""

    index: torch.Tensor
    runs: torch.Tensor
    rows: int
    elem: int
    span: Tuple[int, int]
    contiguous: int

    @property
    def chunks(self) -> int:
        return self.runs.numel()

    @property
    def cols(self) -> int:
        return self.chunks // self.rows

    def to(self, device) -> "StageTable":
        return dataclasses.replace(self, index=self.index.to(device),
                                   runs=self.runs.to(device))


def make_table(index: torch.Tensor, *, elem: int, rows: int) -> StageTable:
    """The :class:`StageTable` of ``index`` (any integer tensor, -1 for a
    zero, read in row-major order) for ``elem``-byte destination elements
    in ``rows`` rows of chunks; its runs are read off the index itself."""
    if elem not in (1, 4):
        raise ValueError(f"destination elements are 1 or 4 bytes, got {elem}")
    flat = index.reshape(-1).to(torch.int64).cpu()
    per = CHUNK // elem
    if flat.numel() == 0 or flat.numel() % per or (flat.numel() // per) % rows:
        raise ValueError(f"{flat.numel()} elements of {elem} bytes are not "
                         f"{rows} rows of {CHUNK}-byte chunks")
    if bool((flat < -1).any()) or bool((flat >= 2 ** 31).any()):
        raise ValueError("a source byte outside [-1, 2**31)")
    chunks = flat.reshape(-1, per)
    first = chunks[:, 0]
    run = ((first >= 0) & (first % per == 0)
           & (chunks == first[:, None] + torch.arange(per)).all(1))
    read = flat[flat >= 0]
    span = ((int(read.min()), int(read.max()) + 1) if read.numel()
            else (0, 0))
    return StageTable(index=flat.to(torch.int32),
                      runs=torch.where(run, first, -1).to(torch.int32),
                      rows=rows, elem=elem, span=span,
                      contiguous=int(run.sum()))


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A launch: a tile of ``tile_rows`` by ``tile_cols`` chunks a block,
    ``tiles`` blocks over the destination, and ``groups`` blocks along the
    batch, each walking ``per_block`` images."""

    tile_rows: int
    tile_cols: int
    tiles: int
    groups: int
    per_block: int


def plan(table: StageTable, batch: int, sms: int) -> StagePlan:
    """The launch of ``table`` over ``batch`` images on ``sms`` SMs: a
    tile as many columns wide as a row has chunks, up to 16 (past 16 the
    width in [8, 16] that wastes fewest columns), as many rows as fill
    ``THREADS``; then enough groups of images to give the card ``WAVES``
    waves of blocks, each group at least ``MIN_IMAGES`` images."""
    cols = table.cols
    if cols <= MAX_TILE_COLS:
        tile_cols = cols
    else:
        tile_cols = min(range(MAX_TILE_COLS // 2, MAX_TILE_COLS + 1),
                        key=lambda w: (-(-cols // w) * w, -w))
    tile_rows = THREADS // tile_cols
    tiles = -(-table.rows // tile_rows) * -(-cols // tile_cols)
    want = -(-WAVES * BLOCKS_PER_SM * sms // tiles)
    groups = max(1, min(want, -(-batch // MIN_IMAGES), GROUP_LIMIT))
    per_block = -(-batch // groups)
    return StagePlan(tile_rows, tile_cols, tiles, -(-batch // per_block),
                     per_block)


def _rows(t: torch.Tensor, name: str) -> None:
    if t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name} must be a 2-D tensor with unit column "
                         f"stride, got {tuple(t.shape)} strides {t.stride()}")


def _stride(t: torch.Tensor) -> int:
    """Bytes from one row to the next (a lone row's own length)."""
    return t.stride(0) * t.element_size() if t.shape[0] > 1 else (
        t.shape[1] * t.element_size())


def check_operands(src: torch.Tensor, table: StageTable,
                   out: torch.Tensor) -> Tuple[int, int]:
    """Refuse what the kernel does not take (see :func:`vta_stage`);
    returns the source's and the destination's row strides in bytes."""
    want = torch.int8 if table.elem == 1 else torch.int32
    if src.dtype not in (torch.uint8, torch.int8) or out.dtype != want:
        raise ValueError(f"vta_stage takes uint8 or int8 sources and {want} "
                         f"destinations, got {src.dtype} and {out.dtype}")
    _rows(src, "src")
    _rows(out, "out")
    batch = out.shape[0]
    if src.shape[0] != batch or out.shape[1] != table.index.numel():
        raise ValueError(f"{batch} images of {out.shape[1]} elements from "
                         f"{src.shape[0]} source rows through a table of "
                         f"{table.index.numel()} entries")
    if table.span[1] > src.shape[1]:
        raise ValueError(f"the table reads source bytes up to "
                         f"{table.span[1]}, past a row of {src.shape[1]}")
    src_stride, dst_stride = _stride(src), _stride(out)
    if out.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        # a region of the rows it reads: the same rows, other bytes
        lo = out.data_ptr() - src.data_ptr()
        hi = lo + out.shape[1] * out.element_size()
        if ((batch > 1 and src_stride != dst_stride) or lo < 0
                or hi > src.shape[1]
                or (lo < table.span[1] and table.span[0] < hi)):
            raise ValueError(f"out, bytes [{lo}, {hi}) of the source rows, "
                             f"is not a region of them apart from the bytes "
                             f"the table reads, {table.span}")
    return src_stride, dst_stride


def vta_stage(src: torch.Tensor, table: StageTable, out: torch.Tensor) -> None:
    """Launch the kernel: ``out`` (B, n) from ``src`` (B, bytes) through
    ``table``.

    ``src`` uint8 or int8 with unit column stride, holding every byte of
    ``table.span``; ``out`` int8 (``table.elem`` 1) or int32 (4) with unit
    column stride, 16-byte aligned rows, and one element an entry.  ``out``
    may be a region of ``src``'s rows (of the same DRAM stack) that holds
    none of the bytes the table reads.  Launches on the current stream and
    does not synchronise."""
    dev = out.device
    if (dev.type != "cuda" or src.device != dev
            or table.index.device != dev or table.runs.device != dev):
        raise ValueError(f"vta_stage launches on one CUDA device; got src on "
                         f"{src.device}, out on {dev}, table on "
                         f"{table.index.device}")
    src_stride, dst_stride = check_operands(src, table, out)
    batch = out.shape[0]
    runs_ok = src.data_ptr() % CHUNK == 0 and src_stride % CHUNK == 0
    p = plan(table, batch, device_sm_count(dev))
    fn = KERNEL.launcher()
    args = (src.data_ptr(), src_stride, out.data_ptr(), dst_stride,
            table.index.data_ptr(), table.runs.data_ptr() if runs_ok else None,
            table.rows, table.cols, p.tile_rows, p.tile_cols, table.elem,
            batch, p.per_block, torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:                       # launch from the operands' device context
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise KernelLaunchError(
            f"vta_stage launch failed: cudaError {err} over {batch} images "
            f"of {table.chunks} chunks, {p} (a launch the library does not "
            f"take is refused with cudaErrorInvalidValue, 1)")
