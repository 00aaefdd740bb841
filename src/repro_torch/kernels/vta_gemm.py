"""Plan, build, load and launch the hand-written ``vta_gemm`` CUDA kernel.

The kernel (``csrc/vta_gemm.cu``) runs the VTA's fused GEMM on the int8
tensor cores.  :func:`plan` owns its geometry: tile, warps, K split, ring
stages, load path, grid and shared memory of one call.  The C entry point
launches exactly that geometry where the library has an instantiation for
it (``GEOMETRIES`` × both load paths) and refuses any other.  The source is
compiled with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes``, as ``build.py`` describes.

Nothing here runs at import time: the CPU tests import this module on a
host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.device import SM_COUNT, device_sm_count

from . import build as _build
from .build import KernelBuildError, KernelLaunchError  # noqa: F401

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "vta_gemm.cu"


class _CPlan(ctypes.Structure):
    """A ``GemmPlan`` as the C entry point takes it (``struct Plan`` in
    ``csrc/vta_gemm.cu``)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "bm", "bn", "k_split", "bk", "stages", "vec16", "smem", "gx", "gy")]


KERNEL = _build.Kernel(SOURCE, "vta_gemm_launch",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(_CPlan), ctypes.c_void_p])
build = KERNEL.build
library_path = KERNEL.library_path

KSTEP = 32                      # K bytes of one mma.sync m16n8k32
BMS = (16, 32, 64, 128)         # tile rows: 16 a warp
BNS = (16, 32, 64)              # tile columns
K_SPLITS = (1, 2, 4, 8)         # warp groups that split a block's K range
WARPS = 8                       # warps a block, where K allows
LOADS = ("vec16", "bytes")
MAX_STAGES = 8                  # cp.async groups in flight (csrc: MAX_STAGES)
RING_BUDGET = 96 * 1024         # ring bytes a block may take: 2 blocks an SM
SMEM_LIMIT = 232_448            # shared memory a block may use (csrc: same)
GRID_Y_LIMIT = 65_535

# (bm, bn, k_split) the library is built for, each on both load paths: every
# tile with every K split of at most WARPS warps.  The same list as
# VTA_GEMM_GEOMETRIES in csrc/vta_gemm.cu.
GEOMETRIES = tuple((bm, bn, ks) for bm in BMS for bn in BNS for ks in K_SPLITS
                   if bm // 16 * ks <= WARPS)
INSTANTIATIONS = tuple((bm, bn, ks, load) for bm, bn, ks in GEOMETRIES
                       for load in LOADS)
# Tiles from the largest down (by area, then rows): plan takes the first
# whose grid is large enough.
TILES = tuple(sorted(((bm, bn) for bm in BMS for bn in BNS),
                     key=lambda t: (-t[0] * t[1], -t[0])))


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How one call runs: the problem ``shape`` (M, K, N) and output type,
    a ``bm`` × ``bn`` output tile per block, ``k_split`` warps splitting
    each block's K range (K step j of a stage goes to warp group
    ``j % k_split``), ``bk`` K bytes per ring stage, ``stages`` slots in
    the ring, and the ``load`` path.  Warps, grid and shared memory follow;
    the C entry point launches exactly this geometry or refuses it."""
    shape: Tuple[int, int, int]
    out_dtype: str
    bm: int
    bn: int
    k_split: int
    bk: int
    stages: int
    load: str

    @property
    def warps(self) -> int:
        return self.bm // 16 * self.k_split

    @property
    def grid(self) -> Tuple[int, int]:
        m, _, n = self.shape
        return (-(-m // self.bm), -(-n // self.bn))

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def stage_bytes(self) -> int:
        """One ring slot: A rows of ``bk + 16`` bytes, B rows of ``bn + 16``
        (16 at bn = 16): odd multiples of 16, so ldmatrix does not conflict."""
        b_pitch = 16 if self.bn == 16 else self.bn + 16
        return self.bm * (self.bk + 16) + self.bk * b_pitch

    @property
    def smem_bytes(self) -> int:
        """The ring, or the split warps' int32 partial sums (which reuse
        it), whichever is larger."""
        return max(self.stages * self.stage_bytes,
                   (self.k_split - 1) * self.bm * self.bn * 4)

    def k_slices(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        """For each of the ``k_split`` warp groups, the K ranges it sums,
        in the kernel's order."""
        k = self.shape[1]
        slices = [[] for _ in range(self.k_split)]
        for k0 in range(0, k, self.bk):
            for j, lo in enumerate(range(k0, min(k, k0 + self.bk), KSTEP)):
                slices[j % self.k_split].append((lo, min(k, lo + KSTEP)))
        return tuple(tuple(s) for s in slices)

    @functools.cached_property
    def c_plan(self) -> _CPlan:
        """The plan as ``struct Plan``, made once (the C side copies it)."""
        return _CPlan(self.bm, self.bn, self.k_split, self.bk, self.stages,
                      int(self.load == "vec16"), self.smem_bytes, *self.grid)


def make_plan(m: int, k: int, n: int, bm: int, bn: int, k_split: int,
              load: str, out_dtype: torch.dtype = torch.int8) -> GemmPlan:
    """The plan of a chosen tile, K split and load path, with ``plan``'s
    ring: ``bk`` = 128 K-bytes a stage (256 at ``k_split`` 8: one K step a
    warp), cut to the power of two that holds K; as many stages as K
    needs, at most ``MAX_STAGES`` and ``RING_BUDGET`` bytes."""
    step = KSTEP * k_split
    bk = min(step * max(1, 4 // k_split),
             max(step, 1 << (max(k, 1) - 1).bit_length()))
    p = GemmPlan((m, k, n), str(out_dtype).replace("torch.", ""), bm, bn,
                 k_split, bk, 1, load)
    stages = max(1, min(-(-k // bk), MAX_STAGES,
                        RING_BUDGET // p.stage_bytes))
    return dataclasses.replace(p, stages=stages)


@functools.lru_cache(maxsize=1024)     # a plan costs ~15 us of host time
def plan(m: int, k: int, n: int, *, out_dtype: torch.dtype = torch.int8,
         sm_count: int = SM_COUNT, aligned: bool = True) -> GemmPlan:
    """The geometry of one ``M × K × N`` call on a card with ``sm_count``
    SMs (``vta_gemm`` passes the operands' card's).

    * the tile: the largest of ``TILES`` (by area, then rows), no wider than
      the 16, 32 or 64 that covers N and no taller than the 16 … 128 that
      covers M, whose grid holds at least three quarters of a wave
      (``ceil(0.75 · sm_count)`` blocks); else 16 × 16.
    * ``k_split``: the block's K range is split so that it runs up to
      ``WARPS`` warps (8 / (bm / 16) groups of bm / 16 warps) while each
      group keeps two 32-byte K steps; under the 16 × 16 fallback, one.
    * ``load``: ``vec16`` (16-byte ``cp.async``) where K and N are
      multiples of 16 and the operands ``aligned`` to 16 bytes, else
      ``bytes`` (masked byte loads).
    * the ring: ``make_plan``'s, so that a LeNet-5 or resnet8 block issues
      its whole K range before its first product.

    The rule was chosen on one H100 over every tile and split at LeNet-5's
    and resnet8's shapes (PERF.md section 6): blocks of 8 warps beat more,
    smaller blocks, a grid under about three quarters of a wave leaves
    bandwidth unused, and where the grid is full a group with one K step
    costs more in the merge of partial sums than it saves.
    """
    cover_n = next((b for b in BNS if b >= n), BNS[-1])
    cover_m = next((b for b in BMS if b >= m), BMS[-1])
    tiles = [t for t in TILES if t[0] <= cover_m and t[1] <= cover_n]
    want = -(-3 * sm_count // 4)
    blocks = lambda t: -(-m // t[0]) * -(-n // t[1])
    full = [t for t in tiles if blocks(t) >= want]
    bm, bn = full[0] if full else tiles[-1]
    if -(-n // bn) > GRID_Y_LIMIT:
        raise ValueError(f"N = {n} needs {-(-n // bn)} column tiles, over "
                         f"the grid limit {GRID_Y_LIMIT}")
    steps = -(-k // KSTEP) // (2 if full else 1)
    k_split = max(s for s in K_SPLITS
                  if s <= max(1, min(WARPS // (bm // 16), steps)))
    load = ("vec16" if aligned and k % 16 == 0 and n % 16 == 0
            else "bytes")
    return make_plan(m, k, n, bm, bn, k_split, load, out_dtype)


def __getattr__(name: str):
    if name == "build_log":     # nvcc's report of the last build
        return KERNEL.build_log
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                   ndim: int, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vta_gemm(a: torch.Tensor, b: torch.Tensor,
             bias: Optional[torch.Tensor] = None, *,
             relu: bool = False, shift: int = 0, saturate: bool = True,
             out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: ``epilogue(A @ B + bias)``.

    ``a`` int8 (M, K), ``b`` int8 (K, N), ``bias`` int32 (N,) or None, all
    contiguous on one CUDA device; ragged M, N and K need no padding.
    Launches ``plan``'s geometry on the current stream and does not
    synchronise."""
    if a.device.type != "cuda":
        raise ValueError(f"vta_gemm launches on CUDA tensors, got {a.device}")
    dev = a.device
    _check_operand(a, "a", torch.int8, 2, dev)
    _check_operand(b, "b", torch.int8, 2, dev)
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"a {tuple(a.shape)} @ b {tuple(b.shape)}: K differs")
    n = b.shape[1]
    if bias is not None:
        _check_operand(bias, "bias", torch.int32, 1, dev)
        if bias.shape[0] != n:
            raise ValueError(f"bias has {bias.shape[0]} entries, N is {n}")
    if out_dtype not in (torch.int8, torch.int32):
        raise ValueError(f"out_dtype must be int8 or int32, got {out_dtype}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"GEMM {(m, k, n)} exceeds the kernel's int extents")
    if shift < 0:
        raise ValueError(f"shift must be >= 0, got {shift}")
    p = plan(m, k, n, out_dtype=out_dtype, sm_count=device_sm_count(dev),
             aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    _launch(a, b, bias, out, p, relu=relu, shift=shift, saturate=saturate)
    return out


def _launch(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
            out: torch.Tensor, p: GemmPlan, *, relu: bool = False,
            shift: int = 0, saturate: bool = True) -> None:
    """Launch plan ``p`` for checked CUDA operands into ``out`` (int8 or
    int32, contiguous).  Raises ``KernelLaunchError`` on a non-zero return:
    a plan the library has no instantiation for, or one that does not fit
    the operands, is refused before any launch."""
    m, k, n = p.shape
    fn = KERNEL.launcher()
    args = (a.data_ptr(), b.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            m, k, n, int(relu), min(shift, 31), int(saturate),
            int(out.dtype == torch.int8), ctypes.byref(p.c_plan),
            torch.cuda.current_stream(a.device).cuda_stream)
    if a.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:                       # launch from the operands' device context
        with torch.cuda.device(a.device):
            err = fn(*args)
    if err != 0:
        raise KernelLaunchError(
            f"vta_gemm launch failed: cudaError {err} at (M, K, N) = "
            f"{(m, k, n)}, tile {p.bm}x{p.bn}, k_split {p.k_split}, "
            f"{p.load} (a plan the library has no instantiation for is "
            f"refused with cudaErrorInvalidValue, 1)")
