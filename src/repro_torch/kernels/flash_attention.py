"""Plan, build, load and launch the hand-written ``flash_attention`` kernels.

They replace the reference's Pallas ``flash_attention``: float32 inputs run
on ``csrc/flash_attention.cu`` (``f32``: split-TF32 ``mma.sync`` tensor-core
products, a ``cp.async`` K/V ring), bfloat16 inputs on
``csrc/flash_attention_bf16.cu`` (``wgmma`` prefill tiles, or a split-KV
decode path that packs a GQA group); a path that splits the keys is
followed by a combine kernel.  :func:`plan` names the path, tiles, grid,
shared memory and launch count of a call; the C entry points launch exactly
that geometry or refuse it, and report the kernels they launched, which
``launches`` counts.  Both sources are compiled with ``nvcc`` for
``sm_90a`` at first use and loaded with ``ctypes``, as ``build.py``
describes.  With ``return_lse`` a call also gives each row's float32
log-sum-exp (-inf for a row that keeps no key), written by the kernel that
writes the output (the same plan and launches), and the output in float32
whatever the inputs' dtype: one rank's part of a decode over a
sequence-sharded cache, which the ranks weigh and sum before it is
rounded.  The plain torch versions are ``ref.attention_ref`` and
``ref.attention_lse_ref``; ``ops.attention`` picks between them by the
tensors' device.

Nothing here runs at import time: the CPU tests import this module on a
host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import threading
from typing import Optional, Tuple

import torch

from repro_torch.core.errors import CompileError
from repro_torch.device import SM_COUNT, device_sm_count

from . import build as _build
from .build import KernelBuildError, KernelLaunchError  # noqa: F401

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SOURCE_BF16 = SOURCE.with_name("flash_attention_bf16.cu")
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 192, 256)
DTYPES = (torch.float32, torch.bfloat16)
_GRID_LIMIT = 65535                 # gridDim.y (heads) and gridDim.z (batch)
_POSITION_LIMIT = 1 << 62           # |window|, |q_offset|: no int64 overflow

PATHS = ("f32", "bf16_tiles", "bf16_split")     # codes 0, 1, 2 in C


class _CPlan(ctypes.Structure):
    """An ``AttentionPlan`` as both C entry points take it (``struct Plan``
    in ``csrc/*.cu``)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "path", "block_q", "block_kv", "stages", "splits", "chunk", "smem",
        "gx", "gy", "gz")]


# Both entry points take (q, k, v, o, scratch, lse, B, H, Hkv, Sq, Skv, D,
# causal, has_window, window, q_offset, sm_scale, plan, launched, stream);
# lse may be null.
_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
         + [ctypes.c_longlong] * 2
         + [ctypes.c_float, ctypes.POINTER(_CPlan),
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
KERNEL = _build.Kernel(SOURCE, "flash_attention_launch", _ARGS)
KERNEL_BF16 = _build.Kernel(SOURCE_BF16, "flash_attention_bf16_launch",
                            _ARGS)
KERNELS = (KERNEL, KERNEL_BF16)
build = KERNEL.build
library_path = KERNEL.library_path

launches = 0    # kernels launched, as the C entry points report them
# serving workers launch from several threads at once: ``launches += n``
# is a read-modify-write, so it is taken under this lock
launches_lock = threading.Lock()


def _count_launches(n: int) -> None:
    global launches
    with launches_lock:
        launches += n

# The tiles each path takes; the libraries hold the instantiations below
# (bf16: one per head dim) and refuse any other geometry (csrc/*.cu,
# ``struct Plan``).
SMEM_LIMIT = 232_448            # shared memory a block may use
# f32: the library's instantiations, one a head dim, (D, q rows = 16 a
# warp, keys a tile, K/V stages) -> (Q fragments held in registers, blocks
# an SM); and the tiles plan takes per head dim, D -> (q rows, keys, stages).
F32_INSTANTIATIONS = {
    (16, 64, 64, 2): (True, 2), (32, 64, 64, 2): (True, 2),
    (64, 128, 64, 2): (True, 1), (128, 64, 32, 2): (False, 1),
    (192, 64, 16, 2): (False, 1), (256, 64, 16, 2): (False, 1)}
F32_TILES = {d: (bq, bk, st) for d, bq, bk, st in F32_INSTANTIATIONS}
TILE_Q = 128                    # bf16_tiles: two warpgroups of 64 rows
TILE_KV = {16: 128, 32: 128, 64: 128, 128: 128, 192: 64, 256: 64}
SPLIT_ROWS = 16                 # bf16_split: one m16 tile of packed rows
SPLIT_TILE = 64                 # keys a stage
BF16_STAGES = {16: 3, 32: 3, 64: 3, 128: 3, 192: 3, 256: 2}  # K/V ring, both


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How one call runs: the problem ``shape`` (B, H, Hkv, Sq, Skv, D),
    its ``path`` (``"f32"``, ``"bf16_tiles"`` or ``"bf16_split"``), q rows
    and keys per tile, K/V stages, KV splits and keys per split (``chunk``,
    bf16_split path).  The grid, dynamic shared memory, kernels launched (a
    combine kernel follows a split) and float32 scratch follow from these;
    the C entry point launches exactly this geometry or refuses it."""
    shape: Tuple[int, int, int, int, int, int]
    path: str
    block_q: int
    block_kv: int
    stages: int = 1
    splits: int = 1
    chunk: int = 0

    @property
    def grid(self) -> Tuple[int, int, int]:
        b, h, hkv, sq, _, _ = self.shape
        qtiles = -(-sq // self.block_q)
        if self.path in ("f32", "bf16_tiles"):
            return (qtiles * self.splits * h * b, 1, 1)
        return (self.splits, hkv, b)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def smem_bytes(self) -> int:
        d, bq, bk = self.shape[5], self.block_q, self.block_kv
        if self.path == "f32":         # [Q] + ring of (K, V) + K lo, V lo
            qreg = self.f32_instance[0]
            return 4 * (d + 4) * ((0 if qreg else bq)
                                  + (2 * self.stages + 2) * bk)
        if self.path == "bf16_tiles":       # 1 KB for the 1024-byte alignment
            return 1024 + 2 * bq * d + self.stages * 2 * 2 * bk * d
        return self.stages * 2 * bk * (d + 8) * 2

    @property
    def launches(self) -> int:
        return 1 if self.path != "bf16_split" and self.splits == 1 else 2

    @property
    def scratch_floats(self) -> int:
        """Float32 partials (acc[D], m, l per row and split), 0 if none."""
        b, h, _, sq, _, d = self.shape
        return self.splits * b * h * sq * (d + 2) if self.launches == 2 else 0

    @property
    def f32_instance(self) -> Tuple[bool, int]:
        """f32: (Q in registers, blocks an SM) of the library's
        instantiation for this geometry (Q from shared memory and one block
        where it has none: the library refuses the plan)."""
        key = (self.shape[5], self.block_q, self.block_kv, self.stages)
        return F32_INSTANTIATIONS.get(key, (False, 1))

    def c_plan(self) -> _CPlan:
        return _CPlan(PATHS.index(self.path), self.block_q, self.block_kv,
                      self.stages, self.splits, self.chunk, self.smem_bytes,
                      *self.grid)


def kept_range(sq: int, skv: int, causal: bool, window: Optional[int],
               q_offset: int) -> Tuple[int, int]:
    """The keys [lo, hi) that some query row can keep (lo >= hi: none)."""
    lo, hi = 0, skv
    if causal:
        hi = min(hi, q_offset + sq)
    if window is not None:
        lo = max(lo, q_offset - window + 1)
    return lo, hi


def _f32_splits(base: int, lo: int, hi: int, bk: int, slots: int) -> int:
    """KV splits for a q-tile grid of ``base`` blocks over the keys [lo,
    hi) on a card that holds ``slots`` blocks at once: 1 where the grid
    fills the slots, else the fewest splits that minimise waves × KV tiles
    a block (``ceil(blocks / slots) × ceil(tiles / splits)``), counting
    only splits that get a tile."""
    if base >= slots or lo >= hi:
        return 1
    tiles = (hi - 1) // bk - lo // bk + 1
    best_cost, best = base * tiles + 1, 1
    for s in range(1, tiles + 1):
        per = -(-tiles // s)
        used = -(-tiles // per)
        cost = -(-base * used // slots) * per
        if cost < best_cost:
            best_cost, best = cost, used
    return best


def plan(b: int, h: int, hkv: int, sq: int, skv: int, d: int,
         dtype: torch.dtype, causal: bool = True,
         window: Optional[int] = None, q_offset: int = 0,
         sm_count: int = SM_COUNT) -> AttentionPlan:
    """The path and launch geometry of one attention call on a card with
    ``sm_count`` SMs (``flash_attention`` passes the operands' card's).

    * float32 → ``f32``: split-TF32 products on ``mma.sync`` at every head
      dim, tiles ``F32_TILES[d]``: 128 q rows (8 warps of 16) and 64-key
      tiles at D = 64, 64 rows and 64, 32 or 16 keys at the other head dims
      (at D = 256 the accumulator takes 128 registers a thread); a
      one-dimensional grid of ``ceil(Sq/block_q) × splits × H × B`` blocks,
      heaviest causal q tiles first.  Where the q-tile grid holds fewer
      blocks than the card runs at once (SMs × the instantiation's blocks an
      SM), the KV range is split by ``_f32_splits``: the fewest splits that
      minimise waves × KV tiles a block (whisper-base's 448 × 1500
      cross-attention: 32 q-tile blocks, 4 splits of 6 tiles, one wave).
      One launch, two where it splits (the combine).
    * bfloat16 whose packed rows ``group × Sq`` fit one 16-row tile →
      ``bf16_split`` (decode): grid ``(splits, Hkv, B)``, each block reads
      its KV chunk once for the whole GQA group.  The chunk is a multiple
      of 64 keys, sized so the grid holds about two waves of the SMs over
      the keys the masks can keep; splits are counted from key 0, so
      splits before a window's first key are empty.  Two launches (the
      split kernel and the combine).
    * other bfloat16 → ``bf16_tiles``: 128-row q tiles (two ``wgmma``
      warpgroups), a one-dimensional grid of ``ceil(Sq/128) × splits × H
      × B`` blocks, heaviest causal q tiles first.  Where the q-tile grid
      fills at most half of the SMs (the chunked prefill: 64 blocks), each
      q tile's KV range is split so the grid holds about two waves, at
      least two KV tiles a split; the combine then makes two launches.  A
      grid between half and one wave (gemma3's local layer: 128 blocks) is
      not split: one block an SM already runs, so a split adds no parallel
      work, only a float32 round trip of the partials.
    """
    shape = (b, h, hkv, sq, skv, d)
    lo, hi = kept_range(sq, skv, causal, window, q_offset)
    if dtype == torch.float32:
        bq, bk, stages = F32_TILES[d]
        base = -(-sq // bq) * h * b
        slots = sm_count * F32_INSTANTIATIONS[(d, bq, bk, stages)][1]
        splits = _f32_splits(base, lo, hi, bk, slots)
        if base * splits >= 2 ** 31:
            raise ValueError(f"{base * splits} blocks exceed the grid limit")
        return AttentionPlan(shape, "f32", bq, bk, stages, splits)
    if dtype != torch.bfloat16:
        raise ValueError(f"no attention path for {dtype}")
    if (h // hkv) * sq <= SPLIT_ROWS:
        span = max(0, hi - (max(lo, 0) // SPLIT_TILE) * SPLIT_TILE)
        want = max(1, -(-2 * sm_count // (hkv * b)))
        chunk = SPLIT_TILE * max(1, -(-span // (want * SPLIT_TILE)))
        splits = max(1, -(-min(hi, skv) // chunk)) if hi > 0 else 1
        return AttentionPlan(shape, "bf16_split", SPLIT_ROWS, SPLIT_TILE,
                             BF16_STAGES[d], splits, chunk)
    bk = TILE_KV[d]
    base = -(-sq // TILE_Q) * h * b
    splits = 1
    if 2 * base <= sm_count and lo < hi:
        kv_tiles = (hi - 1) // bk - lo // bk + 1
        splits = max(1, min(-(-2 * sm_count // base), kv_tiles // 2))
    if base * splits >= 2 ** 31:
        raise ValueError(f"{base * splits} blocks exceed the grid limit")
    return AttentionPlan(shape, "bf16_tiles", TILE_Q, bk, BF16_STAGES[d],
                         splits)


def __getattr__(name: str):
    if name == "build_log":     # nvcc's report of the last build
        return KERNEL.build_log
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def check_inputs(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """What the kernel takes, checked before any launch; returns
    ``(B, H, Hkv, Sq, Skv, D)``.  Raises ``ValueError`` (``CompileError``
    ``kernel-gqa-heads`` when H is not a multiple of Hkv)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"q, k and v must all be float32 or all "
                             f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} needs k and v of shape "
                         f"({b}, Hkv, Skv, {d}); got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(b, h, hkv, sq) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if h % hkv:
        raise CompileError(
            f"{h} query heads do not group over {hkv} KV heads",
            constraint="kernel-gqa-heads")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes "
                         f"{SUPPORTED_HEAD_DIMS} (flash_attention pads any "
                         f"other D up to {SUPPORTED_HEAD_DIMS[-1]})")
    if max(b, h) > _GRID_LIMIT:
        raise ValueError(f"batch {b} or heads {h} exceed the grid limit "
                         f"{_GRID_LIMIT}")
    if max(sq, skv) >= 2 ** 31:
        raise ValueError(f"sequence lengths {(sq, skv)} exceed the kernel's "
                         f"int extents")
    return b, h, hkv, sq, skv, d


def check_alignment(*tensors: torch.Tensor) -> None:
    """TMA and 16-byte loads need 16-byte aligned data; a contiguous view
    can still start at an odd storage offset.  Raises ``ValueError``."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"tensor data at {t.data_ptr():#x} is not "
                             f"16-byte aligned (storage offset "
                             f"{t.storage_offset()})")


def padded_head_dim(d: int) -> int:
    """The head dim the kernel runs a call of head dim ``d`` at: the
    smallest of ``SUPPORTED_HEAD_DIMS`` that is at least ``d``.  Raises
    ``ValueError`` above the largest."""
    for dp in SUPPORTED_HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"head dim {d} exceeds the kernel's largest, "
                     f"{SUPPORTED_HEAD_DIMS[-1]}")


def call_padded(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                sm_scale: Optional[float] = None, **kw):
    """``fn(q, k, v, sm_scale=..., **kw)`` at ``padded_head_dim(D)``: q, k
    and v get zero columns along D up to it, the scale stays ``D**-0.5``
    unless given, and the output is sliced back to D.  Exact: a zero
    column adds nothing to Q·Kᵀ or to P·V.  An output pair ``(o, lse)``
    (``return_lse``) has only o sliced: the scores, and so lse, are the
    unpadded call's.  Operands whose head dims differ, or that the kernel
    takes as they are, go to ``fn`` unchanged (``check_inputs`` then names
    what is wrong)."""
    d = q.shape[-1]
    if q.dim() != 4 or k.shape[-1] != d or v.shape[-1] != d:
        return fn(q, k, v, sm_scale=sm_scale, **kw)
    dp = padded_head_dim(d)
    if dp == d:
        return fn(q, k, v, sm_scale=sm_scale, **kw)
    pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))
    out = fn(pad(q), pad(k), pad(v),
             sm_scale=d ** -0.5 if sm_scale is None else sm_scale, **kw)
    if isinstance(out, tuple):
        return out[0][..., :d].contiguous(), out[1]
    return out[..., :d].contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    window: Optional[int] = None, q_offset: int = 0,
                    return_lse: bool = False):
    """Launch the kernels of ``plan``'s path on CUDA tensors: attention of
    ``q`` (B, H, Sq, D) over ``k``/``v`` (B, Hkv, Skv, D), output in q's
    dtype; with ``return_lse`` the pair ``(output, lse)``, the output in
    float32 (not rounded to bf16) and lse the float32 (B, H, Sq)
    log-sum-exp of each row's kept scaled scores (-inf where a row keeps
    none), from the same launches.

    A head dim the kernel has no instantiation for (any D ≤ 256) runs at
    ``padded_head_dim(D)`` through :func:`call_padded`; ``plan`` and the
    launches are those of the padded call.  Ragged Sq and Skv need no
    padding.  Launches on the current stream and does not synchronise.  A
    path that splits the keys writes float32 partials to a
    ``torch.empty`` scratch on q's device; the caching allocator keeps it
    from being reused before the launch on this stream has read it."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA tensors, got "
                         f"{q.device}")
    return call_padded(_flash_attention, q, k, v, sm_scale=sm_scale,
                       causal=causal, window=window, q_offset=q_offset,
                       return_lse=return_lse)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, sm_scale: Optional[float],
                     window: Optional[int], q_offset: int,
                     return_lse: bool = False):
    b, h, hkv, sq, skv, d = check_inputs(q, k, v)
    for name, val in (("window", window or 0), ("q_offset", q_offset)):
        if abs(int(val)) >= _POSITION_LIMIT:
            raise ValueError(f"{name}={val} is out of range")
    p = plan(b, h, hkv, sq, skv, d, q.dtype, causal, window, q_offset,
             device_sm_count(q.device))
    out = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
           if return_lse else torch.empty_like(q))
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32,
                           device=q.device) if p.scratch_floats else None)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _launch(q, k, v, out, scratch, p, causal=causal, sm_scale=sm_scale,
            window=window, q_offset=q_offset, lse=lse)
    return (out, lse) if return_lse else out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, scratch: Optional[torch.Tensor],
            p: AttentionPlan, *, causal: bool = True,
            sm_scale: Optional[float] = None, window: Optional[int] = None,
            q_offset: int = 0, lse: Optional[torch.Tensor] = None) -> None:
    """Launch plan ``p`` for checked CUDA operands, writing ``out`` (in q's
    dtype, float32 where ``lse`` is given), each row's log-sum-exp to
    ``lse`` (float32 (B, H, Sq), contiguous) where it is given and, on a
    path that splits the keys, the float32 partials to ``scratch`` (acc,
    then (m, l) pairs, as both ``csrc`` sources lay them out).
    Adds the kernels the library reports launched to ``launches``; raises
    ``KernelLaunchError`` on a non-zero return."""
    b, h, hkv, sq, skv, d = p.shape
    if p.scratch_floats and (scratch is None
                             or scratch.dtype != torch.float32
                             or scratch.numel() < p.scratch_floats
                             or not scratch.is_contiguous()):
        raise ValueError(f"plan needs {p.scratch_floats} contiguous float32 "
                         f"elements of scratch")
    if lse is not None and (lse.dtype != torch.float32
                            or tuple(lse.shape) != (b, h, sq)
                            or not lse.is_contiguous()
                            or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 tensor of shape "
                         f"{(b, h, sq)} on {q.device}")
    out_dtype = q.dtype if lse is None else torch.float32
    if (out.dtype != out_dtype or tuple(out.shape) != tuple(q.shape)
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {out_dtype} tensor of "
                         f"shape {tuple(q.shape)}")
    check_alignment(q, k, v, out, *([scratch] if p.scratch_floats else []))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (b, h, hkv, sq, skv, d, int(causal), int(window is not None),
              int(window or 0), int(q_offset),
              float(d ** -0.5 if sm_scale is None else sm_scale),
              ctypes.byref(p.c_plan()))
    done = ctypes.c_int(0)
    fn = (KERNEL if p.path == "f32" else KERNEL_BF16).launcher()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if p.scratch_floats else None,
            None if lse is None else lse.data_ptr(), *common,
            ctypes.byref(done), stream)
    if q.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:                       # launch from the operands' device context
        with torch.cuda.device(q.device):
            err = fn(*args)
    _count_launches(done.value)
    if err != 0:
        raise KernelLaunchError(
            f"flash_attention launch failed: cudaError {err} at "
            f"(B, H, Hkv, Sq, Skv, D) = {p.shape}, {q.dtype}, {p.path} "
            f"(a plan the library has no instantiation for is refused "
            f"with cudaErrorInvalidValue, 1)")
