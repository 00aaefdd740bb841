"""Device-side §4.2 host reshaping: the serving path's staging in torch.

The reference stages every layer on the host in numpy between VTA
executions.  The port keeps the ``(B, nbytes)`` DRAM stack on the device
for the whole network, so the same four transformations run here in
torch, byte-identical to their numpy counterparts (pinned by
``tests/test_torch_lenet5.py``):

* :func:`im2row_batch`          — ``conv_lowering.im2row_batch``, and
  :func:`expand_rows_batch` — ``conv_lowering.expand_rows`` (a tiled
  pool's layout of the result rows) over the batch axis
* :func:`tensor2mat_batch`      — ``conv_lowering.tensor2mat`` over the
  batch axis, and :func:`residual_operand_batch` —
  ``layer_compiler.residual_operand_matrix`` over it (a residual layer's
  skip operand, staged as int32 into its ``res`` region)
* :func:`pad_matrix_batch` and :func:`matrix_blocks_batch` —
  ``layout.batch_matrix_to_binary``'s pad and split (int8 INP structures
  and int32 ACC-format ones)
* :func:`decode_out_region_batch` — ``simulator.decode_out_region_batch``
* :func:`decode_layer_output_batch` — ``layer_compiler.decode_layer_output``
  (``keep_rows`` extraction + ``mat2tensor``) over the batch axis.

Served, a layer's operand is not built by running these over its
producer's output: they run once per compiled network over an index tensor
(:func:`operand_table`, :func:`residual_table`), 1 + the stack-row byte
each element comes from (:func:`out_index`, or :func:`input_index` for
the network's input), so the padding's zeros mark the elements that are
zero.  The ``vta_stage`` kernel then gathers each batch's operand through
that table in one pass from the producer's OUT bytes.  The staging
functions keep the layout's one definition, and are the tests' reference
for the gather.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import device_of
from repro_torch.kernels.vta_stage import StageTable, make_table

from .conv_lowering import ConvGeometry
from .errors import CompileError
from .layout import pad_to_multiple, should_pad_height


def im2row_batch(tensor: torch.Tensor, kh: int, kw: int, stride: int = 1,
                 pad: int = 0) -> torch.Tensor:
    """``(B, C, H, W)`` → ``(B, H'·W', C·kh·kw)``: patch rows ordered
    (i, j) row-major, each patch flattened channel-major."""
    if tensor.dim() != 4:
        raise ValueError(f"expected (B, C, H, W) tensor, got "
                         f"{tuple(tensor.shape)}")
    b, c, h, w = tensor.shape
    geo = ConvGeometry(c, h, w, kh, kw, stride, pad)
    oh, ow = geo.out_h, geo.out_w
    if oh <= 0 or ow <= 0:
        raise ValueError("kernel larger than (padded) input")
    if pad < 0:
        raise ValueError(f"negative padding {pad}")
    x = F.pad(tensor, (pad, pad, pad, pad)) if pad else tensor
    win = x.unfold(2, kh, stride).unfold(3, kw, stride)  # (B,C,oh,ow,kh,kw)
    return win.permute(0, 2, 3, 1, 4, 5).reshape(b, oh * ow, geo.patch_len)


def tensor2mat_batch(tensor: torch.Tensor) -> torch.Tensor:
    """``(B, F, H, W)`` → ``(B, H·W, F)``: row ``b`` is
    ``conv_lowering.tensor2mat`` of the ``(1, F, H, W)`` tensor ``b``."""
    if tensor.dim() != 4:
        raise ValueError(f"expected (B, F, H, W) tensor, got "
                         f"{tuple(tensor.shape)}")
    b, f, h, w = tensor.shape
    return tensor.permute(0, 2, 3, 1).reshape(b, h * w, f)


def residual_operand_batch(spec, sems: torch.Tensor,
                           shape: Tuple[int, int]) -> torch.Tensor:
    """Skip activations → the ``(B, M, N)`` int32 second ACC operands of a
    residual layer: conv outputs ``(B, F, H, W)`` through
    :func:`tensor2mat_batch`, matrices ``(B, M, N)`` as they are — the
    geometry of ``layer_compiler.residual_operand_matrix``, with its
    ``residual-shape`` refusal."""
    mats = tensor2mat_batch(sems) if sems.dim() == 4 else sems
    if mats.dim() != 3 or tuple(mats.shape[1:]) != tuple(shape):
        raise CompileError(
            f"residual operand (shape {tuple(sems.shape[1:])}) does not "
            f"match the layer's {tuple(shape)} result", layer=spec.name,
            constraint="residual-shape")
    return mats.to(torch.int32)


def pad_matrix_batch(mats: torch.Tensor, block_size: int,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
    """Batched pad: ``(B, M, K)`` → the zero-padded ``(B, Mp, Kp)`` in
    ``dtype`` (the rules of ``layout.matrix_padding``: the height to a
    block multiple where the matrix has more than one row, the width
    always) and the height of a block row (``layout.matrix_splitting``)."""
    if mats.dim() != 3:
        raise ValueError(f"expected a (B, M, K) stack, got "
                         f"{tuple(mats.shape)}")
    b, h, w = mats.shape
    new_h = pad_to_multiple(h, block_size) if should_pad_height(
        mats[0]) else h
    new_w = pad_to_multiple(w, block_size)
    padded = torch.zeros((b, new_h, new_w), dtype=dtype, device=mats.device)
    padded[:, :h, :w] = mats
    return padded, block_size if new_h % block_size == 0 else new_h


def matrix_blocks_batch(padded: torch.Tensor, row_height: int,
                        block_size: int) -> torch.Tensor:
    """Batched split: padded ``(B, Mp, Kp)`` → ``(B, Mp·Kp)``, its blocks
    of ``row_height`` × ``block_size`` in row-major block order (§3.2)."""
    b, h, w = padded.shape
    blocks = padded.reshape(b, h // row_height, row_height,
                            w // block_size, block_size)
    return blocks.permute(0, 1, 3, 2, 4).reshape(b, -1)


def out_matrix_batch(raw: torch.Tensor, meta, block_size: int
                     ) -> torch.Tensor:
    """An OUT region's ``(B, nbytes)`` elements, of any dtype, in block
    order → the ``(B, M, N)`` valid matrix of ``meta`` (a program's
    ``output_meta``)."""
    rh = meta.row_height
    blocks = raw.reshape(raw.shape[0], meta.block_rows, meta.block_cols, rh,
                         block_size)
    full = blocks.permute(0, 1, 3, 2, 4).reshape(
        raw.shape[0], meta.block_rows * rh, meta.block_cols * block_size)
    m, n = meta.valid_shape
    return full[:, :m, :n]


def decode_out_region_batch(prog, dram_stack: torch.Tensor) -> torch.Tensor:
    """§4.2 stage (i) over a ``(B, nbytes)`` stack → ``(B, M, N)`` int8."""
    meta = prog.output_meta
    if meta is None:
        raise ValueError("program has no output metadata")
    region = prog.regions["out"]
    start = region.phys_addr - prog.allocator.offset
    raw = dram_stack[:, start:start + region.nbytes].view(torch.int8)
    return out_matrix_batch(raw, meta, prog.config.block_size)


def _keep_index(layer, device: torch.device) -> torch.Tensor:
    # racing threads may both build the index; each stores it whole
    cache: Dict[str, torch.Tensor] = layer.__dict__.setdefault(
        "_keep_rows_t", {})
    key = device_of(device)
    if key not in cache:
        cache[key] = torch.as_tensor(layer.keep_rows, dtype=torch.int64,
                                     device=device)
    return cache[key]


def _rows_index(layer, m: int, device: torch.device) -> torch.Tensor:
    """``layer.input_rows`` with each -1 made ``m``: the index of a zero
    row appended to the ``m`` im2row rows."""
    # racing threads may both build the index; each stores it whole
    cache: Dict[str, torch.Tensor] = layer.__dict__.setdefault(
        "_input_rows_t", {})
    key = device_of(device)
    if key not in cache:
        rows = torch.as_tensor(layer.input_rows, dtype=torch.int64)
        cache[key] = torch.where(rows < 0, m, rows).to(device)
    return cache[key]


def expand_rows_batch(layer, mats: torch.Tensor) -> torch.Tensor:
    """``(B, M, K)`` im2row matrices → the rows ``layer.input_rows`` names
    (``conv_lowering.expand_rows`` over the batch axis: -1 is a zero row);
    ``mats`` itself where the layer has none."""
    if layer.input_rows is None:
        return mats
    b, m, k = mats.shape
    padded = torch.cat([mats, mats.new_zeros((b, 1, k))], dim=1)
    return padded.index_select(1, _rows_index(layer, m, mats.device))


def decode_layer_output_batch(layer, out_mats: torch.Tensor) -> torch.Tensor:
    """Decoded ``(B, M, N)`` outputs → the layer's semantic outputs:
    conv → ``(B, F, H', W')`` (pooled rows extracted first), fc →
    ``(B, rows, F)``.  Row ``b`` of a conv result is the reference's
    ``(1, F, H', W')`` tensor without its leading axis."""
    if layer.keep_rows is not None:
        out_mats = out_mats.index_select(1, _keep_index(layer,
                                                        out_mats.device))
    if layer.spec.kind == "conv":
        b, rows, f = out_mats.shape
        if rows != layer.out_h * layer.out_w:
            raise ValueError(f"matrix rows {rows} incompatible with "
                             f"{layer.out_h}×{layer.out_w} output")
        return out_mats.reshape(b, layer.out_h, layer.out_w, f).permute(
            0, 3, 1, 2).contiguous()
    return out_mats.contiguous()


def input_matrices_batch(layer, sem: torch.Tensor) -> torch.Tensor:
    """(B, M, K) input matrices of ``layer`` from its source's semantic
    outputs: im2row (conv; its rows laid out as a tiled pool's
    ``input_rows`` name them) or NCHW flatten (fc)."""
    spec = layer.spec
    if spec.kind == "conv":
        _, _, kh, kw = spec.weights.shape
        return expand_rows_batch(layer, im2row_batch(
            sem, kh, kw, spec.stride, spec.padding))
    return sem.reshape(sem.shape[0], 1, -1)


def input_index(shape: Tuple[int, ...]) -> torch.Tensor:
    """1 + each byte of an input image of ``shape``, as a batch of one."""
    return (torch.arange(math.prod(shape), dtype=torch.int64) + 1).reshape(
        (1,) + tuple(shape))


def out_index(layer) -> torch.Tensor:
    """1 + the stack-row byte each element of ``layer``'s semantic output
    is read from: its OUT region's offsets, decoded as its OUT bytes are
    (:func:`out_matrix_batch`, :func:`decode_layer_output_batch`)."""
    prog = layer.program
    region = prog.regions["out"]
    start = region.phys_addr - prog.allocator.offset + 1
    raw = torch.arange(start, start + region.nbytes,
                       dtype=torch.int64).reshape(1, -1)
    return decode_layer_output_batch(
        layer, out_matrix_batch(raw, prog.output_meta,
                                prog.config.block_size))


def operand_table(layer, source: torch.Tensor,
                  block_size: int) -> StageTable:
    """The gather of ``layer``'s ``(Mp, Kp)`` GEMM operand, row-major,
    from ``source`` (:func:`out_index` or :func:`input_index` of the layer
    it reads): im2row or flatten, then the pad."""
    padded, _ = pad_matrix_batch(input_matrices_batch(layer, source),
                                 block_size, torch.int64)
    return make_table(padded[0] - 1, elem=1, rows=padded.shape[1])


def block_order(table: StageTable, row_height: int,
                block_size: int) -> StageTable:
    """An operand's gather taken in its INP region's block order (§3.2):
    the same entries, permuted."""
    index = table.index.to(torch.int64).reshape(1, table.rows, -1)
    index = matrix_blocks_batch(index, row_height, block_size)[0]
    return make_table(index, elem=1, rows=table.chunks)


def residual_table(layer, source: torch.Tensor,
                   block_size: int) -> StageTable:
    """The gather of ``layer``'s RES region, int32 elements in block
    order, from ``source`` (the index of the layer its skip reads)."""
    mats = residual_operand_batch(layer.spec, source,
                                  layer.residual_matrix.shape)
    padded, row_height = pad_matrix_batch(mats, block_size, torch.int64)
    index = matrix_blocks_batch(padded, row_height, block_size)[0] - 1
    return make_table(index, elem=4, rows=index.numel() // 4)
