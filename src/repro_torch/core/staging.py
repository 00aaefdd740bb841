"""Device-side §4.2 host reshaping: the serving path's staging in torch.

The reference stages every layer on the host in numpy between VTA
executions.  The port keeps the ``(B, nbytes)`` DRAM stack on the device
for the whole network, so the same four transformations run here in
torch, byte-identical to their numpy counterparts (pinned by
``tests/test_torch_lenet5.py``):

* :func:`im2row_batch`          — ``conv_lowering.im2row_batch``
* :func:`tensor2mat_batch`      — ``conv_lowering.tensor2mat`` over the
  batch axis, and :func:`residual_operand_batch` —
  ``layer_compiler.residual_operand_matrix`` over it (a residual layer's
  skip operand, staged as int32 into its ``res`` region)
* :func:`batch_matrix_to_binary` — ``layout.batch_matrix_to_binary``
  (int8 INP structures and int32 ACC-format ones)
* :func:`decode_out_region_batch` — ``simulator.decode_out_region_batch``
* :func:`decode_layer_output_batch` — ``layer_compiler.decode_layer_output``
  (``keep_rows`` extraction + ``mat2tensor``) over the batch axis.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import device_of

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


def batch_matrix_to_binary(mats: torch.Tensor, block_size: int,
                           dtype: torch.dtype) -> torch.Tensor:
    """Batched pad → split → binarise: ``(B, M, K)`` → ``(B, nbytes)``
    uint8, blocks in row-major block order (§3.2), each element ``dtype``
    (int8 INP, int32 ACC) in little-endian bytes: the uint8 view of an
    int32 tensor is its memory, little-endian on the host and the card."""
    if mats.dim() != 3:
        raise ValueError(f"expected a (B, M, K) stack, got "
                         f"{tuple(mats.shape)}")
    b, h, w = mats.shape
    # the geometry rules of layout.matrix_padding / matrix_splitting
    new_h = pad_to_multiple(h, block_size) if should_pad_height(
        mats[0]) else h
    new_w = pad_to_multiple(w, block_size)
    row_height = block_size if new_h % block_size == 0 else new_h
    br, bc = new_h // row_height, new_w // block_size
    padded = torch.zeros((b, new_h, new_w), dtype=dtype, device=mats.device)
    padded[:, :h, :w] = mats
    blocks = padded.reshape(b, br, row_height, bc, block_size)
    raw = blocks.permute(0, 1, 3, 2, 4).contiguous()  # block-major
    return raw.view(torch.uint8).reshape(b, -1)


def decode_out_region_batch(prog, dram_stack: torch.Tensor) -> torch.Tensor:
    """§4.2 stage (i) over a ``(B, nbytes)`` stack → ``(B, M, N)`` int8."""
    cfg = prog.config
    meta = prog.output_meta
    if meta is None:
        raise ValueError("program has no output metadata")
    region = prog.regions["out"]
    start = region.phys_addr - prog.allocator.offset
    raw = dram_stack[:, start:start + region.nbytes].view(torch.int8)
    bs = cfg.block_size
    rh = meta.row_height
    b = dram_stack.shape[0]
    blocks = raw.reshape(b, meta.block_rows, meta.block_cols, rh, bs)
    full = blocks.permute(0, 1, 3, 2, 4).reshape(
        b, meta.block_rows * rh, meta.block_cols * bs)
    m, n = meta.valid_shape
    return full[:, :m, :n]


def _keep_index(layer, device: torch.device) -> torch.Tensor:
    # racing threads may both build the index; each stores it whole
    cache: Dict[str, torch.Tensor] = layer.__dict__.setdefault(
        "_keep_rows_t", {})
    key = device_of(device)
    if key not in cache:
        cache[key] = torch.as_tensor(layer.keep_rows, dtype=torch.int64,
                                     device=device)
    return cache[key]


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
