"""Public wrappers around the ``vta_gemm`` and ``flash_attention`` kernels.

A CPU tensor goes to the plain torch version (``ref.vta_gemm_ref``,
``ref.attention_ref``); a CUDA tensor launches the hand-written kernel or
raises — there is no fallback from one to the other.  ``launches`` counts
kernel launches made through :func:`vta_matmul` and ``attention_launches``
the attention kernels launched (``flash_attention.launches``: the count
the C entry points report), so a run can show that its main path went
through the kernels.

The attention kernel has no backward (nor has the reference's).  Under
grad it is launched through :func:`with_plain_backward`: the output
carries a ``grad_fn`` whose backward recomputes the attention through a
plain version under grad and backpropagates through that, so the kernel
path's gradients are the plain path's.  :func:`attention` on CUDA
operands that require grad, outside it, raises rather than return an
output that gradients would skip.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

from repro_torch.core.errors import CompileError

from . import flash_attention as _flash
from . import ref as _ref
from . import vta_gemm as _vta_gemm

_BACKENDS = ("auto", "cuda", "torch")

launches = 0            # kernel launches made by vta_matmul
# serving workers launch from several threads at once: ``launches += 1`` is
# a read-modify-write, so it is taken under this lock
_launches_lock = threading.Lock()


def _count_launch() -> None:
    global launches
    with _launches_lock:
        launches += 1


def reset_launches() -> None:
    global launches
    with _launches_lock, _flash.launches_lock:
        launches = 0
        _flash.launches = 0


def __getattr__(name: str):
    if name == "attention_launches":    # counted where the kernels launch
        return _flash.launches
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(
            f"kernel backend must be one of {_BACKENDS}, got {backend!r}")


def vta_matmul(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               relu: bool = False, shift: int = 0, saturate: bool = True,
               out_dtype: torch.dtype = torch.int8,
               backend: str = "auto") -> torch.Tensor:
    """Fused W8A8 GEMM ``epilogue(A @ B + bias)`` (the VTA datapath).

    backend: ``"auto"`` picks by the tensors' device, ``"cuda"`` requires
    CUDA tensors (kernel), ``"torch"`` requires CPU tensors (plain)."""
    _check_backend(backend)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise CompileError(
            f"incompatible GEMM operand shapes {tuple(a.shape)} @ "
            f"{tuple(b.shape)}", constraint="kernel-gemm-shape")
    if a.device.type == "cpu":
        if backend == "cuda":
            raise ValueError("backend='cuda' launches the kernel and needs "
                             "CUDA tensors; got CPU tensors")
        return _ref.vta_gemm_ref(a, b, bias, relu=relu, shift=shift,
                                 saturate=saturate, out_dtype=out_dtype)
    if backend == "torch":
        raise ValueError("backend='torch' is the plain version for CPU "
                         f"tensors; got {a.device} (call "
                         f"ref.vta_gemm_ref directly to compare on the card)")
    out = _vta_gemm.vta_gemm(a, b, bias, relu=relu, shift=shift,
                             saturate=saturate, out_dtype=out_dtype)
    _count_launch()
    return out


Attention = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                     torch.Tensor]
# the profiler range around the plain recompute and backward of the op
PLAIN_BACKWARD_RANGE = "attention_plain_backward"


class _PlainBackward(torch.autograd.Function):
    """``launch``'s output with ``plain``'s gradients (q, k, v saved)."""

    @staticmethod
    def forward(ctx, q, k, v, launch: Attention, plain: Attention):
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        return launch(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), \
                torch.profiler.record_function(PLAIN_BACKWARD_RANGE):
            out = ctx.plain(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None, None)


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def with_plain_backward(launch: Attention, plain: Attention,
                        q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """``launch(q, k, v)``; where grad is enabled and an operand requires
    it, through an ``autograd.Function`` whose backward recomputes
    ``plain(q, k, v)`` under grad and backpropagates through it.  The
    forward runs ``launch`` once, as without grad: the kernel's launches
    are counted where they happen, one call's worth per forward (and per
    recompute of a checkpointed block around it)."""
    if _needs_grad(q, k, v):
        return _PlainBackward.apply(q, k, v, launch, plain)
    return launch(q, k, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: Optional[float] = None,
              window: Optional[int] = None, q_offset: int = 0,
              backend: str = "auto") -> torch.Tensor:
    """Flash attention with GQA: ``q`` (B, H, Sq, D), ``k``/``v``
    (B, Hkv, Skv, D) with H % Hkv == 0; output (B, H, Sq, D) in q's dtype.
    On CUDA tensors the path is ``flash_attention.plan``'s: float32 on
    split-TF32 ``mma.sync`` tensor-core products, bfloat16 on the ``wgmma``
    tiles or the split-KV decode path; ``attention_launches`` rises by every kernel the call launches
    (2 where a combine kernel follows a split), as the library reports.
    Any head dim up to 256 is taken: one the kernel has no instantiation
    for runs zero-padded to the next (``flash_attention.call_padded``).

    ``q_offset`` is the absolute position of ``q[..., 0, :]`` (chunked
    prefill, decode); ``window`` keeps keys with ``q_pos - k_pos <
    window``.  backend: ``"auto"`` picks by the tensors' device, ``"cuda"``
    requires CUDA tensors (kernel), ``"torch"`` requires CPU tensors
    (plain).  The kernel has no backward: under grad, launch it through
    :func:`with_plain_backward` (``layers.attention`` does)."""
    _check_backend(backend)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"attention takes 4-D q and k, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    h, hkv = q.shape[1], k.shape[1]
    if hkv == 0 or h % hkv:
        raise CompileError(
            f"{h} query heads do not group over {hkv} KV heads",
            constraint="kernel-gqa-heads")
    if q.device.type == "cpu":
        if backend == "cuda":
            raise ValueError("backend='cuda' launches the kernel and needs "
                             "CUDA tensors; got CPU tensors")
        return _ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                  window=window, q_offset=q_offset)
    if backend == "torch":
        raise ValueError("backend='torch' is the plain version for CPU "
                         f"tensors; got {q.device} (call "
                         f"ref.attention_ref directly to compare on the card)")
    if _needs_grad(q, k, v):
        raise RuntimeError("the attention kernel has no backward: launch it "
                           "through ops.with_plain_backward under grad")
    return _flash.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                  window=window, q_offset=q_offset)
