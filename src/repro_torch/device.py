"""Device selection for the port's entry points.

Every entry point runs on the CUDA card unless its caller names another
device (the CPU tests pass ``device="cpu"``).  With no device named and no
card present it raises :class:`NoDeviceError` — it never falls back to the
CPU on its own, so a run that was meant to measure the card cannot
silently measure the host instead.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]
SM_COUNT = 132          # H100 SXM: what the kernels' plans assume without a card


class NoDeviceError(RuntimeError):
    """No device was named and no CUDA card is available."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions on the host")
    return torch.device("cuda", torch.cuda.current_device())


def device_of(device: Optional[torch.device]) -> str:
    """A stable cache key for a device (``cuda`` resolves to its index)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (the kernels' plans size grids by it)."""
    device = torch.device(device)
    return _device_sms(torch.cuda.current_device() if device.index is None
                       else device.index)


_strict_lock = threading.Lock()
_strict_open = 0            # scopes open now, in every thread
_strict_saved = None        # the flags the first of them found


@contextlib.contextmanager
def strict_float32() -> Iterator[None]:
    """float32 convolutions and products in float32, reproducibly.

    On a card cuDNN runs float32 convolutions in TF32 unless told not to,
    and may pick its algorithm by timing; inside this scope TF32 is off for
    cuDNN and cuBLAS, ``cudnn.benchmark`` is off and ``cudnn.deterministic``
    on.  The flags are process-wide, so scopes open at once (nested, or in
    serving threads) share them: the first to open sets them, the last to
    close restores what the first found."""
    global _strict_open, _strict_saved
    backends = torch.backends
    with _strict_lock:
        if _strict_open == 0:
            _strict_saved = (backends.cudnn.allow_tf32,
                             backends.cuda.matmul.allow_tf32,
                             backends.cudnn.benchmark,
                             backends.cudnn.deterministic)
            backends.cudnn.allow_tf32 = False
            backends.cuda.matmul.allow_tf32 = False
            backends.cudnn.benchmark = False
            backends.cudnn.deterministic = True
        _strict_open += 1
    try:
        yield
    finally:
        with _strict_lock:
            _strict_open -= 1
            if _strict_open == 0:
                (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
                 backends.cudnn.benchmark,
                 backends.cudnn.deterministic) = _strict_saved
