"""Device selection for the port's entry points.

Every entry point runs on the CUDA card unless its caller names another
device (the CPU tests pass ``device="cpu"``).  With no device named and no
card present it raises :class:`NoDeviceError` — it never falls back to the
CPU on its own, so a run that was meant to measure the card cannot
silently measure the host instead.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

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
