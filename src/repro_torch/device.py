"""Device selection for the port's entry points.

Every entry point runs on the CUDA card unless its caller names another
device (the CPU tests pass ``device="cpu"``).  With no device named and no
card present it raises :class:`NoDeviceError` — it never falls back to the
CPU on its own, so a run that was meant to measure the card cannot
silently measure the host instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


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
