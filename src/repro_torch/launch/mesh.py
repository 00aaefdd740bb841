"""Process groups and device meshes (port of the reference's
``launch/mesh.py``).

``make_production_mesh`` and ``make_smoke_mesh`` are functions, not
module constants, so importing this module starts no process group.  A
mesh spans the default process group exactly: one whose size is not the
world size raises (asking for ``pod`` on four processes raises; a mesh is
never shrunk to fit).  :func:`init_distributed` starts that group:
``nccl`` for the card (each rank on the card its ``LOCAL_RANK`` names),
``gloo`` only when the caller names the CPU.  Its ``init_method`` and
``timeout`` are explicit — the tests hand it a ``file://`` store, so no
two runs race for a TCP port — and ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) stands in for them when
they are not given.  :func:`init_fake` starts the dry run's group
(``launch.dryrun``): 256 or 512 ranks in one process, nothing allocated.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def init_distributed(device: DeviceLike = None, *,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Start the default process group (once) and return this rank's
    device: ``cuda:LOCAL_RANK`` over ``nccl`` unless ``device`` names the
    CPU, then ``cpu`` over ``gloo``.  ``rank`` and ``world_size`` default
    to ``RANK`` / ``WORLD_SIZE`` (``torchrun`` sets them) and to a group
    of one; ``init_method`` to ``env://`` when ``MASTER_ADDR`` is set,
    else a TCP store on localhost for a group of one.  A group that does
    not form within ``timeout_s`` raises."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            from repro_torch.device import NoDeviceError
            raise NoDeviceError("a CUDA mesh needs a card; pass "
                                "device='cpu' for a gloo mesh on the host")
        local = _env_int("LOCAL_RANK") or 0
        if device is not None and torch.device(device).index is not None:
            local = torch.device(device).index
        torch.cuda.set_device(local)
        dev, backend = torch.device("cuda", local), "nccl"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f"; a {dev.type} mesh needs {backend}")
        return dev
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    rank = 0 if rank is None else rank
    world_size = 1 if world_size is None else world_size
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://localhost:{_free_port()}"
        else:
            raise ValueError("name an init_method (or run under torchrun) "
                             "for a group of several processes")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": dev} if backend == "nccl" else {}))
    return dev


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_fake(world_size: int) -> None:
    """The dry run's process group: a ``fake`` group of ``world_size``
    ranks in this one process, as rank 0 (the counterpart of the
    reference's ``--xla_force_host_platform_device_count``).  Its
    collectives move nothing; a mesh over it is a ``cpu`` mesh whose
    tensors the dry run keeps on ``meta``.  A fake group of another size
    is replaced; any other group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the process group runs "
                               f"{dist.get_backend()}; a dry run needs "
                               f"its own fake group")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def mesh_device_type() -> str:
    """``cuda`` over ``nccl``, ``cpu`` over ``gloo`` and the dry run's
    ``fake`` group."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the whole default
    process group (started by :func:`init_distributed`), on its backend's
    devices: the cards under ``nccl``, the CPU under ``gloo``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(launch.mesh.init_distributed)")
    size = 1
    for n in shape:
        size *= n
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {size} "
                         f"processes; the group has {world}")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def mesh_from_shape(text: str):
    """``"2x2"`` → a (data, model) mesh, ``"2x1x2"`` → (pod, data,
    model)."""
    shape = tuple(int(n) for n in text.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(shape))
    if axes is None:
        raise ValueError(f"--mesh-shape takes DxM or PxDxM, got {text!r}")
    return make_mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 (data, model) single pod; 2×16×16 (pod, data, model) for the
    512-device two-pod deployment."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_smoke_mesh():
    """1-device mesh with production axis names."""
    return make_mesh((1, 1), ("data", "model"))
