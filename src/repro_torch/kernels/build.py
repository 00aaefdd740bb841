"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library and loaded
with ``ctypes``.  The build happens at first use, into
``build/repro_torch/`` at the root of the checkout, and is keyed by a hash
of the source and the flags, so a fresh checkout builds each kernel once
and an edited source rebuilds.  ``nvcc`` is looked up in
``$CUDA_HOME/bin``, then on ``PATH``, then in ``/usr/local/cuda/bin``; if
none has it the build raises.

Nothing here runs at import time: the CPU tests import the kernel modules
on a host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Sequence

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SYSTEM_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """The CUDA launch was refused (non-zero ``cudaGetLastError``)."""


def find_nvcc(system_nvcc: pathlib.Path = SYSTEM_NVCC) -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(pathlib.Path(on_path))
    candidates.append(system_nvcc)
    for path in candidates:
        if path.is_file():
            return str(path)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        f"{system_nvcc.parent}); the CUDA kernels cannot be built")


class Kernel:
    """One ``csrc/*.cu`` kernel: its hash-keyed build, nvcc's report of the
    last build (``build_log``: ptxas registers, shared memory, spills) and
    its C entry point ``symbol``, loaded once and returning an int."""

    def __init__(self, source: pathlib.Path, symbol: str,
                 argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.build_dir = BUILD_DIR
        self.system_nvcc = SYSTEM_NVCC
        self.build_log = ""
        self._lock = threading.Lock()
        self._fn = None

    def library_path(self) -> pathlib.Path:
        """Where the library lives: ``lib<stem>_<hash>.so``."""
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        return self.build_dir / f"lib{self.source.stem}_{digest}.so"

    def build(self) -> pathlib.Path:
        """Compile the source unless a library for it exists."""
        so = self.library_path()
        if so.exists():
            return so
        nvcc = find_nvcc(self.system_nvcc)
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)         # atomic: concurrent builders agree
        self.build_log = proc.stdout + proc.stderr
        return so

    def launcher(self):
        """The loaded C function, built first if need be."""
        with self._lock:
            if self._fn is None:
                fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn
