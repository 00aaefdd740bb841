"""VTA hardware configuration (paper §2.1).

The VTA is parameterised by ``block_size`` (default 16): INP/ACC/OUT are
vectors of ``block_size`` elements, WGT is a ``block_size × block_size``
matrix.  INP/WGT/OUT are int8, ACC is int32.  SRAM buffer capacities are the
VTA defaults quoted in §3.3: 2048 INP vectors, 1024 WGT matrices, 2048 ACC
vectors.

Two profiles ship with the framework:

* ``vta_default()``   — the paper's FPGA configuration (block 16), used for
  bit-exact reproduction of the paper's LeNet-5 results.
* ``vta_tpu()``       — the TPU-native "VTA-X" profile (block 128, MXU
  aligned), used by the Pallas kernel path (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VTAConfig:
    block_size: int = 16
    # SRAM capacities, in units of data *structures* (vectors / matrices).
    inp_buff_vectors: int = 2048
    wgt_buff_matrices: int = 1024
    acc_buff_vectors: int = 2048
    out_buff_vectors: int = 2048
    uop_buff_entries: int = 8192
    # DRAM paging (§2.2)
    page_bytes: int = 4096
    dram_offset: int = 0
    # Data types (§2.1)
    inp_dtype: np.dtype = np.dtype(np.int8)
    wgt_dtype: np.dtype = np.dtype(np.int8)
    out_dtype: np.dtype = np.dtype(np.int8)
    acc_dtype: np.dtype = np.dtype(np.int32)

    # ------------------------------------------------------------------
    # Structure geometry (Def. 1 terms)
    # ------------------------------------------------------------------
    @property
    def inp_elem_bytes(self) -> int:
        """Bytes of one INP vector (= precision × nb_elem of Def. 1)."""
        return self.block_size * self.inp_dtype.itemsize

    @property
    def wgt_elem_bytes(self) -> int:
        return self.block_size * self.block_size * self.wgt_dtype.itemsize

    @property
    def acc_elem_bytes(self) -> int:
        return self.block_size * self.acc_dtype.itemsize

    @property
    def out_elem_bytes(self) -> int:
        return self.block_size * self.out_dtype.itemsize

    @property
    def uop_elem_bytes(self) -> int:
        return 4

    @property
    def insn_elem_bytes(self) -> int:
        return 16

    def elem_bytes(self, mem: str) -> int:
        return {
            "inp": self.inp_elem_bytes,
            "wgt": self.wgt_elem_bytes,
            "acc": self.acc_elem_bytes,
            "out": self.out_elem_bytes,
            "uop": self.uop_elem_bytes,
            "insn": self.insn_elem_bytes,
        }[mem]

    def buffer_capacity(self, mem: str) -> int:
        return {
            "inp": self.inp_buff_vectors,
            "wgt": self.wgt_buff_matrices,
            "acc": self.acc_buff_vectors,
            "out": self.out_buff_vectors,
            "uop": self.uop_buff_entries,
        }[mem]


def vta_default() -> VTAConfig:
    """The paper's FPGA configuration (block_size=16)."""
    return VTAConfig()


def vta_tpu() -> VTAConfig:
    """TPU-native profile: 128×128 int8 blocks (MXU aligned), VMEM-scaled
    buffers (16 MiB VMEM per TensorCore >> the FPGA's SRAM)."""
    return VTAConfig(
        block_size=128,
        inp_buff_vectors=8192,
        wgt_buff_matrices=512,
        acc_buff_vectors=8192,
        out_buff_vectors=8192,
        uop_buff_entries=8192,
    )
