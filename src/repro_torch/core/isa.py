"""VTA instruction-set architecture: bit-level encode/decode.

Faithful to the VTA hardware spec (tvm/vta ``hw_spec.h``) referenced by the
paper (§2.3): 128-bit CISC instructions packed as two little-endian 64-bit
words, and 32-bit micro-ops (UOPs).  All field widths below are the VTA
defaults; the paper's Fig. 3/4 show the GeMM instruction and UOP layouts.

Instruction classes
-------------------
* ``MemInsn``  — LOAD / STORE (DRAM <-> SRAM, 2-D strided access + padding)
* ``GemInsn``  — TensorGemm (Algorithm 1 of the paper)
* ``AluInsn``  — TensorAlu  (element-wise MIN/MAX/ADD/SHR, optional immediate)
* ``FinishInsn`` — termination marker

Every instruction carries the 4 dependency flags (``DEPT_FLAG`` of §2.3)
used to synchronise the Fetch/Load/Compute/Store modules.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import ClassVar, Dict, List, Sequence, Tuple

INSN_BYTES = 16   # 128-bit instructions
UOP_BYTES = 4     # 32-bit UOPs


class Opcode(enum.IntEnum):
    LOAD = 0
    STORE = 1
    GEMM = 2
    FINISH = 3
    ALU = 4


class MemId(enum.IntEnum):
    """SRAM buffer identifiers for LOAD/STORE ``memory_type``."""

    UOP = 0
    WGT = 1
    INP = 2
    ACC = 3
    OUT = 4


class AluOp(enum.IntEnum):
    MIN = 0
    MAX = 1
    ADD = 2
    SHR = 3   # arithmetic shift right


# ---------------------------------------------------------------------------
# Bit packing helpers
# ---------------------------------------------------------------------------

def _pack(fields: Sequence[Tuple[int, int]]) -> int:
    """Pack ``(value, width)`` pairs LSB-first into one integer."""
    word = 0
    pos = 0
    for value, width in fields:
        if value < 0 or value >= (1 << width):
            raise ValueError(f"field value {value} does not fit in {width} bits")
        word |= value << pos
        pos += width
    return word


def _unpack(word: int, widths: Sequence[int]) -> List[int]:
    out = []
    pos = 0
    for width in widths:
        out.append((word >> pos) & ((1 << width) - 1))
        pos += width
    return out


@dataclasses.dataclass
class DepFlags:
    """The 4-bit DEPT_FLAG of §2.3: producer/consumer queue tokens."""

    pop_prev: int = 0
    pop_next: int = 0
    push_prev: int = 0
    push_next: int = 0

    def bits(self) -> List[Tuple[int, int]]:
        return [(self.pop_prev, 1), (self.pop_next, 1),
                (self.push_prev, 1), (self.push_next, 1)]

    @classmethod
    def from_bits(cls, vals: Sequence[int]) -> "DepFlags":
        return cls(*vals)


# ---------------------------------------------------------------------------
# Instructions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MemInsn:
    """LOAD/STORE: move ``y_size`` rows of ``x_size`` elements (stride
    ``x_stride``) between DRAM (logical ``dram_base``) and SRAM
    (``sram_base``), with optional zero-padding on either side."""

    opcode: Opcode
    memory_type: MemId
    sram_base: int
    dram_base: int
    y_size: int
    x_size: int
    x_stride: int
    y_pad_0: int = 0
    y_pad_1: int = 0
    x_pad_0: int = 0
    x_pad_1: int = 0
    dep: DepFlags = dataclasses.field(default_factory=DepFlags)

    # word0: opcode(3) dep(4) memory_type(3) sram_base(16) dram_base(32)
    # word1: y_size(16) x_size(16) x_stride(16) y_pad_0(4) y_pad_1(4)
    #        x_pad_0(4) x_pad_1(4)
    W0: ClassVar[List[int]] = [3, 1, 1, 1, 1, 3, 16, 32]
    W1: ClassVar[List[int]] = [16, 16, 16, 4, 4, 4, 4]

    def encode(self) -> bytes:
        w0 = _pack([(int(self.opcode), 3)] + self.dep.bits() +
                   [(int(self.memory_type), 3), (self.sram_base, 16),
                    (self.dram_base, 32)])
        w1 = _pack([(self.y_size, 16), (self.x_size, 16), (self.x_stride, 16),
                    (self.y_pad_0, 4), (self.y_pad_1, 4),
                    (self.x_pad_0, 4), (self.x_pad_1, 4)])
        return w0.to_bytes(8, "little") + w1.to_bytes(8, "little")

    @classmethod
    def decode(cls, raw: bytes) -> "MemInsn":
        w0 = int.from_bytes(raw[:8], "little")
        w1 = int.from_bytes(raw[8:], "little")
        f0 = _unpack(w0, cls.W0)
        f1 = _unpack(w1, cls.W1)
        return cls(opcode=Opcode(f0[0]), dep=DepFlags.from_bits(f0[1:5]),
                   memory_type=MemId(f0[5]), sram_base=f0[6], dram_base=f0[7],
                   y_size=f1[0], x_size=f1[1], x_stride=f1[2],
                   y_pad_0=f1[3], y_pad_1=f1[4], x_pad_0=f1[5], x_pad_1=f1[6])


@dataclasses.dataclass
class GemInsn:
    """TensorGemm instruction (paper Fig. 3 / Algorithm 1).

    ``iter_out``/``iter_in`` are LP_OUT/LP_IN; the six factors are the
    address increments of Algorithm 1 lines 5/7/8 (ACC/INP/WGT × OUT/IN).
    """

    reset: int = 0
    uop_bgn: int = 0
    uop_end: int = 0
    iter_out: int = 1
    iter_in: int = 1
    acc_factor_out: int = 0   # dst_factor_out
    acc_factor_in: int = 0    # dst_factor_in
    inp_factor_out: int = 0   # src_factor_out
    inp_factor_in: int = 0    # src_factor_in
    wgt_factor_out: int = 0
    wgt_factor_in: int = 0
    dep: DepFlags = dataclasses.field(default_factory=DepFlags)

    # word0: opcode(3) dep(4) reset(1) uop_bgn(13) uop_end(14)
    #        iter_out(14) iter_in(14)
    # word1: dst_out(11) dst_in(11) src_out(11) src_in(11) wgt_out(10) wgt_in(10)
    W0: ClassVar[List[int]] = [3, 1, 1, 1, 1, 1, 13, 14, 14, 14]
    W1: ClassVar[List[int]] = [11, 11, 11, 11, 10, 10]

    opcode: ClassVar[Opcode] = Opcode.GEMM

    def encode(self) -> bytes:
        w0 = _pack([(int(Opcode.GEMM), 3)] + self.dep.bits() +
                   [(self.reset, 1), (self.uop_bgn, 13), (self.uop_end, 14),
                    (self.iter_out, 14), (self.iter_in, 14)])
        w1 = _pack([(self.acc_factor_out, 11), (self.acc_factor_in, 11),
                    (self.inp_factor_out, 11), (self.inp_factor_in, 11),
                    (self.wgt_factor_out, 10), (self.wgt_factor_in, 10)])
        return w0.to_bytes(8, "little") + w1.to_bytes(8, "little")

    @classmethod
    def decode(cls, raw: bytes) -> "GemInsn":
        w0 = int.from_bytes(raw[:8], "little")
        w1 = int.from_bytes(raw[8:], "little")
        f0 = _unpack(w0, cls.W0)
        f1 = _unpack(w1, cls.W1)
        return cls(dep=DepFlags.from_bits(f0[1:5]), reset=f0[5],
                   uop_bgn=f0[6], uop_end=f0[7], iter_out=f0[8], iter_in=f0[9],
                   acc_factor_out=f1[0], acc_factor_in=f1[1],
                   inp_factor_out=f1[2], inp_factor_in=f1[3],
                   wgt_factor_out=f1[4], wgt_factor_in=f1[5])

    @property
    def loop_count(self) -> int:
        """GeMM loops executed by this instruction (the §5.1 metric)."""
        return self.iter_out * self.iter_in * max(0, self.uop_end - self.uop_bgn)


@dataclasses.dataclass
class AluInsn:
    """TensorAlu instruction: element-wise ops over ACC vectors."""

    alu_opcode: AluOp = AluOp.ADD
    reset: int = 0
    uop_bgn: int = 0
    uop_end: int = 0
    iter_out: int = 1
    iter_in: int = 1
    dst_factor_out: int = 0
    dst_factor_in: int = 0
    src_factor_out: int = 0
    src_factor_in: int = 0
    use_imm: int = 0
    imm: int = 0
    dep: DepFlags = dataclasses.field(default_factory=DepFlags)

    W0: ClassVar[List[int]] = [3, 1, 1, 1, 1, 1, 13, 14, 14, 14]
    W1: ClassVar[List[int]] = [11, 11, 11, 11, 2, 1, 16]

    opcode: ClassVar[Opcode] = Opcode.ALU

    def encode(self) -> bytes:
        imm16 = self.imm & 0xFFFF  # two's complement 16-bit immediate
        w0 = _pack([(int(Opcode.ALU), 3)] + self.dep.bits() +
                   [(self.reset, 1), (self.uop_bgn, 13), (self.uop_end, 14),
                    (self.iter_out, 14), (self.iter_in, 14)])
        w1 = _pack([(self.dst_factor_out, 11), (self.dst_factor_in, 11),
                    (self.src_factor_out, 11), (self.src_factor_in, 11),
                    (int(self.alu_opcode), 2), (self.use_imm, 1), (imm16, 16)])
        return w0.to_bytes(8, "little") + w1.to_bytes(8, "little")

    @classmethod
    def decode(cls, raw: bytes) -> "AluInsn":
        w0 = int.from_bytes(raw[:8], "little")
        w1 = int.from_bytes(raw[8:], "little")
        f0 = _unpack(w0, cls.W0)
        f1 = _unpack(w1, cls.W1)
        imm = f1[6]
        if imm >= 1 << 15:   # sign-extend
            imm -= 1 << 16
        return cls(dep=DepFlags.from_bits(f0[1:5]), reset=f0[5],
                   uop_bgn=f0[6], uop_end=f0[7], iter_out=f0[8], iter_in=f0[9],
                   dst_factor_out=f1[0], dst_factor_in=f1[1],
                   src_factor_out=f1[2], src_factor_in=f1[3],
                   alu_opcode=AluOp(f1[4]), use_imm=f1[5], imm=imm)

    @property
    def loop_count(self) -> int:
        return self.iter_out * self.iter_in * max(0, self.uop_end - self.uop_bgn)


@dataclasses.dataclass
class FinishInsn:
    dep: DepFlags = dataclasses.field(default_factory=DepFlags)
    opcode: ClassVar[Opcode] = Opcode.FINISH

    def encode(self) -> bytes:
        w0 = _pack([(int(Opcode.FINISH), 3)] + self.dep.bits())
        return w0.to_bytes(8, "little") + (0).to_bytes(8, "little")

    @classmethod
    def decode(cls, raw: bytes) -> "FinishInsn":
        w0 = int.from_bytes(raw[:8], "little")
        f0 = _unpack(w0, [3, 1, 1, 1, 1])
        return cls(dep=DepFlags.from_bits(f0[1:]))


Instruction = (MemInsn, GemInsn, AluInsn, FinishInsn)


def decode_insn(raw: bytes):
    """Decode one 128-bit instruction by opcode."""
    opcode = Opcode(int.from_bytes(raw[:8], "little") & 0b111)
    if opcode in (Opcode.LOAD, Opcode.STORE):
        return MemInsn.decode(raw)
    if opcode == Opcode.GEMM:
        return GemInsn.decode(raw)
    if opcode == Opcode.ALU:
        return AluInsn.decode(raw)
    return FinishInsn.decode(raw)


def encode_stream(insns) -> bytes:
    return b"".join(i.encode() for i in insns)


def decode_stream(raw: bytes):
    if len(raw) % INSN_BYTES:
        raise ValueError("instruction stream not a multiple of 16 bytes")
    return [decode_insn(raw[i:i + INSN_BYTES]) for i in range(0, len(raw), INSN_BYTES)]


# ---------------------------------------------------------------------------
# UOPs (paper Fig. 4 / Fig. 8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Uop:
    """32-bit micro-op: initial SRAM logical addresses for ACC/INP/WGT.

    For ALU instructions the fields are reused as (dst_idx, src_idx, -).
    """

    acc_idx: int = 0
    inp_idx: int = 0
    wgt_idx: int = 0

    W: ClassVar[List[int]] = [11, 11, 10]

    def encode(self) -> bytes:
        return _pack([(self.acc_idx, 11), (self.inp_idx, 11),
                      (self.wgt_idx, 10)]).to_bytes(4, "little")

    @classmethod
    def decode(cls, raw: bytes) -> "Uop":
        return cls(*_unpack(int.from_bytes(raw, "little"), cls.W))


def encode_uops(uops) -> bytes:
    return b"".join(u.encode() for u in uops)


def decode_uops(raw: bytes):
    if len(raw) % UOP_BYTES:
        raise ValueError("uop stream not a multiple of 4 bytes")
    return [Uop.decode(raw[i:i + UOP_BYTES]) for i in range(0, len(raw), UOP_BYTES)]
