"""VTA program container + binary emission (paper §3.1, Fig. 5).

A ``VTAProgram`` bundles everything the compiler produces for one VTA
execution: the DRAM allocation, the data segments (INP/WGT/ACC/OUT/UOP/INSN
regions), the instruction stream and the UOPs, plus the metadata needed to
decode the result (§4.2 reshaping).  ``write_binaries`` emits the six binary
files of Fig. 5 (``input.bin``, ``weight.bin``, ``accumulator.bin``,
``uop.bin``, ``instructions.bin``, ``expected_out.bin``).
"""

from __future__ import annotations

import dataclasses
import pathlib
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import isa
from .dram import DramAllocator, Region
from .hwconfig import VTAConfig


@dataclasses.dataclass
class OutputMeta:
    """Geometry needed to decode the OUT region back into a matrix."""

    block_rows: int        # α
    block_cols: int        # β
    row_height: int        # block_size, or 1 for single-row matrices
    valid_shape: Tuple[int, int]   # unpadded (M, N) of the result


@dataclasses.dataclass
class VTAProgram:
    """One VTA execution.  ``regions`` maps the canonical region keys
    (inp/wgt/acc/out/uop/insn) to :class:`Region` handles — the allocator
    may be shared across the programs of a multi-layer network (§4.2), in
    which case the allocator-level names carry a per-layer prefix while the
    canonical keys stay stable."""

    config: VTAConfig
    allocator: DramAllocator
    instructions: List[object] = dataclasses.field(default_factory=list)
    uops: List[isa.Uop] = dataclasses.field(default_factory=list)
    regions: Dict[str, Region] = dataclasses.field(default_factory=dict)
    # canonical region key -> raw little-endian bytes
    segments: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    output_meta: Optional[OutputMeta] = None
    expected_out: Optional[np.ndarray] = None
    name: str = "program"
    # The compiler's SRAM tiling (a gemm_compiler.ChunkPlan) — observability
    # for the §3.3 chunk loop (n_chunks, segment geometry); None for
    # hand-written instruction streams.
    chunk_plan: Optional[object] = None
    # Which task-level pipeline schedule the token stream implements
    # ("serialized" or "pipelined", DESIGN.md §Pipeline).  A requested
    # "pipelined" compile that falls back (buffers too small to
    # double-buffer) records "serialized" here.
    schedule: str = "serialized"
    # The ALU post-op spec the instruction stream implements (the
    # gemm_compiler AluSpec tuple) — the semantic record the pallas
    # backend lowers from (DESIGN.md §2).  ``None`` (hand-written
    # streams) marks the program as not pallas-executable.
    alu_ops: Optional[Tuple] = None
    # What the ALU program computes, for the spans ("join", "gap",
    # "join+gap", "pool2x2", "maxpool3x3s2"); None where the compiler of a
    # layer set none (the program fuses into the GEMM, or no layer made it)
    alu_kind: Optional[str] = None
    # CRC32 of every segment, captured by finalize() — the integrity
    # reference the harden/ guards verify serves against (DESIGN.md
    # §Hardening).  Segment bytes are immutable, so the values stay valid
    # until a segment is replaced via set_segment (which refreshes them).
    segment_crcs: Dict[str, int] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    def region(self, name: str) -> Region:
        return self.regions[name]

    def set_segment(self, name: str, data: bytes) -> None:
        region = self.regions[name]
        if len(data) > region.nbytes:
            raise ValueError(
                f"segment {name!r}: {len(data)} bytes exceeds region size "
                f"{region.nbytes}")
        self.segments[name] = data
        if self.segment_crcs:
            self.segment_crcs[name] = zlib.crc32(data)

    def finalize(self) -> None:
        """Encode UOPs + instructions into their DRAM segments.

        The instruction region is allocated here (last, per the TVM
        reference order) because its size is only known once instruction
        generation has finished.  Also captures the per-segment CRC32
        reference values the runtime integrity guards verify against
        (DESIGN.md §Hardening).
        """
        self.set_segment("uop", isa.encode_uops(self.uops))
        if "insn" not in self.regions:
            self.regions["insn"] = self.allocator.alloc(
                f"{self.name}:insn", "insn", self.config.insn_elem_bytes,
                len(self.instructions))
        self.set_segment("insn", isa.encode_stream(self.instructions))
        self.segment_crcs = {name: zlib.crc32(data)
                             for name, data in self.segments.items()}

    # ------------------------------------------------------------------
    def dram_image(self) -> np.ndarray:
        """Materialise the full DRAM image (uint8) with every segment
        placed at its physical address."""
        image = np.zeros(self.allocator.image_size(), dtype=np.uint8)
        self.place_segments(image)
        return image

    def place_segments(self, image: np.ndarray) -> None:
        """Copy this program's segments into a (possibly shared) image."""
        for name, data in self.segments.items():
            region = self.regions[name]
            start = region.phys_addr - self.allocator.offset
            image[start:start + len(data)] = np.frombuffer(data, dtype=np.uint8)

    # ------------------------------------------------------------------
    def gemm_loops(self) -> int:
        """The §5.1 metric: loops of non-reset GeMM instructions (i.e. the
        loops that perform multiplications)."""
        return sum(i.loop_count for i in self.instructions
                   if isinstance(i, isa.GemInsn) and not i.reset)

    def alu_loops(self) -> int:
        return sum(i.loop_count for i in self.instructions
                   if isinstance(i, isa.AluInsn))

    def counts(self) -> Dict[str, int]:
        from collections import Counter
        c: Dict[str, int] = Counter()
        for i in self.instructions:
            if isinstance(i, isa.MemInsn):
                key = f"{i.opcode.name.lower()}_{i.memory_type.name.lower()}"
            else:
                key = type(i).__name__.replace("Insn", "").lower()
            c[key] += 1
        return dict(c)

    # ------------------------------------------------------------------
    _BIN_NAMES = {
        "inp": "input.bin",
        "wgt": "weight.bin",
        "acc": "accumulator.bin",
        "uop": "uop.bin",
        "insn": "instructions.bin",
    }

    def write_binaries(self, directory: str | pathlib.Path) -> Dict[str, pathlib.Path]:
        """Emit the Fig. 5 binary files."""
        directory = pathlib.Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        written: Dict[str, pathlib.Path] = {}
        for name, data in self.segments.items():
            region = self.regions[name]
            fname = self._BIN_NAMES.get(region.kind, f"{name}.bin")
            path = directory / fname
            path.write_bytes(data)
            written[name] = path
        if self.expected_out is not None:
            path = directory / "expected_out.bin"
            path.write_bytes(np.ascontiguousarray(self.expected_out).tobytes())
            written["expected_out"] = path
        return written
