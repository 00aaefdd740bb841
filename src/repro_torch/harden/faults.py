"""Seeded, deterministic fault injection for the VTA stack.

The port's copy of the reference's ``harden/faults.py``.  Models
single-event upsets (SEUs) at the three places the hardware holds state:

* **DRAM segments** (``dram-wgt`` / ``dram-uop`` / ``dram-bias``) — one bit
  flipped in a program's immutable weight/uop/bias(ACC) segment bytes.
  The flip bypasses ``VTAProgram.set_segment`` on purpose: ``set_segment``
  models an *authorised* host write (and refreshes the finalize-time CRC),
  whereas an SEU corrupts the bytes underneath the host's reference.
* **Instruction words** (``insn-bits`` / ``insn-field``) — ``insn-bits``
  flips a bit of the encoded 128-bit stream (what the device fetches);
  :meth:`FaultInjector.materialize` then re-decodes the corrupted bytes
  into the executable stream the simulators run, which may itself raise
  (an undecodable opcode is a loud fault).  ``insn-field`` mutates a field
  of an already-decoded instruction object — the segment bytes stay
  intact, so CRC passes and only the guards' decode→re-encode round-trip
  can catch it.
* **SRAM scratchpads** (``sram``) — a transient one-shot bit flip in a
  live simulator buffer at a chosen (layer, instruction) point, delivered
  through the ``fault_hook(sim, layer_idx, insn_idx)`` injection points of
  ``NetworkProgram.serve``/``serve_one``.  Because the hook fires once,
  a guarded retry models the transient correctly: the re-execution is
  clean.  The interpreters keep INP/WGT/ACC/OUT as torch tensors on their
  device and the UOP scratchpad on the host; the flip works on either.

Everything is driven by one ``numpy`` Generator seeded at construction —
not a torch generator — so a campaign draws the reference's plans, draw
for draw, and is exactly reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.core.fast_simulator import invalidate_plan

#: fault class -> corrupted DRAM segment (canonical key)
DRAM_CLASSES = {"dram-wgt": "wgt", "dram-uop": "uop", "dram-bias": "acc"}

FAULT_CLASSES = ("dram-wgt", "dram-uop", "dram-bias",
                 "insn-bits", "insn-field", "sram")

#: SRAM buffers a transient flip can land in
SRAM_BUFFERS = ("uop", "inp", "wgt", "acc", "out")

# Mutable integer fields per instruction kind, with their encoded widths
# (isa.py W0/W1 layouts) — the universe the ``insn-field`` class samples.
_INT_FIELDS = {
    isa.MemInsn: [("sram_base", 16), ("dram_base", 32), ("y_size", 16),
                  ("x_size", 16), ("x_stride", 16), ("y_pad_0", 4),
                  ("y_pad_1", 4), ("x_pad_0", 4), ("x_pad_1", 4)],
    isa.GemInsn: [("reset", 1), ("uop_bgn", 13), ("uop_end", 14),
                  ("iter_out", 14), ("iter_in", 14),
                  ("acc_factor_out", 11), ("acc_factor_in", 11),
                  ("inp_factor_out", 11), ("inp_factor_in", 11),
                  ("wgt_factor_out", 10), ("wgt_factor_in", 10)],
    isa.AluInsn: [("reset", 1), ("uop_bgn", 13), ("uop_end", 14),
                  ("iter_out", 14), ("iter_in", 14),
                  ("dst_factor_out", 11), ("dst_factor_in", 11),
                  ("src_factor_out", 11), ("src_factor_in", 11),
                  ("use_imm", 1), ("imm", 16)],
    isa.FinishInsn: [],
}

_DEP_FIELDS = ("pop_prev", "pop_next", "push_prev", "push_next")


@dataclasses.dataclass
class FaultSpec:
    """One planned injection — enough to apply it and to log the campaign.

    ``layer`` indexes ``net.layers``; the remaining fields are class-
    specific: ``target`` is a segment name (dram-*), SRAM buffer name
    (sram) or field name (insn-field); ``offset`` a byte/element offset;
    ``bit`` the flipped bit; ``insn_idx`` the instruction (insn-field);
    ``at_insn`` the firing point of a transient sram hook; ``value`` the
    mutated field value (insn-field)."""

    fault_class: str
    layer: int
    target: str = ""
    offset: int = 0
    bit: int = 0
    insn_idx: int = 0
    at_insn: int = 0
    value: int = 0

    def describe(self) -> str:
        if self.fault_class in DRAM_CLASSES:
            return (f"{self.fault_class}: layer {self.layer} segment "
                    f"{self.target!r} byte {self.offset} bit {self.bit}")
        if self.fault_class == "insn-bits":
            return (f"insn-bits: layer {self.layer} insn byte "
                    f"{self.offset} bit {self.bit}")
        if self.fault_class == "insn-field":
            return (f"insn-field: layer {self.layer} insn "
                    f"{self.insn_idx} field {self.target}={self.value}")
        return (f"sram: layer {self.layer} buf {self.target!r} elem "
                f"{self.offset} bit {self.bit} at insn {self.at_insn}")


def _flip_sram(sim, buffer: str, offset: int, bit: int) -> None:
    """Flip one bit of an SRAM buffer element, batched or not.

    UOP entries live as unpacked (acc, inp, wgt) triples in the simulator
    but are a packed 32-bit word in hardware, so the flip is applied to
    the packed form and unpacked back — a flip can therefore carry a
    field across its boundary exactly as on the device.  A buffer held as
    a torch tensor (on any device) takes the same flip, wrapped through
    int64 to its signed width as the reference wraps it."""
    buf = getattr(sim, f"{buffer}_buf")
    if buffer == "uop":
        flat = buf.reshape(-1, 3)
        row = flat[offset % flat.shape[0]]
        word = (int(row[0]) | (int(row[1]) << 11) | (int(row[2]) << 22))
        word ^= 1 << (bit % 32)
        row[0] = word & 0x7FF
        row[1] = (word >> 11) & 0x7FF
        row[2] = (word >> 22) & 0x3FF
        return
    flat = buf.reshape(-1)
    if isinstance(flat, torch.Tensor):
        i = offset % flat.numel()
        width = flat.element_size() * 8
        value = int(flat[i]) ^ (1 << (bit % width))
        half = 1 << (width - 1)
        flat[i] = (value + half) % (1 << width) - half
        return
    i = offset % flat.size
    width = flat.dtype.itemsize * 8
    mask = np.int64(1) << np.int64(bit % width)
    flat[i] = (np.int64(flat[i]) ^ mask).astype(flat.dtype)


class FaultInjector:
    """Plans and applies seeded faults against a ``NetworkProgram``."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------ plan --
    def _pick_layer(self, net, *, needs_segment: Optional[str] = None) -> int:
        candidates = [k for k, layer in enumerate(net.layers)
                      if needs_segment is None
                      or len(layer.program.segments.get(needs_segment, b""))]
        if not candidates:
            raise ValueError(f"no layer has segment {needs_segment!r}")
        return int(candidates[self.rng.integers(len(candidates))])

    def plan(self, net, fault_class: str) -> FaultSpec:
        """Draw one deterministic injection for ``fault_class``."""
        rng = self.rng
        if fault_class in DRAM_CLASSES:
            seg = DRAM_CLASSES[fault_class]
            k = self._pick_layer(net, needs_segment=seg)
            data = net.layers[k].program.segments[seg]
            return FaultSpec(fault_class=fault_class, layer=k, target=seg,
                             offset=int(rng.integers(len(data))),
                             bit=int(rng.integers(8)))
        if fault_class == "insn-bits":
            k = self._pick_layer(net, needs_segment="insn")
            data = net.layers[k].program.segments["insn"]
            return FaultSpec(fault_class="insn-bits", layer=k, target="insn",
                             offset=int(rng.integers(len(data))),
                             bit=int(rng.integers(8)))
        if fault_class == "insn-field":
            k = self._pick_layer(net)
            insns = net.layers[k].program.instructions
            # sample an instruction that has at least one mutable field
            for _ in range(64):
                idx = int(rng.integers(len(insns)))
                insn = insns[idx]
                fields = _INT_FIELDS[type(insn)]
                pool = [(name, width) for name, width in fields]
                pool += [(f"dep.{d}", 1) for d in _DEP_FIELDS]
                name, width = pool[int(rng.integers(len(pool)))]
                old = self._get_field(insn, name)
                value = self._mutate_value(rng, old, width,
                                           signed=(name == "imm"))
                if value != old:
                    return FaultSpec(fault_class="insn-field", layer=k,
                                     target=name, insn_idx=idx, value=value)
            raise RuntimeError("could not draw a field mutation")
        if fault_class == "sram":
            k = self._pick_layer(net)
            prog = net.layers[k].program
            buffer = SRAM_BUFFERS[int(rng.integers(len(SRAM_BUFFERS)))]
            # flip within the layer's *live* SRAM footprint — the default
            # buffers are far larger than what one layer touches, so a
            # uniform draw over full capacity would land in dead SRAM
            # nearly every time and measure nothing
            size = self._live_extent(prog, net.config).get(buffer, 0)
            if size == 0:       # layer never touches this scratchpad
                size = 1        # flip element 0: still a valid (dead) upset
            width = 32 if buffer in ("uop", "acc") else 8
            return FaultSpec(fault_class="sram", layer=k, target=buffer,
                             offset=int(rng.integers(size)),
                             bit=int(rng.integers(width)),
                             at_insn=int(rng.integers(
                                 len(prog.instructions))))
        raise ValueError(f"unknown fault class {fault_class!r}; "
                         f"expected one of {FAULT_CLASSES}")

    @staticmethod
    def _live_extent(prog, cfg) -> dict:
        """Max flip-unit index each scratchpad reaches in this layer
        (uop: entries; acc: int32 lanes; inp/wgt/out: bytes) — the live
        footprint a transient upset can actually perturb."""
        mul = {"uop": 1, "inp": cfg.block_size,
               "wgt": cfg.block_size ** 2, "acc": cfg.block_size,
               "out": cfg.block_size}
        names = {isa.MemId.UOP: "uop", isa.MemId.INP: "inp",
                 isa.MemId.WGT: "wgt", isa.MemId.ACC: "acc",
                 isa.MemId.OUT: "out"}
        extent: dict = {}
        for insn in prog.instructions:
            if not isinstance(insn, isa.MemInsn):
                continue
            name = names[insn.memory_type]
            if insn.opcode == isa.Opcode.LOAD:
                span = ((insn.y_pad_0 + insn.y_size + insn.y_pad_1)
                        * (insn.x_pad_0 + insn.x_size + insn.x_pad_1))
            else:
                span = insn.y_size * insn.x_size
            end = (insn.sram_base + span) * mul[name]
            extent[name] = max(extent.get(name, 0), end)
        # GEMM/ALU write ACC/OUT banks the MemInsns may not cover (e.g.
        # a store reads only part of what the lattice produced); the ACC
        # load extent is the dominant bound in every compiled program,
        # so the MemInsn scan is a sound, simple proxy.
        return extent

    @staticmethod
    def _get_field(insn, name: str) -> int:
        if name.startswith("dep."):
            return int(getattr(insn.dep, name[4:]))
        return int(getattr(insn, name))

    @staticmethod
    def _set_field(insn, name: str, value: int) -> None:
        if name.startswith("dep."):
            setattr(insn.dep, name[4:], value)
        else:
            setattr(insn, name, value)

    @staticmethod
    def _mutate_value(rng, old: int, width: int, *,
                      signed: bool = False) -> int:
        if width == 1:
            return 1 - old
        # flip one encoded bit of the field — a minimal, in-width upset
        value = (old & ((1 << width) - 1)) ^ (1 << int(rng.integers(width)))
        if signed and value >= 1 << (width - 1):
            value -= 1 << width       # AluInsn.imm is signed 16-bit
        return value

    # ----------------------------------------------------------- apply --
    def apply(self, net, spec: FaultSpec) -> None:
        """Mutate program state per ``spec`` (sram specs use
        :meth:`hook_for` instead — they fire mid-run)."""
        prog = net.layers[spec.layer].program
        if spec.fault_class in DRAM_CLASSES or spec.fault_class == "insn-bits":
            seg = spec.target
            data = bytearray(prog.segments[seg])
            data[spec.offset] ^= 1 << spec.bit
            prog.segments[seg] = bytes(data)   # SEU: bypasses set_segment
        elif spec.fault_class == "insn-field":
            self._set_field(prog.instructions[spec.insn_idx], spec.target,
                            spec.value)
            invalidate_plan(prog)
        elif spec.fault_class == "sram":
            pass                               # delivered via hook_for
        else:
            raise ValueError(spec.fault_class)

    def materialize(self, net, spec: FaultSpec) -> None:
        """Model the device *fetching* a corrupted instruction segment:
        re-decode the (possibly flipped) bytes into the executable stream.
        Raises ``ValueError`` when the corrupted bytes are undecodable —
        a loud fault on its own."""
        if spec.fault_class != "insn-bits":
            return
        prog = net.layers[spec.layer].program
        prog.instructions = isa.decode_stream(prog.segments["insn"])
        invalidate_plan(prog)

    def hook_for(self, spec: FaultSpec) -> Optional[Callable]:
        """A one-shot network-level ``hook(sim, layer_idx, insn_idx)``
        delivering a transient SRAM flip; None for non-sram classes."""
        if spec.fault_class != "sram":
            return None
        state = {"fired": False}

        def hook(sim, layer_idx: int, insn_idx: int) -> None:
            if (state["fired"] or layer_idx != spec.layer
                    or insn_idx != spec.at_insn):
                return
            state["fired"] = True
            _flip_sram(sim, spec.target, spec.offset, spec.bit)

        return hook

    def inject(self, net, fault_class: str
               ) -> Tuple[FaultSpec, Optional[Callable]]:
        """Plan + apply in one call; returns ``(spec, hook)`` where the
        hook is non-None only for the transient ``sram`` class."""
        spec = self.plan(net, fault_class)
        self.apply(net, spec)
        return spec, self.hook_for(spec)


def estimate_footprint(instructions) -> int:
    """Worst-case per-instruction work estimate (lattice points / moved
    elements) from the *fields alone* — no allocation.  The unguarded
    campaign arm uses it to classify corrupted programs whose geometry
    explodes (a 2^28-point lattice) as hangs/resource exhaustion instead
    of executing them; the guards reject the same programs statically
    (constraint ``lattice-footprint``)."""
    worst = 0
    for insn in instructions:
        if isinstance(insn, isa.MemInsn):
            rows = insn.y_pad_0 + insn.y_size + insn.y_pad_1
            row_w = insn.x_pad_0 + insn.x_size + insn.x_pad_1
            worst = max(worst, rows * row_w)
        elif isinstance(insn, (isa.GemInsn, isa.AluInsn)):
            n_uop = max(0, insn.uop_end - insn.uop_bgn)
            worst = max(worst, insn.iter_out * insn.iter_in * n_uop)
    return worst


__all__ = ["DRAM_CLASSES", "FAULT_CLASSES", "SRAM_BUFFERS", "FaultInjector",
           "FaultSpec", "estimate_footprint"]
