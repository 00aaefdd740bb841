"""Fault injection + runtime integrity guards.

The port's copy of the reference's ``harden`` package.  The source paper
deploys the VTA in safety-critical aeronautics under
certification constraints; this subsystem supplies the robustness layer
such a deployment demands:

* :mod:`repro_torch.harden.faults` — a seeded, deterministic
  :class:`FaultInjector` that corrupts DRAM segments, SRAM scratchpads
  mid-run and encoded instruction words, through the ``fault_hook``
  injection points of the instruction interpreters (the ``cuda`` backend
  has no instruction stream to hook and refuses one).
* :mod:`repro_torch.harden.guards` — CRC32 verification of immutable DRAM
  segments against the reference captured at ``VTAProgram.finalize()``,
  a pre-execution instruction-stream validator (decode→re-encode
  round-trip + static bounds/hazard checks), a per-serve watchdog
  deadline, and the :class:`GuardPolicy`-driven restore-and-retry
  recovery used by ``NetworkProgram.serve``/``serve_one``.

The reference's seeded campaign (detected / masked / silent data
corruption per fault class) runs on the card as phase 14 of
``chip_smoke.py``.
"""

from .faults import FAULT_CLASSES, FaultInjector, FaultSpec
from .guards import (GoldenImage, GuardPolicy, GuardReport, Watchdog,
                     WatchdogTimeout, capture_golden, guarded_serve,
                     guarded_serve_one, restore_network, validate_network,
                     validate_program, verify_network)

__all__ = [
    "FAULT_CLASSES", "FaultInjector", "FaultSpec",
    "GoldenImage", "GuardPolicy", "GuardReport", "Watchdog",
    "WatchdogTimeout", "capture_golden", "guarded_serve",
    "guarded_serve_one", "restore_network", "validate_network",
    "validate_program", "verify_network",
]
