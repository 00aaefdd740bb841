"""Architecture registry: the 10 assigned archs + the paper's LeNet-5 +
the ~100M example config.

``get_config(arch_id)`` returns the full assigned configuration;
``get_smoke(arch_id)`` a reduced same-family config for CPU smoke tests.
``SHAPES`` are the assigned input shapes; ``runnable_cells()`` enumerates
the 40 (arch × shape) cells with the documented ``long_500k`` skips for
pure full-attention archs (DESIGN.md §Arch-applicability).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "whisper-base",
    "nemotron-4-340b",
    "qwen2.5-3b",
    "qwen1.5-110b",
    "gemma3-1b",
    "rwkv6-7b",
    "moonshot-v1-16b-a3b",
    "mixtral-8x22b",
    "internvl2-26b",
    "jamba-1.5-large-398b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_MODULES["lenet5"] = "lenet5"
_MODULES["lm100m"] = "lm100m"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs with sub-quadratic paths run long_500k; pure full-attention skip it
LONG_CONTEXT_ARCHS = {"rwkv6-7b", "jamba-1.5-large-398b", "gemma3-1b",
                      "mixtral-8x22b"}

# ≥100B parameters → 8-bit Adam + bf16 grad accumulation (DESIGN.md §4)
BIG_ARCHS = {"nemotron-4-340b", "qwen1.5-110b", "mixtral-8x22b",
             "jamba-1.5-large-398b"}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).full()


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


def cells(include_skips: bool = False) -> List[Tuple[str, str, Optional[str]]]:
    """All 40 (arch, shape, skip_reason) cells."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            skip = None
            if s == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                skip = ("pure full-attention architecture: 500k dense KV "
                        "is quadratic — skipped per assignment note")
            if skip is None or include_skips:
                out.append((a, s, skip))
    return out
