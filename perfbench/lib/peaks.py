"""The table of peaks (``perfbench/peaks.json``), looked up by the card's
name."""

from __future__ import annotations

import pathlib
from typing import Optional

from .manifest import load_json

PEAKS = pathlib.Path(__file__).resolve().parents[1] / "peaks.json"


def peak(kind: str) -> Optional[dict]:
    """The peaks of the card whose name ``kind`` holds a key of the table,
    or None for a card the table lacks."""
    table = load_json(PEAKS)
    for key, row in table.items():
        if key in kind:
            return row
    return None
