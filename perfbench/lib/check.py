"""The comparison that decides ``correct``.

Every call of the window returns the int8 logits of one batch of the
pool; the plain reference works the same batches out again.  A call's
answers are right only where every logit equals the reference's, so the
numbers compared are the count of logits that differ and the largest
difference, each with the limit 0 (an exact comparison).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def compare(outputs: Sequence[Tuple[int, np.ndarray]],
            refs: Sequence[np.ndarray]) -> Dict[str, int]:
    """``outputs``: ``(pool batch, logits)`` of every call; ``refs``: the
    reference's logits of each pool batch.  Returns the mismatched logits,
    the largest absolute difference, the images with any mismatch and the
    images compared, over all calls."""
    seen: List[Tuple[int, np.ndarray, Tuple[int, int, int]]] = []
    mismatched = worst = failed = images = 0
    for b, out in outputs:
        images += len(refs[b])
        stats = next((st for sb, so, st in seen
                      if sb == b and np.array_equal(so, out)), None)
        if stats is None and out.shape != refs[b].shape:
            # answers missing or of another shape: every one is wrong
            stats = (refs[b].size, 255, len(refs[b]))
        elif stats is None:
            d = np.abs(out.astype(np.int16) - refs[b].astype(np.int16))
            stats = (int((d > 0).sum()), int(d.max(initial=0)),
                     int((d.max(axis=1) > 0).sum()))
            seen.append((b, out, stats))
        mismatched += stats[0]
        worst = max(worst, stats[1])
        failed += stats[2]
    return {"mismatched_logits": mismatched, "max_abs_logit_diff": worst,
            "failed_images": failed, "images": images}


def judge(numbers: Dict[str, int], limits: Dict[str, int]
          ) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, {name: {"value", "limit"}})``: correct where every
    number is within its limit."""
    shown = {name: {"value": numbers[name], "limit": limit}
             for name, limit in limits.items()}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown
