"""The comparison that decides ``correct`` for a training cell.

Both sides follow the same first optimizer steps from the same weights and
batches. Three numbers are compared, each against its own limit:

- ``loss``: the widest relative gap of a step's loss, |l - l_ref| / |l_ref|;
- ``grad``: the first clipped gradient as the optimizer gets it, by the
  worst leaf: the gap between the two norms of a leaf, not the norm of their
  difference, over the larger of the reference's norm of that leaf and of
  the median leaf;
- ``change``: the same for the norm of each leaf's change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).

A limit of ``None`` means the number is printed and not compared.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

NUMBERS = ("loss", "grad", "change")


def _worst(got: Dict[str, float], ref: Dict[str, float], keep) -> float:
    names = [n for n in ref if keep(n)]
    med = statistics.median(ref[n] for n in names)
    return max(abs(got[n] - ref[n]) / max(ref[n], med) if max(ref[n], med) > 0 else 0.0
               for n in names)


def numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    """``got`` and ``ref``: {"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    if len(got["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, got["losses"])):
        loss = math.inf
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    return {"loss": loss,
            "grad": _worst(got["grad_norms"], g_ref, lambda n: True),
            "change": _worst(got["change_norms"], ref["change_norms"],
                             lambda n: g_ref[n] >= 1e-3 * med)}


def verdict(nums: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    return all(limits.get(k) is None or (math.isfinite(v) and v <= limits[k])
               for k, v in nums.items())


def lines(nums: Dict[str, float], limits: Dict[str, Optional[float]]) -> List[str]:
    return [f"{k} {nums[k]!r} limit {limits.get(k)!r}" for k in NUMBERS if k in nums]
