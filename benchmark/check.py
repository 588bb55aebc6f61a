"""The comparison that decides ``correct``.

The numbers compared, each against its limit from the cell's limits file:

- ``loss``, ``repro``: over the first steps, the largest relative gap
  between the program's loss (our_repro) and the reference's;
- ``grad_norm``: the relative gap of the first step's global gradient
  norm (later steps' norms carry the round-off of the updates before them,
  which Adam's normalization magnifies at DPESFM's rate);
- ``grad_median``: the first gradient as the optimizer got it, by the
  median parameter;
- ``grad_leaf``: the same, by the worst parameter, leaving out the
  parameters that act on the edge stream while it is 2 wide (the
  configuration's ``two_wide_stream_leaves``: the embedding and the first
  LayerNorms), whose gradient any float32 implementation misses by up to a
  few percent on some seeds, as edges whose two features nearly agree
  divide by sqrt(var + eps) (``PERF.md``);
- ``update_leaf``: each parameter's change over the first steps, by the
  worst parameter.

A parameter's gap is the gap between the program's norm and the
reference's, over the reference's norm of that parameter or of the median
parameter, whichever is larger. Parameters whose reference gradient is
under a thousandth of the median parameter's (moved by round-off alone
under Adam) are left out; the reference's float64 arithmetic
(``benchmark.reference.train``) keeps that rule free of float32 round-off.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

NUMBERS = ("loss", "repro", "grad_norm", "grad_median", "grad_leaf", "update_leaf")
QUIET = 1e-3  # a parameter under this share of the median gradient is left out


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: List[str],
                among: Optional[List[str]] = None) -> float:
    """The worst gap over ``among`` (default ``keep``), each over the larger
    of its reference norm and the median of ``keep``'s."""
    if not keep:
        return math.inf
    median = statistics.median(ref[k] for k in keep)
    worst = 0.0
    for k in keep if among is None else among:
        p = prog.get(k, math.nan)
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref[k]) / max(ref[k], median, 1e-30))
    return worst


def _median_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> float:
    if not keep:
        return math.inf
    median = statistics.median(ref[k] for k in keep)
    gaps = [abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], median, 1e-30) for k in keep]
    return math.inf if not all(map(math.isfinite, gaps)) else statistics.median(gaps)


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= QUIET * median]


def gaps(prog: dict, ref: dict, skip: Sequence[str] = ()) -> Dict[str, float]:
    """The numbers compared; ``prog`` and ``ref`` as
    :func:`benchmark.reference.train.train_steps` returns them, ``skip``
    the name prefixes that ``grad_leaf`` leaves out."""
    out = {}
    for key in ("loss", "repro"):
        if len(prog[key]) != len(ref[key]):
            out[key] = math.inf
        else:
            out[key] = max(_rel(a, b) for a, b in zip(prog[key], ref[key]))
    out["grad_norm"] = _rel(prog["grad_norm"][0], ref["grad_norm"][0])
    keep = kept_leaves(ref["grad_leaf"])
    out["grad_leaf"] = _worst_leaf(prog["grad_leaf"], ref["grad_leaf"], keep,
                                   [k for k in keep if not k.startswith(tuple(skip))])
    out["grad_median"] = _median_leaf(prog["grad_leaf"], ref["grad_leaf"], keep)
    out["update_leaf"] = _worst_leaf(prog["change_leaf"], ref["change_leaf"], keep)
    return out


def worst_leaves(prog: dict, ref: dict, key: str, count: int = 5,
                 skip: Sequence[str] = ()) -> list:
    """The ``count`` parameters with the largest gaps of ``key``
    ("grad_leaf" or "change_leaf") but those that ``skip`` names:
    [name, program, reference, gap]."""
    keep = [k for k in kept_leaves(ref["grad_leaf"]) if not k.startswith(tuple(skip))]
    median = statistics.median(ref[key][k] for k in kept_leaves(ref["grad_leaf"]))
    rows = [[k, prog[key][k], ref[key][k],
             abs(prog[key][k] - ref[key][k]) / max(ref[key][k], median, 1e-30)] for k in keep]
    return sorted(rows, key=lambda r: -r[3])[:count]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number that the cell's limits name is within its
    limit (a cell leaves out a number with no reading above its sound
    runs' to set a limit from)."""
    return all(numbers[k] <= limits[k] for k in limits)


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
