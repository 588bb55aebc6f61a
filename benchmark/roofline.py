"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time an operation can
take on it.

The configurations run in float32 with TF32 off, so a step's peak rate is
the float32 rate outside the tensor cores.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def bound_of_calls(calls: Iterable[Tuple[str, float, float]]) -> float:
    """The summed bounds of (name, bytes, flops) calls, in seconds."""
    return sum(bound_s(b, f) for _, b, f in calls)
