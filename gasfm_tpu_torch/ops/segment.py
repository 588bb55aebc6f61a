"""Plain PyTorch segment reductions over the port's edge arrays.

Counterpart of the JAX package's ops/segment.py, with its contract: an empty
segment sums to 0, takes the caller's ``neutral`` under ``segment_max``, and
gets softmax weight 0. The port's graph holds valid edges only, so there are
no masked or padding edges to route away.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, seg_ids.long(), data)


def segment_max(
    data: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    neutral: float = float("-inf"),
) -> torch.Tensor:
    """Max per segment; empty segments yield ``neutral``."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), neutral)
    idx = seg_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce="amax", include_self=False)


def gather_segments(table: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    """Broadcast per-segment rows back to edges."""
    return table[seg_ids.long()]


def segment_softmax(logits: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Numerically stable softmax over each segment of per-edge logits
    ((E,) or (E, H)); edges of empty segments cannot exist, every weight of
    a non-empty segment is finite."""
    m = segment_max(logits, seg_ids, num_segments)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - gather_segments(m, seg_ids))
    den = segment_sum(p, seg_ids, num_segments)
    den_e = gather_segments(den, seg_ids)
    return torch.where(den_e > 0, p / den_e.clamp_min(1e-38), torch.zeros_like(p))
