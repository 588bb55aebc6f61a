"""Plain PyTorch segment reductions over the port's edge arrays.

Counterpart of the JAX package's ops/segment.py, with its contract: an empty
segment sums to 0, takes the caller's ``neutral`` under ``segment_max``, and
gets softmax weight 0. The port's graph holds valid edges only, so there are
no masked or padding edges to route away.

The functions that take ``seg_ids`` are plain PyTorch. Those that take
``(graph, side)`` — ``segment_mean``, ``csr_segment_max`` and
``csr_segment_softmax`` — dispatch over one side of the CSR graph ("point"
or "camera") to the kernels of ``ops/kernels/segment_kernels`` (segment sum,
segment max, row gather), which launch for CUDA tensors and run their plain
versions for CPU tensors; ``plain=True`` asks for the plain versions
whatever the device. The mean's counts are the graph's CSR run lengths, so
counting launches nothing.
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
    a non-empty segment is finite. The max shift carries no gradient."""
    m = segment_max(logits.detach(), seg_ids, num_segments)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - gather_segments(m, seg_ids))
    den = segment_sum(p, seg_ids, num_segments)
    den_e = gather_segments(den, seg_ids)
    return torch.where(den_e > 0, p / den_e.clamp_min(1e-38), torch.zeros_like(p))


def segment_mean(data: torch.Tensor, graph, side: str, plain: bool = False) -> torch.Tensor:
    """(S, D) mean of the (E, D) rows per segment of ``side`` ("point" or
    "camera"); an empty segment gives 0 (its sum is 0, its count taken as
    1), as the JAX package's ``segment_mean``. ``plain=True`` runs the sum's
    plain version whatever the device."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as k

    s = (k.segment_sum_plain if plain else k.segment_sum)(data, graph, side)
    count = graph.pt_count if side == "point" else graph.cam_count
    return s / count.to(s.dtype)[:, None]


def csr_segment_max(data: torch.Tensor, graph, side: str, neutral: float = float("-inf"),
                    plain: bool = False) -> torch.Tensor:
    """Max per segment of ``side`` of the (E,) or (E, d <= 8) rows (the
    segment-max kernel); empty segments yield ``neutral``. No gradient."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as k

    rows = data[:, None] if data.dim() == 1 else data
    out = (k.segment_max_plain if plain else k.segment_max)(rows, graph, side, neutral)
    return out[:, 0] if data.dim() == 1 else out


def csr_segment_softmax(logits: torch.Tensor, graph, side: str, plain: bool = False) -> torch.Tensor:
    """:func:`segment_softmax` over the segments of ``side``, through the
    segment-max, row-gather and segment-sum kernels."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as k

    gather = k.gather_rows_plain if plain else k.gather_rows
    seg_sum = k.segment_sum_plain if plain else k.segment_sum
    rows = logits[:, None] if logits.dim() == 1 else logits
    m = csr_segment_max(rows.detach(), graph, side, plain=plain)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(rows - gather(m, graph, side))
    den_e = gather(seg_sum(p, graph, side), graph, side)
    w = torch.where(den_e > 0, p / den_e.clamp_min(1e-38), torch.zeros_like(p))
    return w[:, 0] if logits.dim() == 1 else w
