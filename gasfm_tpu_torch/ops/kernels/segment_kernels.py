"""CSR segment sum, segment max and row gather: CUDA kernels for Hopper
(``csrc/segment.cu``), their plain PyTorch versions, and their launch
counters.

Replaces the TPU kernels of ``gasfm_tpu/ops/pallas/segment_kernels.py``:
``segment_sum`` the dense one-hot sum (``segment_sum_kernel`` /
``_segment_sum_raw``, the camera side) and the windowed point sum
(``windowed_segment_sum`` / ``_wseg_sum_raw``); ``segment_max`` the dense
and windowed maxes (``segment_max_kernel`` / ``_segment_max_raw``,
``windowed_segment_max`` / ``_wseg_max_raw``); ``gather_rows`` the dense
and windowed gathers (``gather_rows_kernel`` / ``_gather_rows_raw``,
``windowed_gather`` / ``_wgather_raw``). On the port's CSR graph a
"side" names the segments: ``"point"`` walks the contiguous point runs
(``pt_ptr``), ``"camera"`` walks ``cam_perm[cam_ptr[c]:cam_ptr[c+1]]``; the
gather reads ``pt_idx`` or ``cam_idx``. Each is the other's backward, as in
the JAX package (``_ss_bwd``, ``_gr_bwd``, ``_wss_bwd``, ``_wg_bwd``): under
autograd the sum's backward launches the gather kernel and the gather's
backward the sum kernel, each counted by its own counter. The max has no
backward: its callers take the max of detached logits (the softmax shift).

What bounds them on the H100 is bytes over its 3.35 TB/s (see the source).
The sum walks both CSRs split by length (``ViewGraph.pt_chunks`` /
``cam_chunks``, built once per graph on the host): short segments (at most
``SUM_ROWS`` rows) several to a warp (at D > 64 several warps to one),
longer ones a block each (cut into parts of ``SUM_PART_ROWS`` rows, merged
by a second launch, where a hub has more). The max is the same walk on the
same split with the reduction swapped (fmaxf from -inf).
Rows are float32, 1 to 256 wide (1 to 8 for the max); sums are taken in a
fixed order without atomics, so results are bitwise reproducible on a given
card, and a max is exact, so it is bitwise the plain version's.

A CPU tensor runs the plain version (``index_add_`` / indexing, the
functions of ``ops/segment.py``); a CUDA tensor launches the kernel or
raises. ``launches`` counts the calls that launched.

Under an edge mesh (``ops/segment.py`` ``edge_partitioned``) the kernels run
on the rank's edge shard, and ``segment_sum`` finishes with the interior
``all_sum`` over the edge group, ``segment_max`` with ``all_max`` (the
plain versions through ``ops/segment.py``'s, which do the same). The gather
needs none: its table gradient is the rank's partial, which the interior
sum's backward upstream or the final sum of the gradients completes.
"""

from __future__ import annotations

import functools

import torch

from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.segment import all_sum, edge_group, gather_segments, max_over_edges
from gasfm_tpu_torch.ops.segment import segment_max as index_segment_max
from gasfm_tpu_torch.ops.segment import segment_sum as index_segment_sum

MAX_WIDTH = 256  # kSegMaxD of csrc/segment.cuh
SUM_ROWS = 64  # kSumRows of csrc/segment.cuh: the longest segment a lane group sums alone
SUM_PART_ROWS = 2048  # kSumPartRows: the rows of a long segment one block sums
MAX_MAX_WIDTH = 8  # kSegMaxCols of csrc/segment.cuh: the widest row the max takes
SIDES = ("point", "camera")


@functools.lru_cache(maxsize=None)
def _entry(symbol):
    args = {"gasfm_segment_sum": (kb.P, kb.I, kb.I, kb.P, kb.P, kb.P, kb.I, kb.I, kb.I, kb.P,
                                  kb.P, kb.P),
            "gasfm_segment_max": (kb.P, kb.I, kb.I, kb.P, kb.P, kb.P, kb.I, kb.I, kb.I, kb.F,
                                  kb.P, kb.P, kb.P),
            "gasfm_gather_rows": (kb.P, kb.I, kb.P, kb.I, kb.P, kb.P)}[symbol]
    return kb.bind(kb.load("segment"), symbol, args)


def side_ids(graph, side):
    """(edge ids, number of segments) of ``side``."""
    if side == "point":
        return graph.pt_idx, graph.num_pts
    if side == "camera":
        return graph.cam_idx, graph.num_cams
    raise ValueError(f"side must be one of {SIDES}, got {side!r}")


def side_csr(graph, side):
    """(CSR offsets, permutation or None) of ``side``, as int32 CUDA
    tensors: the point runs ``pt_ptr``, or the camera lists ``cam_perm``
    with offsets ``cam_ptr``."""
    if side == "point":
        return kb.cuda_i32("pt_ptr", graph.pt_ptr), None
    side_ids(graph, side)  # raises for an unknown side
    return kb.cuda_i32("cam_ptr", graph.cam_ptr), kb.cuda_i32("cam_perm", graph.cam_perm)


def sum_split(graph, side, D, device, long_above=SUM_ROWS):
    """The split of ``side`` that the segment sum and max walk, as the C
    entries take it: its segments of more than ``long_above`` rows, cut
    into parts of SUM_PART_ROWS (built once per graph: ``pt_chunks`` /
    ``cam_chunks``); (table, n_long, n_chunks, partial-row scratch
    (n_chunks, D), None unless a segment has several parts)."""
    side_ids(graph, side)  # raises for an unknown side
    chunks = graph.pt_chunks if side == "point" else graph.cam_chunks
    sp = chunks(SUM_PART_ROWS, long_above)
    part = kb.f32_empty((sp.n_chunks, D), device) if sp.n_chunks > sp.n_long else None
    return kb.cuda_i32(f"{side}_chunks", sp.table), sp.n_long, sp.n_chunks, part


def segment_sum_plain(data, graph, side):
    """(S, D) sums of the (E, D) rows per segment of ``side``; empty
    segments sum to 0."""
    ids, S = side_ids(graph, side)
    return index_segment_sum(data, ids, S)


def gather_rows_plain(table, graph, side):
    """(E, D) = table[ids] with the edge ids of ``side``."""
    return gather_segments(table, side_ids(graph, side)[0])


def _check_width(name, t, rows):
    if t.dim() != 2 or not 1 <= t.shape[1] <= MAX_WIDTH or t.shape[0] != rows:
        raise ValueError(f"{name}: expected ({rows}, D) with 1 <= D <= {MAX_WIDTH}, "
                         f"got {tuple(t.shape)}")


def segment_sum_forward(data, graph, side):
    """Launch the segment-sum kernel (CUDA tensors)."""
    _, S = side_ids(graph, side)
    _check_width("data", data, graph.num_edges)
    data = kb.aligned(kb.cuda_f32("data", data))
    D = data.shape[1]
    ptr, perm = side_csr(graph, side)
    split, n_long, n_chunks, part = sum_split(graph, side, D, data.device)
    out = kb.f32_empty((S, D), data.device)
    p = kb.ptr
    code = _entry("gasfm_segment_sum")(p(data), D, graph.num_edges, p(ptr), p(perm), p(split),
                                       n_long, n_chunks, S, p(out), p(part),
                                       kb.stream(data.device))
    kb.check(code, "segment_sum")
    segment_sum.launches += 1
    return out


def gather_rows_forward(table, graph, side):
    """Launch the row-gather kernel (CUDA tensors). The kernel indexes in
    32 bits: E x D and S x D must stay below 2^31."""
    ids, S = side_ids(graph, side)
    _check_width("table", table, S)
    table = kb.aligned(kb.cuda_f32("table", table))
    ids = kb.cuda_i32("ids", ids)
    E, D = ids.shape[0], table.shape[1]
    if max(E, S) * D >= 2**31:
        raise ValueError(f"gather_rows: {max(E, S)} x {D} rows exceed 32-bit indexing")
    out = table.new_empty((E, D))  # float32 on the table's card, fewer arguments to parse
    code = _entry("gasfm_gather_rows")(table.data_ptr(), D, ids.data_ptr(), E, out.data_ptr(),
                                       kb.stream(table.device))
    kb.check(code, "gather_rows")
    gather_rows.launches += 1
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, graph, side):
        ctx.graph, ctx.side = graph, side
        return segment_sum_forward(data, graph, side)

    @staticmethod
    def backward(ctx, g):
        return gather_rows_forward(g, ctx.graph, ctx.side), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, graph, side):
        ctx.graph, ctx.side = graph, side
        return gather_rows_forward(table, graph, side)

    @staticmethod
    def backward(ctx, g):
        return segment_sum_forward(g, ctx.graph, ctx.side), None, None


def segment_sum(data, graph, side):
    """(S, D) sums of the (E, D) rows of ``data`` per segment of ``side``
    ("point" or "camera"); empty segments sum to 0. Under an edge mesh the
    sums of the scene's edges (the interior ``all_sum`` of the shards')."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, graph, side)
    if kb.needs_grad(data):
        return all_sum(_SegmentSum.apply(data, graph, side))
    return all_sum(segment_sum_forward(data, graph, side))


segment_sum.launches = 0


def gather_rows(table, graph, side):
    """(E, D) rows ``table[ids]`` of the (S, D) table, with the edges' ids
    of ``side`` ("point": ``pt_idx``, "camera": ``cam_idx``)."""
    if table.is_cpu:
        return gather_rows_plain(table, graph, side)
    if kb.needs_grad(table):
        return _GatherRows.apply(table, graph, side)
    return gather_rows_forward(table, graph, side)


gather_rows.launches = 0


def segment_max_plain(data, graph, side, neutral=float("-inf")):
    """(S, D) maxima of the (E, D) rows per segment of ``side``; empty
    segments give ``neutral``."""
    ids, S = side_ids(graph, side)
    return index_segment_max(data, ids, S, neutral)


def segment_max(data, graph, side, neutral=float("-inf")):
    """(S, D) maxima of the (E, D) rows of ``data`` (1 <= D <= 8) per
    segment of ``side`` ("point" or "camera"); empty segments give
    ``neutral``. No gradient: pass detached data. The kernel walks the
    segment sum's split (:func:`sum_split`): one launch, two where a
    segment has more than SUM_PART_ROWS rows. Under an edge mesh the maxima
    over the scene's edges (``all_max`` of the shards', taken with -inf for
    a segment empty on a shard)."""
    if data.device.type == "cpu":
        return segment_max_plain(data, graph, side, neutral)
    if kb.needs_grad(data):
        raise ValueError("segment_max has no backward: pass detached data")
    _, S = side_ids(graph, side)
    E = graph.num_edges
    if data.dim() != 2 or not 1 <= data.shape[1] <= MAX_MAX_WIDTH or data.shape[0] != E:
        raise ValueError(f"data: expected ({E}, D) with 1 <= D <= {MAX_MAX_WIDTH}, "
                         f"got {tuple(data.shape)}")
    data = kb.aligned(kb.cuda_f32("data", data))
    D = data.shape[1]
    ptr, perm = side_csr(graph, side)
    split, n_long, n_chunks, part = sum_split(graph, side, D, data.device)
    out = kb.f32_empty((S, D), data.device)
    p = kb.ptr
    local = neutral if edge_group() is None else float("-inf")
    code = _entry("gasfm_segment_max")(p(data), D, E, p(ptr), p(perm), p(split), n_long,
                                       n_chunks, S, float(local), p(out), p(part),
                                       kb.stream(data.device))
    kb.check(code, "segment_max")
    segment_max.launches += 1
    return max_over_edges(out, neutral)


segment_max.launches = 0
