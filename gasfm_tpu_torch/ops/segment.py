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

Under an edge mesh (:func:`edge_partitioned`, the JAX package's
``edge_partitioned`` context, ``gasfm_tpu/ops/segment.py:119-290``) each rank
holds a contiguous shard of the scene's edges and every table whole, and
each reduction over edges finishes with a collective over the edge group:
a sum with :func:`all_sum` (interior: its backward sums the incoming
cotangent over the group too) or :func:`all_sum_final` (the loss's and the
metrics' sums: the cotangent passes through unchanged), a max with
:func:`all_max` (no gradient). Then every parameter gradient leaves a
rank's backward as that rank's partial, and one sum over all ranks makes
it exact. Outside the context the three are the identity.

Table sharding (:func:`table_sharded` and :func:`table_shard`, the JAX
package's ``table_sharded`` / ``table_shard_owned`` / ``is_table_sharded``,
``gasfm_tpu/ops/segment.py:150-179``) narrows that inside an edge-partitioned
scope: it carries the rank's
:class:`~gasfm_tpu_torch.graph.view_graph.TableShard` (its boundary points
and owned points), and the point-side attentions then finish over the edge
group by exchanging their boundary rows with the neighbour shards
(``ops/attn_combine.py``) instead of reducing the whole point table, and
the point->global pool reduces the rank's owned rows. A point table is then
exact on the rows the rank's edges touch; every other reduction is as
above.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Sequence

import torch

# The edge group of the reductions traced in the current scope (a
# torch.distributed process group), or None: no collective.
_EDGE_GROUP: contextvars.ContextVar = contextvars.ContextVar("gasfm_torch_edge_group",
                                                             default=None)


@contextlib.contextmanager
def edge_partitioned(group):
    """Finish every reduction over edges in this scope with a collective
    over ``group`` (the ranks that hold the shards of one scene's edges);
    ``group`` None turns them off."""
    token = _EDGE_GROUP.set(group)
    try:
        yield
    finally:
        _EDGE_GROUP.reset(token)


def edge_group():
    """The process group of the current edge-partitioned scope, or None."""
    return _EDGE_GROUP.get()


# The TableShard of the current table-sharded scope, or None: replicated tables.
_TABLE_SHARD: contextvars.ContextVar = contextvars.ContextVar("gasfm_torch_table_shard",
                                                              default=None)


@contextlib.contextmanager
def table_sharded(shard):
    """Shard the point table over the edge group in this scope: ``shard``,
    this rank's :class:`~gasfm_tpu_torch.graph.view_graph.TableShard` (None
    turns it off). Takes effect inside :func:`edge_partitioned`."""
    token = _TABLE_SHARD.set(shard)
    try:
        yield
    finally:
        _TABLE_SHARD.reset(token)


def table_shard():
    """The current scope's TableShard when the point table is sharded over
    an edge group, else None."""
    return _TABLE_SHARD.get() if _EDGE_GROUP.get() is not None else None


def flat_collective(tensors: Sequence[torch.Tensor], group, op=None,
                    src: Optional[int] = None) -> List[torch.Tensor]:
    """``tensors`` through one collective over ``group`` (None: every rank)
    on one flat buffer, a copy: an all-reduce (SUM unless ``op``), or with
    ``src`` rank ``src``'s values broadcast. Returns new tensors of the
    inputs' shapes (views of that buffer; the inputs are untouched)."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    if src is None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM if op is None else op, group=group)
    else:
        dist.broadcast(flat, src=src, group=group)
    return [part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                  tensors)]


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    return flat_collective([x], group, op)[0]


class _AllSumInterior(torch.autograd.Function):
    """Sum over the edge group whose backward sums the cotangent over the
    group (``_psum_interior``): the cotangent of a table that every rank's
    edges read comes in as each rank's partial, and the summand on each rank
    gets the whole of it."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        return _all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        return _all_reduce(g, ctx.group, dist.ReduceOp.SUM), None


class _AllSumFinal(torch.autograd.Function):
    """Sum over the edge group whose backward passes the cotangent through
    (``_psum_replicated``): the loss's seed is the same on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        return _all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """Interior sum over the edge group (identity outside a mesh): for
    reductions whose result feeds back into per-edge work."""
    group = _EDGE_GROUP.get()
    return x if group is None else _AllSumInterior.apply(x, group)


def all_sum_final(x: torch.Tensor) -> torch.Tensor:
    """Final sum over the edge group (identity outside a mesh): for the
    loss's and the metrics' scalars, whose cotangent is the seed."""
    group = _EDGE_GROUP.get()
    return x if group is None else _AllSumFinal.apply(x, group)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """Max over the edge group (identity outside a mesh), of values that
    carry no gradient (the softmax's shift)."""
    group = _EDGE_GROUP.get()
    if group is None:
        return x
    import torch.distributed as dist

    return _all_reduce(x, group, dist.ReduceOp.MAX)


def replicated_final(x: torch.Tensor) -> torch.Tensor:
    """A loss term computed from tables alone, the same on every rank of the
    edge group: its value as it is, its gradient counted once (on the
    group's first rank), so that the sum of the ranks' gradients is exact."""
    group = _EDGE_GROUP.get()
    if group is None:
        return x
    import torch.distributed as dist

    own = x if dist.get_rank(group) == 0 else x * 0.0
    return _AllSumFinal.apply(own, group)


def edge_mean(x: torch.Tensor, graph) -> torch.Tensor:
    """(1, D) mean of the (E, D) rows over the scene's edges (an interior
    sum under a mesh, over ``graph.scene_edges``)."""
    if _EDGE_GROUP.get() is None:
        return x.mean(0, keepdim=True)
    return all_sum(x.sum(0, keepdim=True)) / max(graph.scene_edges, 1)


def max_over_edges(out: torch.Tensor, neutral: float) -> torch.Tensor:
    """A per-segment max taken over this rank's edges with -inf for an empty
    segment: over the edge group, and ``neutral`` where no rank has an edge
    of the segment (as is outside a mesh)."""
    if _EDGE_GROUP.get() is None:
        return out
    out = all_max(out)
    if neutral != float("-inf"):
        out = torch.where(out == float("-inf"), torch.full_like(out, neutral), out)
    return out


def segment_sum(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return all_sum(out.index_add_(0, seg_ids.long(), data))


def segment_max(
    data: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    neutral: float = float("-inf"),
) -> torch.Tensor:
    """Max per segment; empty segments yield ``neutral``."""
    local = neutral if _EDGE_GROUP.get() is None else float("-inf")
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), local)
    idx = seg_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = out.scatter_reduce_(0, idx, data, reduce="amax", include_self=False)
    return max_over_edges(out, neutral)


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
