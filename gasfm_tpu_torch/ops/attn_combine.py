"""The segment softmax's combine over the shards of an edge mesh.

Counterpart of the JAX package's ``combine_attention_shards``
(``gasfm_tpu/ops/pallas/fused_attn.py:221``), which is plain XLA outside
Pallas; here it is plain PyTorch outside the CUDA kernels. Each rank's
attention kernel gives, over its own edges, each segment's output ``out``
(S, H*C), its per-head softmax max ``m`` and denominator ``den`` (S, H). A
segment with no edge on the rank has ``den == 0``; its max is taken as
-inf, the neutral of the max (the unvisited-window mask of
``fused_attn.py:245-250``). Then, over the edge group:

    m_g   = max(m)
    w     = den * exp(m - m_g)          (0 where den == 0)
    den_g = sum(w)
    out_g = sum(out * w) / den_g        (0 where den_g == 0)

``out * den`` recovers the unnormalized sum, so the kernels are unchanged
(no no-finalize flag). The max and the two sums of every direction given go
into one all-reduce MAX and one all-reduce SUM. The combine carries no
gradient: the kernels' backward takes the global ``(out_g, m_g, den_g)``
and the output's cotangent summed over the group (:func:`sum_cotangents`),
and gives the rank's exact share of each input's gradient.

Under table sharding (``ops/segment.py`` ``table_sharded``) the point
direction is combined by the boundary exchange instead, the counterpart of
the JAX package's ``exchange_boundary_windows`` / ``exchange_boundary_add``
and ``_merge_softmax_rows`` (``gasfm_tpu/ops/pallas/fused_attn.py:75-218``).
A rank's point-major edges touch a contiguous run of points, and only its
first and its last point can have edges on a neighbour shard
(:class:`~gasfm_tpu_torch.graph.view_graph.TableShard`). So only those two
rows cross the edge group: each rank writes its first and last point's
(num, m, den) into its own slot of a zero-filled (n_edge, 2, D + 2H) slab, one SUM all-reduce puts every slot on every rank (gloo runs no send or
recv on CUDA tensors; the JAX package's ``ppermute`` pair), and each rank
merges its left neighbour's last row into its first point and its right
neighbour's first row into its last point, where the neighbour shares the
point (``shared_left`` / ``shared_right``: the neighbour's end row is then
that point's; :func:`merge_softmax_rows`; a shard whose first
point is its last takes both merges in turn). A row the rank does not touch
keeps the neutral triple (out 0, den 0): the rank's edges never read it. The
backward adds the neighbours' cotangent rows of the two shared points through
the same slab (:func:`exchange_cotangents`). Where a call also combines the
camera side, the slab rides in the camera side's SUM, so a call still makes
one MAX and one SUM. The exchange moves O(n_edge (D + 2H)) floats per call,
whatever the number of points.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from gasfm_tpu_torch.ops.segment import flat_collective


def combine_attention_shards(parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                             group, extra: Sequence[torch.Tensor] = ()):
    """``parts``: per direction this rank's (out (S, D), m (S, H), den (S,
    H)). Returns per direction the scene's (out_g, m_g, den_g): m_g 0 where
    no rank has an edge of the segment. With ``extra`` (tensors to sum over
    the group in the same SUM: a boundary slab), returns (combined, their
    sums)."""
    import torch.distributed as dist

    ms = [torch.where(den > 0, m, torch.full_like(m, float("-inf"))) for _, m, den in parts]
    m_gs = [torch.where(torch.isfinite(m_g), m_g, torch.zeros_like(m_g))
            for m_g in flat_collective(ms, group, dist.ReduceOp.MAX)]
    payload = []
    for (out, _, den), m, m_g in zip(parts, ms, m_gs):
        S, H = den.shape
        w = torch.where(den > 0, den * torch.exp(m - m_g), torch.zeros_like(den))
        num = torch.where(w[:, :, None] > 0, out.reshape(S, H, -1) * w[:, :, None],
                          torch.zeros((), dtype=out.dtype, device=out.device))
        payload += [w, num]
    sums = flat_collective(payload + list(extra), group)
    combined = []
    n = 2 * len(parts)
    for (out, _, _), m_g, den_g, num_g in zip(parts, m_gs, sums[0:n:2], sums[1:n:2]):
        out_g = torch.where(den_g[:, :, None] > 0, num_g / den_g.clamp_min(1e-38)[:, :, None],
                            torch.zeros_like(num_g)).reshape(out.shape)
        combined.append((out_g.contiguous(), m_g.contiguous(), den_g.contiguous()))
    return (combined, sums[n:]) if extra else combined


def sum_cotangents(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The outputs' cotangents, each rank's partial, summed over the edge
    group in one all-reduce (the JAX kernels' ``psum`` of ``gp`` / ``gc`` at
    their backward's entry)."""
    return flat_collective(grads, group)


# ---------------------------------------------------------------------------
# table sharding: the point side's boundary exchange
# ---------------------------------------------------------------------------


def end_rows(t: torch.Tensor, shard) -> torch.Tensor:
    """(2, ...) rows ``first`` and ``last`` of ``t`` (no host-to-device copy)."""
    return torch.cat([t.narrow(0, shard.first, 1), t.narrow(0, shard.last, 1)])


def boundary_slab(num: torch.Tensor, m: torch.Tensor, den: torch.Tensor, shard) -> torch.Tensor:
    """The (n_edge, 2, D + 2H) slab, zero but for this rank's slot: its
    first and last point's rows (num (2, D), m (2, H), den (2, H)). ``m``
    carries no gradient; ``num`` and ``den`` do."""
    return _slab(torch.cat([num, m.detach(), den], dim=1), shard)


def _slab(rows: torch.Tensor, shard) -> torch.Tensor:
    """(n_edge, 2, W): zero but for this rank's slot, ``rows`` (2, W)."""
    zeros, W = rows.new_zeros, rows.shape[1]
    return torch.cat([zeros((shard.shard, 2, W)), rows[None],
                      zeros((shard.n_shards - shard.shard - 1, 2, W))])


def merge_softmax_rows(num_a, m_a, den_a, num_b, m_b, den_b, heads: int):
    """The exact merge of two partial softmax triples of the same rows:
    ``num`` (R, H*C) the sums of p x xl with p taken against the max ``m``
    (R, H), ``den`` (R, H) the sums of p. A side whose ``den`` is 0 is
    neutral (its max counts as -inf), so a merge with it changes nothing.
    The maxima carry no gradient; ``num`` and ``den`` do."""
    ninf = torch.full_like(m_a, float("-inf"))
    ma = torch.where(den_a > 0, m_a.detach(), ninf)
    mb = torch.where(den_b > 0, m_b.detach(), ninf)
    m = torch.maximum(ma, mb)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ca, cb = torch.exp(ma - m), torch.exp(mb - m)
    R, D = num_a.shape
    num = (num_a.reshape(R, heads, -1) * ca[:, :, None]
           + num_b.reshape(R, heads, -1) * cb[:, :, None]).reshape(R, D)
    return num, m, den_a * ca + den_b * cb


def _neighbour_row(slab: torch.Tensor, shard, left: bool):
    """The left neighbour's last row or the right neighbour's first row of
    the summed ``slab`` (1, W), zero unless the neighbour shares this rank's
    first or last point. The ring wraps at the ends, where nothing is
    shared: every rank reads both rows, so that every rank's backward
    reaches the slab's sum as often as the others'."""
    k, end, shared = ((shard.shard - 1, 1, shard.shared_left) if left else
                      (shard.shard + 1, 0, shard.shared_right))
    row = slab[k % shard.n_shards, end:end + 1]
    return torch.where(row.new_full((1, 1), shared, dtype=torch.bool), row,
                       torch.zeros_like(row))


def merge_ends(num, m, den, slab, shard, heads: int):
    """This rank's first and last point's triples (num (2, D), m, den (2, H))
    merged with the neighbours' rows of the summed ``slab``: the left
    neighbour's last row into the first point, the right neighbour's first
    row into the last point, each neutral (den 0) unless the neighbour
    shares the point."""
    D = num.shape[1]

    def neighbour(left: bool):
        row = _neighbour_row(slab, shard, left)
        return row[:, :D], row[:, D:D + heads], row[:, D + heads:]

    first = merge_softmax_rows(num[0:1], m[0:1], den[0:1], *neighbour(True), heads)
    base = first if shard.first == shard.last else (num[1:2], m[1:2], den[1:2])
    last = merge_softmax_rows(*base, *neighbour(False), heads)
    if shard.first == shard.last:
        first = last
    return tuple(torch.cat([a, b]) for a, b in zip(first, last))


def put_ends(t: torch.Tensor, rows: torch.Tensor, shard) -> torch.Tensor:
    """``t`` with its rows ``first`` and ``last`` replaced by ``rows`` (2,
    ...): a copy under autograd, else in place."""
    if t.requires_grad or rows.requires_grad:
        t = t.clone()
    t[shard.first:shard.first + 1] = rows[0:1]
    t[shard.last:shard.last + 1] = rows[1:2]
    return t


def exchange_points(point: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], shard, group,
                    heads: int, cameras: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                                        torch.Tensor]] = ()):
    """The kernels' side of the exchange: ``point`` this rank's (out (n, D),
    m, den (n, H)) of the point direction, its output normalized; the
    camera directions ``cameras``, if any, combined as
    :func:`combine_attention_shards` does, the slab packed into their SUM.
    Returns ((out, m, den) of the points, exact on every point the rank's
    edges touch; the cameras' combined triples)."""
    out, m, den = point
    n, D = out.shape
    den_e, m_e = end_rows(den, shard), end_rows(m, shard)
    num_e = (end_rows(out, shard).reshape(2, heads, -1) * den_e[:, :, None]).reshape(2, D)
    slab = boundary_slab(num_e, m_e, den_e, shard)
    if cameras:
        combined, (slab,) = combine_attention_shards(cameras, group, extra=[slab])
    else:
        combined, (slab,) = [], flat_collective([slab], group)
    num_e, m_e, den_e = merge_ends(num_e, m_e, den_e, slab, shard, heads)
    inv = torch.where(den_e > 0, 1.0 / den_e.clamp_min(1e-38), torch.zeros_like(den_e))
    out_e = (num_e.reshape(2, heads, -1) * inv[:, :, None]).reshape(2, D)
    return (put_ends(out, out_e, shard), put_ends(m, m_e, shard),
            put_ends(den, den_e, shard)), combined


def exchange_cotangents(g: torch.Tensor, shard, group, others: Sequence[torch.Tensor] = ()):
    """The backward's side: the point output's cotangent ``g`` (n, D), this
    rank's partial, with the neighbours' partials of the two shared points
    added (the rows its edges touch are then whole); ``others`` (the camera
    directions' cotangents) summed over the group in the same all-reduce.
    Returns (g, the sums of ``others``)."""
    D = g.shape[1]
    g_e = end_rows(g, shard)
    slab, *sums = flat_collective([_slab(g_e, shard)] + list(others), group)
    add_f, add_l = _neighbour_row(slab, shard, True), _neighbour_row(slab, shard, False)
    if shard.first == shard.last:
        g_e = (g_e[0:1] + add_f + add_l).expand(2, D)
    else:
        g_e = g_e + torch.cat([add_f, add_l])
    return put_ends(g.clone(), g_e, shard), sums
