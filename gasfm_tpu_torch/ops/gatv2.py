"""GATv2-style segment attention over the port's view graph.

Counterpart of the JAX package's ops/gatv2.py. Semantics match PyG
``GATv2Conv(add_self_loops=False, share_weights=False, concat=True)`` on the
star graphs of the reference: all source edges of a segment attend into one
aggregation node. Per head,

    score_e = att_h . LeakyReLU(xl_e + xr_seg(e), 0.2)
    out_s   = sum_e softmax_seg(score)_e * xl_e        (0 for empty segments)

Features are flat and head-major: ``xl`` (E, H*C), ``xr`` (S, H*C), ``att``
(H*C,). Linear weights keep torch's (out, in) layout. The softmax's max
shift is taken from detached logits, so it has exactly zero gradient (the
JAX package's stop_gradient contract); the plain versions under autograd
are then the reference gradient of every kernel.

``gatv2_attend_pool`` and ``gatv2_attend`` are plain PyTorch (the JAX
package leaves the pools to XLA as well). ``gatv2_attend_side``,
``gatv2_attend_composite``, ``gatv2_attend_dual``, ``gatv2_layer_frontend``
and ``merged_layer_frontend`` dispatch to the kernel wrappers of
``ops/kernels``, which launch the CUDA kernels for CUDA tensors and run their
plain versions for CPU tensors; ``plain=True`` asks for the plain versions
explicitly (the on-card comparison does).

The JAX package's gate on the scene carries over: with at most
``DENSE_MAX_SEGMENTS`` (1024) cameras both aggregations of a layer run in
the dual kernel (and the frontend kernel fuses its prologue); above it the
point direction runs in the single-direction kernel and the camera
direction as the composite of gathers, a segment max and segment sums
(``gasfm_tpu/ops/gatv2.py:146-214, 249-296, 361-439``).

Under an edge mesh (``ops/segment.py`` ``edge_partitioned``; the JAX
package's ``gatv2.py:95-114, 141-180``) ``gatv2_attend`` and the composite
take the scene's max and sums through the segment max and sums, which finish
over the edge group, and the kernels combine the shards' softmax
(``ops/attn_combine.py``). ``gatv2_attend_pool`` reduces the tables, which
every rank holds whole: no collective.

Under table sharding (``ops/segment.py`` ``table_sharded``) the point side
of ``gatv2_attend`` takes its max and sums over the rank's own edges and
merges its first and last point with the neighbour shards through the
boundary slab of ``ops/attn_combine.py``, summed over the edge group by the
interior ``all_sum``, whose transpose gives the exact gradient; so the
plain versions run the exchange that the kernels' wrappers run (the
composite serves the camera side, whose table stays whole). Here the port differs from the JAX package, whose XLA path keeps the
``psum`` of the whole point table under table sharding (only its Pallas
kernels exchange). The point->global pool takes the rank's owned rows
(:func:`gatv2_attend_pool_sharded`, the JAX package's, ``gatv2.py:88-114``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from gasfm_tpu_torch.ops.attn_combine import boundary_slab, end_rows, merge_ends, put_ends
from gasfm_tpu_torch.ops.segment import (
    all_max,
    all_sum,
    csr_segment_max,
    edge_partitioned,
    gather_segments,
    segment_max,
    segment_sum,
    table_shard,
)
from gasfm_tpu_torch.utils.constants import DENSE_MAX_SEGMENTS

NEGATIVE_SLOPE = 0.2


def layer_norm_relu(e: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """flax-form LayerNorm (``var = E[x^2] - mean^2``) + ReLU over the last
    axis — the JAX package's ``_layer_norm_relu``."""
    mean = e.mean(-1, keepdim=True)
    var = (e * e).mean(-1, keepdim=True) - mean * mean
    return torch.relu((e - mean) * torch.rsqrt(var + eps) * scale + bias)


def leaky_relu(z: torch.Tensor, negative_slope: float = NEGATIVE_SLOPE) -> torch.Tensor:
    """LeakyReLU as the JAX package writes it, ``where(z >= 0, z, slope *
    z)``: its derivative at z = 0 is 1, as in the kernels, where torch's
    ``leaky_relu`` takes the slope there. Exact zeros do occur: a stateless
    layer's zero query bias over rows that the ReLU prologue zeroed."""
    return torch.where(z >= 0, z, negative_slope * z)


def softmax_shift(logits: torch.Tensor, seg_ids: Optional[torch.Tensor] = None,
                  num_segments: Optional[int] = None) -> torch.Tensor:
    """The stable softmax's shift: the max of the DETACHED logits per
    segment (per column without ``seg_ids``), 0 where a segment is empty.
    It carries no gradient, as the JAX package's stop_gradient contract has
    it; the softmax is invariant to it."""
    if seg_ids is None:
        m = logits.detach().max(0).values
    else:
        m = segment_max(logits.detach(), seg_ids, num_segments)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def gatv2_attend_pool(
    xl: torch.Tensor,  # (E, H*C) transformed source rows
    xr0: torch.Tensor,  # (1, H*C) transformed query of THE segment
    att: torch.Tensor,  # (H*C,)
    row_mask: torch.Tensor,  # (E,) valid-source mask
    heads: int,
    negative_slope: float = NEGATIVE_SLOPE,
) -> torch.Tensor:
    """Single-segment attention: every valid row attends into one node (the
    view->global and point->global pools). Returns (1, H*C)."""
    E, D = xl.shape
    C = D // heads
    g = leaky_relu(xl + xr0.reshape(1, D), negative_slope)
    logits = (g * att).reshape(E, heads, C).sum(-1)  # (E, H)
    logits = logits.masked_fill(~row_mask[:, None], float("-inf"))
    m = softmax_shift(logits)
    p = torch.exp(logits - m).masked_fill(~row_mask[:, None], 0.0)
    den = p.sum(0)  # (H,)
    num = torch.einsum("eh,ehc->hc", p, xl.reshape(E, heads, C))
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (num / den[:, None]).reshape(1, D)


def gatv2_attend_pool_sharded(
    xl: torch.Tensor,  # (E, H*C) this rank's owned rows
    xr0: torch.Tensor,  # (1, H*C)
    att: torch.Tensor,  # (H*C,)
    row_mask: torch.Tensor,  # (E,) valid-source mask of the owned rows
    heads: int,
    negative_slope: float = NEGATIVE_SLOPE,
) -> torch.Tensor:
    """:func:`gatv2_attend_pool` of a table sharded over the edge group:
    each rank pools the rows it owns, and the per-head softmax triple
    combines over the group, one MAX of the detached per-head max and one
    interior sum of the denominators and numerators. Returns (1, H*C)."""
    E, D = xl.shape
    C = D // heads
    g = leaky_relu(xl + xr0.reshape(1, D), negative_slope)
    logits = (g * att).reshape(E, heads, C).sum(-1)  # (E, H)
    logits = logits.masked_fill(~row_mask[:, None], float("-inf"))
    m = torch.cat([logits.detach(), logits.new_full((1, heads), float("-inf"))]).amax(0)
    m = all_max(m)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m).masked_fill(~row_mask[:, None], 0.0)
    sums = all_sum(torch.cat([p.sum(0), torch.einsum("eh,ehc->hc", p, xl.reshape(E, heads, C))
                              .reshape(D)]))
    den = sums[:heads]
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (sums[heads:].reshape(heads, C) / den[:, None]).reshape(1, D)


def _exchange_points(num: torch.Tensor, m: torch.Tensor, den: torch.Tensor, shard,
                     heads: int):
    """The plain versions' boundary exchange: this rank's point sums (num
    (n, H*C), den (n, H), against the max m) with the first and last point
    merged with the neighbour shards', the slab through the interior
    ``all_sum``. Returns (num, den)."""
    num_e, m_e, den_e = (end_rows(t, shard) for t in (num, m, den))
    slab = all_sum(boundary_slab(num_e, m_e, den_e, shard))
    num_e, _, den_e = merge_ends(num_e, m_e, den_e, slab, shard, heads)
    return put_ends(num, num_e, shard), put_ends(den, den_e, shard)


def gatv2_attend(
    xl: torch.Tensor,  # (E, H*C)
    xr: torch.Tensor,  # (S, H*C)
    att: torch.Tensor,  # (H*C,)
    seg_ids: torch.Tensor,  # (E,)
    num_segments: int,
    heads: int,
    negative_slope: float = NEGATIVE_SLOPE,
    side: Optional[str] = None,
    residuals: bool = False,
):
    """(S, H*C) attention-aggregated source rows per segment, as the JAX
    package's composite path computes it: shifted exponentials, one sum for
    the numerators and one for the denominators, then ``num / den``. With
    ``side`` "point" under table sharding, the sums of the rank's edges,
    exchanged at the shard's boundary (see the module docstring). With
    ``residuals``: (out, m (S, H), den (S, H)), the softmax shift (0 where a
    segment is empty) and the denominators (0 there), as the attention
    kernels write them under autograd."""
    E, D = xl.shape
    C = D // heads
    shard = table_shard() if side == "point" else None
    g = leaky_relu(xl + gather_segments(xr, seg_ids), negative_slope)
    logits = (g * att).reshape(E, heads, C).sum(-1)  # (E, H)
    # a table-sharded point side sums its own edges: no collective here
    with edge_partitioned(None) if shard is not None else contextlib.nullcontext():
        m = softmax_shift(logits, seg_ids, num_segments)
        p = torch.exp(logits - gather_segments(m, seg_ids))  # (E, H)
        num = segment_sum((p[:, :, None] * xl.reshape(E, heads, C)).reshape(E, D), seg_ids,
                          num_segments)
        den = segment_sum(p, seg_ids, num_segments)  # (S, H)
    if shard is not None:
        num, den = _exchange_points(num, m, den, shard, heads)
    safe = torch.where(den > 0, den, torch.ones_like(den))
    out = (num.reshape(num_segments, heads, C) / safe[:, :, None]).reshape(num_segments, D)
    return (out, m, den) if residuals else out


def gatv2_attend_side(xl, xr, att, graph, side, heads, plain=False):
    """(S, H*C) attention of the (E, H*C) rows ``xl`` over the segments of
    ``side`` ("point" or "camera"): the single-direction kernel
    (``ops/kernels/fused_attn.py``)."""
    from gasfm_tpu_torch.ops.kernels import fused_attn as k

    fn = k.fused_attend_plain if plain else k.fused_attend
    return fn(xl, xr, att, graph, side, heads)


def gatv2_attend_composite(xl, xr, att, graph, side, heads, plain=False,
                           negative_slope=NEGATIVE_SLOPE):
    """The same function as :func:`gatv2_attend_side` as the JAX package's
    composite computes it (``gasfm_tpu/ops/gatv2.py:186-214``): the queries
    gathered to the edges, the logits, their per-segment max (detached, the
    softmax shift), the shifted exponentials, and one segment sum of
    ``[p * xl | p]`` (E, H*C + H) for the numerators and denominators —
    through the row-gather, segment-max and segment-sum kernels. The JAX
    package's cap on the shifted logits acts on masked edges only; the
    port's graph has none."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as k

    gather = k.gather_rows_plain if plain else k.gather_rows
    seg_sum = k.segment_sum_plain if plain else k.segment_sum
    E, D = xl.shape
    C = D // heads
    g = leaky_relu(xl + gather(xr, graph, side), negative_slope)
    logits = (g * att.reshape(D)).reshape(E, heads, C).sum(-1)  # (E, H)
    m = csr_segment_max(logits.detach(), graph, side, plain=plain)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - gather(m, graph, side))  # (E, H)
    weighted = (p[:, :, None] * xl.reshape(E, heads, C)).reshape(E, D)
    sums = seg_sum(torch.cat([weighted, p], dim=1), graph, side)  # (S, D + H)
    S = sums.shape[0]
    den = sums[:, D:]
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (sums[:, :D].reshape(S, heads, C) / den[:, :, None]).reshape(S, D)


def gatv2_attend_dual(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, plain=False):
    """Both per-layer aggregations (edges -> points, edges -> cameras). With
    at most DENSE_MAX_SEGMENTS cameras: one pass, the dual-attend kernel
    (``ops/kernels/fused_dual_attn.py``). Above: the points through the
    single-direction kernel, the cameras through the composite."""
    if graph.num_cams > DENSE_MAX_SEGMENTS:
        return (gatv2_attend_side(xl_p, xr_p, att_p, graph, "point", heads, plain),
                gatv2_attend_composite(xl_c, xr_c, att_c, graph, "camera", heads, plain))
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as k

    fn = k.fused_dual_attend_plain if plain else k.fused_dual_attend
    return fn(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads)


def gatv2_layer_frontend(e, ln_scale, ln_bias, eps, wlp, blp, wlc, blc,
                         xr_p, xr_c, att_p, att_c, graph, heads,
                         raw_prologue=False, plain=False, en_dtype=None):
    """LN + ReLU (skipped under ``raw_prologue``) + both GATv2 source
    linears + both aggregations: the frontend kernel. Returns
    (e_norm, out_pt (n, Dp), out_cam (m, Dc)); under ``raw_prologue`` e_norm
    is ``e`` itself. ``en_dtype``: e_norm's stored dtype (bf16 for a merged
    layer under bf16 streams; default e's). Above DENSE_MAX_SEGMENTS
    cameras, the JAX package's composite instead: the flax-form LayerNorm +
    ReLU and the linears in PyTorch, then :func:`gatv2_attend_dual`."""
    if graph.num_cams > DENSE_MAX_SEGMENTS:
        en = e if raw_prologue else layer_norm_relu(e, ln_scale, ln_bias, eps)
        out_p, out_c = gatv2_attend_dual(F.linear(en, wlp, blp), F.linear(en, wlc, blc),
                                         xr_p, xr_c, att_p, att_c, graph, heads, plain)
        return en, out_p, out_c
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as k

    fn = k.fused_frontend_plain if plain else k.fused_frontend
    return fn(e, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c,
              graph, heads, eps=eps, raw_prologue=raw_prologue, en_dtype=en_dtype)


def merged_layer_frontend(pending, ln_scale, ln_bias, eps, wlp, blp, wlc, blc,
                          xr_p, xr_c, att_p, att_c, graph, heads,
                          raw_prologue=False, plain=False):
    """Materialize the previous layer's deferred projection update AND run
    this layer's frontend: the layer-step kernel. Returns
    (e_prev, e_norm, out_pt, out_cam)."""
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as k

    fn = k.fused_layer_step_plain if plain else k.fused_layer_step
    return fn(pending.en, pending.skip2, pending.res, pending.w, pending.b,
              pending.ps, pending.pv, pending.pg,
              ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c,
              graph, heads, eps=eps, raw_prologue=raw_prologue)
