"""The standalone projection update: CUDA kernels for Hopper
(``csrc/fused_proj_update.cu``), forward and backward, their plain PyTorch
version, and their launch counters.

Replaces the TPU kernels of ``gasfm_tpu/ops/pallas/fused_proj_update.py``
(``packed_edge_update`` / ``_fwd_raw``; backward ``_bwd_raw``): a GASFM
layer's projection update, materialized,

    e = ([en | skip2] W^T + b + pg + ps[pt] + pv[cam]) / 4  (+ res)

with en (E, d_in), skip2 (E, d2) or None, res (E, De) or None, W (De, d_in +
d2) in torch's layout (columns for en, then skip2), b (De,), ps (n, De), pv
(m, De), pg (1, De); d_in, d2, De <= 32 and d_in + d2 <= 64. The model runs
it on a merged-path layer whose successor is not merged (the depth head's
layer L-2), where the update cannot defer into the next layer-step kernel.
The forward is the layer step forward's update on the edge tiles
(``csrc/edge_tile.cuh``, its phase A: persistent blocks, spans of two
32-edge tiles of [en | skip2] staged in shared memory, each thread four
features of two edges), one launch.

The backward gives d en = (g / 4) W[:, :d_in], d skip2 = (g / 4) W[:, d_in:],
d W the outer sums of g / 4 with [en | skip2], d b = d pg the column sum of
g / 4, d ps and d pv the point and camera sums of g / 4 (0 for a point or
camera without edges), and d res = g (no kernel work). It runs the layer
step backward's edge tiles (``csrc/edge_tile.cuh``, its phases 2 and 4: d en,
d skip2, and d W, d b in one partial row per block), the column sum of those
rows, and the segment sum on both sides (``csrc/segment.cuh``): four launches
inside one call, one more for each side with a hub, counted once by
``projection_update_bwd``.

What bounds both on the H100 is bytes over its 3.35 TB/s (see the source).
No float atomics; results are bitwise reproducible on a given card.

A CPU tensor runs the plain version (autograd through it is the backward's
plain version); a CUDA tensor launches the kernel or raises.

bf16 edge streams (``compile.stream_dtype``; en, skip2, res all bf16): the
forward stores e rounded to bf16 (the JAX package's ``fused_proj_update.py:295``),
the backward takes g in bf16 and gives d en and d skip2 rounded
(``:338-341``), d res = g; its tile kernel writes g upcast for the tables'
sums. The plain version upcasts and rounds at the same points.

Under an edge mesh it needs no collective (the JAX package's
``fused_proj_update.py:26``): the update is per edge over whole tables, and
its backward's table and weight gradients are the rank's partials, which
the interior sums upstream or the final sum of the gradients complete.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.kernels.segment_kernels import sum_split

TILE_ROWS = 32  # kTileRows of csrc/edge_tile.cuh: edges per tile
TILE_BLOCKS_PER_SM = 3  # kTileBlocksPerSm: the backward tile kernels' blocks per SM
UPDATE_FWD_SPAN = 2 * TILE_ROWS  # kUpdateFwdSpan: edges per forward block per step
UPDATE_FWD_BLOCKS_PER_SM = 3  # kUpdateFwdBlocksPerSm: the forward's

_ARGS = {
    # en, d_in, skip2, d2, res, w, b, pg, ps, pv, pt_idx, cam_idx, E, De, out, bf16, grid,
    # stream
    "gasfm_proj_update": (kb.P, kb.I, kb.P, kb.I) + (kb.P,) * 8
    + (kb.I, kb.I, kb.P, kb.I, kb.I, kb.P),
    # g, en, d_in, skip2, d2, w, pt_ptr, n_pts, cam_ptr, cam_perm, n_cams, both sides'
    # splits and their scratch, E, De, den, dskip2, dps, dpv, partials, sums, g32, bf16,
    # grid, stream
    "gasfm_proj_update_bwd": (kb.P, kb.P, kb.I, kb.P, kb.I, kb.P, kb.P, kb.I, kb.P, kb.P, kb.I)
    + (kb.P, kb.I, kb.I) * 2 + (kb.P, kb.P, kb.I, kb.I) + (kb.P,) * 7 + (kb.I, kb.I, kb.P),
}


@functools.lru_cache(maxsize=None)
def _entry(symbol):
    return kb.bind(kb.load("fused_proj_update"), symbol, _ARGS[symbol])


def update_f32(en, skip2, res, w, b, ps, pv, pg, graph):
    """e of the projection update in plain PyTorch, computed in float32 from
    bf16 streams upcast (``kb.upcast``) and not rounded."""
    up = kb.upcast
    x = up(en) if skip2 is None else torch.cat([up(en), up(skip2)], dim=1)
    gathered = ps[graph.pt_idx.long()] + pv[graph.cam_idx.long()]
    e = (F.linear(x, w) + (b + pg.reshape(-1)) + gathered) * 0.25
    return e if res is None else e + up(res)


def projection_update_plain(en, skip2, res, w, b, ps, pv, pg, graph):
    """e of the projection update, in plain PyTorch: in the streams' dtype,
    rounded to bf16 where they are bf16 (the JAX package's store)."""
    e = update_f32(en, skip2, res, w, b, ps, pv, pg, graph)
    return e.to(torch.bfloat16) if en.dtype == torch.bfloat16 else e


def _widths(en, skip2, w):
    d_in = en.shape[1]
    d2 = 0 if skip2 is None else skip2.shape[1]
    De = w.shape[0]
    if max(d_in, d2, De) > 32 or d_in + d2 > 64:
        raise ValueError(f"projection_update: widths d_in {d_in}, d2 {d2}, De {De}; the "
                         "kernel takes d_in, d2, De <= 32 and d_in + d2 <= 64")
    return d_in, d2, De


def projection_update_forward(en, skip2, res, w, b, ps, pv, pg, graph):
    """Launch the forward kernel (CUDA tensors): e (E, De)."""
    d_in, d2, De = _widths(en, skip2, w)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    sd = kb.stream_dtype(en, skip2, res)
    al = kb.aligned
    en = al(kb.cuda_stream("en", en, sd, (E, d_in)))
    if skip2 is not None:
        skip2 = al(kb.cuda_stream("skip2", skip2, sd, (E, d2)))
    if res is not None:
        res = al(kb.cuda_stream("res", res, sd, (E, De)))
    w = kb.cuda_f32("w", w, (De, d_in + d2))
    b = kb.cuda_f32("b", b, (De,))
    pg = kb.cuda_f32("pg", pg.reshape(-1), (De,))
    ps = al(kb.cuda_f32("ps", ps, (n, De)))
    pv = al(kb.cuda_f32("pv", pv, (m, De)))
    dev = en.device
    out = torch.empty((E, De), dtype=sd, device=dev)
    p = kb.ptr
    code = _entry("gasfm_proj_update")(
        p(en), d_in, p(skip2), d2, p(res), p(w), p(b), p(pg), p(ps), p(pv),
        p(kb.cuda_i32("pt_idx", graph.pt_idx)), p(kb.cuda_i32("cam_idx", graph.cam_idx)),
        E, De, p(out), kb.is_bf16(sd),
        kb.grid_for(dev, -(-E // UPDATE_FWD_SPAN), 1, per_sm=UPDATE_FWD_BLOCKS_PER_SM),
        kb.stream(dev))
    kb.check(code, "projection_update")
    projection_update.launches += 1
    projection_update.bf16_launches += kb.is_bf16(sd)
    return out


class _ProjectionUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, en, skip2, res, w, b, ps, pv, pg, graph):
        ctx.save_for_backward(en, skip2, w)
        ctx.graph, ctx.has_res, ctx.pg_shape = graph, res is not None, pg.shape
        return projection_update_forward(en, skip2, res, w, b, ps, pv, pg, graph)

    @staticmethod
    def backward(ctx, g):
        en, skip2, w = ctx.saved_tensors
        den, dskip2, dw, db, dps, dpv = projection_update_bwd(g, en, skip2, w, ctx.graph)
        return (den, dskip2, g if ctx.has_res else None, dw, db, dps, dpv,
                db.reshape(ctx.pg_shape), None)


def projection_update(en, skip2, res, w, b, ps, pv, pg, graph):
    """The projection update e (E, De) over the graph's edges (module
    docstring)."""
    if en.device.type == "cpu":
        return projection_update_plain(en, skip2, res, w, b, ps, pv, pg, graph)
    if kb.needs_grad(en, skip2, res, w, b, ps, pv, pg):
        return _ProjectionUpdate.apply(en, skip2, res, w, b, ps, pv, pg, graph)
    return projection_update_forward(en, skip2, res, w, b, ps, pv, pg, graph)


projection_update.launches = 0
projection_update.bf16_launches = 0  # of them, launches on bf16 streams


def projection_update_bwd(g, en, skip2, w, graph):
    """The backward kernel (CUDA tensors): from the cotangent g (E, De) of e
    and the forward's en, skip2 (or None) and w, (d en, d skip2 (or None),
    d w (De, d_in + d2), d b (De,), d ps (n, De), d pv (m, De)); d pg is d b,
    and d res is g. Its plain version is autograd through
    :func:`projection_update_plain`."""
    d_in, d2, De = _widths(en, skip2, w)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    sd = kb.stream_dtype(g, en, skip2)
    g = kb.aligned(kb.cuda_stream("g", g, sd, (E, De)))
    en = kb.aligned(kb.cuda_stream("en", en, sd, (E, d_in)))
    if skip2 is not None:
        skip2 = kb.aligned(kb.cuda_stream("skip2", skip2, sd, (E, d2)))
    w = kb.cuda_f32("w", w, (De, d_in + d2))
    dev = g.device
    K = d_in + d2
    grid = kb.grid_for(dev, -(-E // TILE_ROWS), 1, per_sm=TILE_BLOCKS_PER_SM)
    den = torch.empty((E, d_in), dtype=sd, device=dev)
    dskip2 = None if skip2 is None else torch.empty((E, d2), dtype=sd, device=dev)
    # bf16: the tile kernel writes g as float32 for the table sums
    g32 = kb.f32_empty((E, De), dev) if kb.is_bf16(sd) else None
    dps, dpv = kb.f32_empty((n, De), dev), kb.f32_empty((m, De), dev)
    partials, sums = kb.f32_empty((grid, De * K + De), dev), kb.f32_empty((De * K + De,), dev)
    split_p, n_long_p, n_chunks_p, part_p = sum_split(graph, "point", De, dev)
    split_c, n_long_c, n_chunks_c, part_c = sum_split(graph, "camera", De, dev)
    p = kb.ptr
    code = _entry("gasfm_proj_update_bwd")(
        p(g), p(en), d_in, p(skip2), d2, p(w), p(kb.cuda_i32("pt_ptr", graph.pt_ptr)), n,
        p(kb.cuda_i32("cam_ptr", graph.cam_ptr)), p(kb.cuda_i32("cam_perm", graph.cam_perm)), m,
        p(split_p), n_long_p, n_chunks_p, p(split_c), n_long_c, n_chunks_c, p(part_p),
        p(part_c), E, De, p(den), p(dskip2), p(dps), p(dpv), p(partials), p(sums), p(g32),
        kb.is_bf16(sd), grid, kb.stream(dev))
    kb.check(code, "projection_update_bwd")
    projection_update_bwd.launches += 1
    projection_update_bwd.bf16_launches += kb.is_bf16(sd)
    return den, dskip2, sums[:De * K].view(De, K), sums[De * K:], dps, dpv


projection_update_bwd.launches = 0
projection_update_bwd.bf16_launches = 0
