"""Dual GATv2 segment attention and the layer frontend: CUDA kernels for
Hopper (``csrc/fused_dual_attn.cu``), forward and backward, their plain
PyTorch versions, and their launch counters.

Replaces the TPU kernels of ``gasfm_tpu/ops/pallas/fused_dual_attn.py``:

- ``fused_dual_attend``: ``fused_dual_attend`` / ``_dual_fwd_raw`` — both
  per-layer aggregations (edges -> points, edges -> cameras) in one launch;
  its backward ``fused_dual_attend_bwd``: ``_dual_bwd_raw``.
- ``fused_frontend``: ``fused_frontend`` / ``_front_fwd_raw`` — LayerNorm +
  ReLU (skipped under ``raw_prologue``) and the two GATv2 source linears per
  edge, then the dual core. Two launches: the per-edge prologue (counted
  here: the edge tiles of ``csrc/edge_tile.cuh``, or a lane per edge at the
  first layer's widths) and the dual core (counted by
  ``fused_dual_attend``). Its backward
  ``fused_frontend_bwd`` is ``_front_bwd_raw`` split the same way: the dual
  core's backward (counted by ``fused_dual_attend_bwd``), then the
  prologue's backward (counted here; two launches inside: the edge-tile
  kernel of ``csrc/edge_tile.cuh``, whose blocks keep every weight gradient
  in registers and write one partial row each, and one column sum of the
  rows).

What bounds them on the H100 is bytes over its 3.35 TB/s, not operations:
per edge and feature the work is a few flops. The kernels read each edge
row once, keep the online softmax in registers, and walk each segment's
own edge list (point CSR; camera CSR through ``cam_perm``) instead of the
TPU kernel's one-hot matmuls. The dual core's forward and backward walk
both CSRs split at ``SPLIT_ROWS`` edges (``ViewGraph.pt_chunks`` /
``cam_chunks``, built once per graph on the host), so that no warp walks
more than that many edges of one point or camera; a second launch merges
each long segment's chunks. See the CUDA source for the launch layout.

Gradients: when an input requires grad, the wrappers run through
``torch.autograd.Function``s. The dual core's forward then also writes each
segment's per-head softmax max and denominator, which its backward reads;
the frontend's backward recomputes the LayerNorm and its output from its
input. Without grad the wrappers launch the forward kernels alone and write
no residuals.
The plain version of each backward kernel is autograd through the forward's
plain version.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper's ``launches`` attribute counts its kernel launches,
and the frontend's ``bf16_launches`` those on bf16 streams.

bf16 edge streams (``compile.stream_dtype``): the frontend's prologue takes
e in float32 or bf16 and stores e_norm in bf16 where asked (``en_dtype``:
the first merged layer stores its e_norm so, as the JAX package's
first-layer deferral rounds it, ``models/layers.py:793``; a bf16 e, a
bf16 e_norm, ``fused_dual_attn.py:987-991``); the source rows stay
float32. Its backward takes e_norm's cotangent in that dtype and gives d e
in e's (``:1310-1314``).

Under an edge mesh (``ops/segment.py`` ``edge_partitioned``; the JAX
package's ``fused_dual_attn.py:598-690``) the dual core runs on the rank's
edge shard with its residuals written, and ``ops/attn_combine.py`` combines
the shards' (out, max, den) of both directions over the edge group; its
backward sums the outputs' cotangents over the group first and takes the
combined residuals, so the kernel gives the rank's exact share of every
gradient. The frontend's prologue is per edge and needs no collective: the
frontend reaches the group through the dual core only. The plain versions
reach it through the segment max and sums of ``ops/segment.py``. Under
table sharding (``ops/segment.py`` ``table_sharded``; the JAX package's
``fused_dual_attn.py:633-682``) the point direction takes the boundary
exchange of ``ops/attn_combine.py`` instead, packed into the camera
direction's SUM, and its backward the boundary add in place of the
cotangent sum. The kernels are the same.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from gasfm_tpu_torch.ops.attn_combine import (combine_attention_shards, exchange_cotangents,
                                              exchange_points, sum_cotangents)
from gasfm_tpu_torch.ops.gatv2 import NEGATIVE_SLOPE, gatv2_attend, layer_norm_relu
from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.segment import edge_group, edge_partitioned, table_shard
from gasfm_tpu_torch.ops.kernels.fused_proj_update import TILE_BLOCKS_PER_SM, TILE_ROWS

LN_EPS = 1e-5
SPLIT_ROWS = 32  # kAttendChunk of csrc/attend_split.cuh: the dual core's split length
TRIPLE = 96  # kTriple of csrc/attend_split.cuh: floats of a chunk's online triple
DUAL_BWD_WARPS = 8  # kDualBwdWarps of csrc/fused_dual_attn.cu: warps per backward block
DUAL_BWD_BLOCKS_PER_SM = 3  # kDualBwdBlocksPerSm: its resident blocks per SM
# kFrontNarrowDe / kFrontNarrowDq of csrc/edge_tile.cuh: the widths up to which
# the prologue takes its narrow form, a lane per edge (forward: blocks of
# FRONT_NARROW_THREADS edges; backward: blocks taking spans of
# FRONT_SPAN_ROWS edges, a warp per 32-edge tile)
FRONT_NARROW_DE, FRONT_NARROW_DQ = 2, 4
FRONT_NARROW_THREADS = 256  # kTileThreads
FRONT_SPAN_ROWS = 8 * TILE_ROWS

_P, _I, _F = kb.P, kb.I, kb.F
_SIGNATURES = {
    "gasfm_dual_attend": (_P,) * 9 + (_P, _I, _I) * 2 + (_I,) * 6 + (_F,) + (_P,) * 9,
    "gasfm_dual_attend_bwd": (_P,) * 18 + (_I, _I, _P) + (_I,) * 8 + (_F,) + (_P,) * 8
    + (_I, _P),
    "gasfm_frontend_prologue": (_P, _I, _I, _P, _P, _I, _F, _P, _P, _I, _P, _P, _I, _P, _P,
                                _P, _I, _I, _I, _P),
    "gasfm_frontend_prologue_bwd": (_P, _I, _I, _P, _P, _I, _F, _P, _I, _P, _I) + (_P,) * 6
    + (_I, _I, _I, _P),
}


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    return kb.bind(kb.load("fused_dual_attn"), symbol, _SIGNATURES[symbol])


def head_width(D: int, heads: int) -> int:
    """Features per head C = D / heads; the kernels take D <= 32 and C a
    power of two (one lane per feature, per-head sums by lane shuffles)."""
    C = D // heads
    if D > 32 or C * heads != D or C & (C - 1):
        raise ValueError(f"width {D} with {heads} heads: need D <= 32 and D/heads a power of two")
    return C


def front_sums_len(De: int, Dp: int, Dc: int) -> int:
    """Floats in the prologue backward's partial row of weight gradients
    (``FrontRow`` of csrc/edge_tile.cuh) for the source linears (Dp, De),
    (Dc, De) and the LayerNorm (De,)."""
    return (Dp + Dc) * (De + 1) + 2 * De


def split_front_sums(sums: torch.Tensor, De: int, Dp: int, Dc: int):
    """The prologue backward's summed partial row (``front_sums_len``
    floats) as (d wlp (Dp, De), d blp, d wlc (Dc, De), d blc, d ln_scale,
    d ln_bias), views in the row's order."""
    dwlp, dblp, dwlc, dblc, dg, db = torch.split(sums, (Dp * De, Dp, Dc * De, Dc, De, De))
    return dwlp.view(Dp, De), dblp, dwlc.view(Dc, De), dblc, dg, db


def front_narrow(De: int, Dp: int, Dc: int) -> bool:
    """Whether the prologue (both ways) takes its narrow form at these
    widths: De <= FRONT_NARROW_DE, Dp, Dc <= FRONT_NARROW_DQ (the first
    layer's De = 2, Dp = Dc = 4)."""
    return De <= FRONT_NARROW_DE and max(Dp, Dc) <= FRONT_NARROW_DQ


def front_fwd_grid(device, E: int, De: int, Dp: int, Dc: int) -> int:
    """Blocks of the prologue's forward kernel: a lane per edge in its
    narrow form (ceil(E / FRONT_NARROW_THREADS) blocks), else one per
    32-edge tile, at most TILE_BLOCKS_PER_SM per SM (persistent)."""
    if front_narrow(De, Dp, Dc):
        return max(1, -(-E // FRONT_NARROW_THREADS))
    return kb.grid_for(device, -(-E // TILE_ROWS), 1, per_sm=TILE_BLOCKS_PER_SM)


def front_bwd_grid(device, E: int, De: int, Dp: int, Dc: int) -> int:
    """Blocks of the prologue backward's kernel: one per span of
    FRONT_SPAN_ROWS edges in its narrow form (De <= FRONT_NARROW_DE, Dp, Dc
    <= FRONT_NARROW_DQ), else one per 32-edge tile, at most
    TILE_BLOCKS_PER_SM per SM."""
    rows = FRONT_SPAN_ROWS if front_narrow(De, Dp, Dc) else TILE_ROWS
    return kb.grid_for(device, -(-E // rows), 1, per_sm=TILE_BLOCKS_PER_SM)


# ---------------------------------------------------------------------------
# dual core (#1, backward #2)
# ---------------------------------------------------------------------------


def fused_dual_attend_plain(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads,
                            slope=NEGATIVE_SLOPE):
    """Plain version: two single-direction segment attentions."""
    out_p = gatv2_attend(xl_p, xr_p, att_p, graph.pt_idx, graph.num_pts, heads, slope,
                         side="point")
    out_c = gatv2_attend(xl_c, xr_c, att_c, graph.cam_idx, graph.num_cams, heads, slope)
    return out_p, out_c


def dual_attend_forward(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads,
                        slope=NEGATIVE_SLOPE, residuals=False):
    """Launch the dual core (CUDA tensors). Returns (out_p, out_c, res, ins):
    ``res`` is (m_p, den_p (n, H), m_c, den_c (m, H)) — each segment's
    per-head softmax max and denominator — when ``residuals``, else None;
    ``ins`` the validated inputs. Both CSRs are walked split at SPLIT_ROWS
    edges (``graph.pt_chunks`` / ``cam_chunks``, built once per graph)."""
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    Dp, Dc = xl_p.shape[1], xl_c.shape[1]
    Cp, Cc = head_width(Dp, heads), head_width(Dc, heads)
    al = kb.aligned
    xl_p = al(kb.cuda_f32("xl_p", xl_p, (E, Dp)))
    xl_c = al(kb.cuda_f32("xl_c", xl_c, (E, Dc)))
    xr_p = al(kb.cuda_f32("xr_p", xr_p, (n, Dp)))
    xr_c = al(kb.cuda_f32("xr_c", xr_c, (m, Dc)))
    att_p = al(kb.cuda_f32("att_p", att_p.reshape(-1), (Dp,)))
    att_c = al(kb.cuda_f32("att_c", att_c.reshape(-1), (Dc,)))
    dev = xl_p.device
    out_p, out_c = kb.f32_empty((n, Dp), dev), kb.f32_empty((m, Dc), dev)
    res = None
    if residuals:
        res = (kb.f32_empty((n, heads), dev), kb.f32_empty((n, heads), dev),
               kb.f32_empty((m, heads), dev), kb.f32_empty((m, heads), dev))
    sp, sc = graph.pt_chunks(SPLIT_ROWS), graph.cam_chunks(SPLIT_ROWS)
    part_p = kb.f32_empty((sp.n_chunks, TRIPLE), dev) if sp.n_chunks else None
    part_c = kb.f32_empty((sc.n_chunks, TRIPLE), dev) if sc.n_chunks else None
    p = kb.ptr
    code = _entry("gasfm_dual_attend")(
        p(xl_p), p(xl_c), p(xr_p), p(xr_c), p(att_p), p(att_c),
        p(kb.cuda_i32("pt_ptr", graph.pt_ptr)), p(kb.cuda_i32("cam_ptr", graph.cam_ptr)),
        p(kb.cuda_i32("cam_perm", graph.cam_perm)),
        p(kb.cuda_i32("pt_chunks", sp.table)), sp.n_long, sp.n_chunks,
        p(kb.cuda_i32("cam_chunks", sc.table)), sc.n_long, sc.n_chunks,
        n, m, Dp, Cp, Dc, Cc, float(slope),
        p(out_p), p(out_c), *(p(t) for t in (res or (None,) * 4)), p(part_p), p(part_c),
        kb.stream(dev),
    )
    kb.check(code, "fused_dual_attend")
    fused_dual_attend.launches += 1
    fused_dual_attend.residual_launches += residuals
    return out_p, out_c, res, (xl_p, xl_c, xr_p, xr_c, att_p, att_c)


def dual_attend_combined(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, group,
                         slope=NEGATIVE_SLOPE):
    """The dual core on this rank's edge shard, combined over the edge
    ``group``: (out_p, out_c, (m_p, den_p, m_c, den_c), ins), every output
    and residual the scene's (under table sharding the points' on the
    points the shard's edges touch)."""
    out_p, out_c, res, ins = dual_attend_forward(
        xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope, residuals=True)
    shard = table_shard()
    if shard is None:
        (out_p, m_p, den_p), (out_c, m_c, den_c) = combine_attention_shards(
            [(out_p, res[0], res[1]), (out_c, res[2], res[3])], group)
    else:
        (out_p, m_p, den_p), ((out_c, m_c, den_c),) = exchange_points(
            (out_p, res[0], res[1]), shard, group, heads, cameras=[(out_c, res[2], res[3])])
    return out_p, out_c, (m_p, den_p, m_c, den_c), ins


def dual_attend_residuals(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads,
                          slope=NEGATIVE_SLOPE, plain=False):
    """Both directions with their residuals: (out_p, out_c, (m_p, den_p,
    m_c, den_c)), combined over the edge group under an edge mesh (the
    scene's outputs and residuals). ``plain``: the plain versions, else the
    kernel (CUDA tensors)."""
    group = edge_group()
    if not plain:
        if group is None:
            return dual_attend_forward(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads,
                                       slope, residuals=True)[:3]
        return dual_attend_combined(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, group,
                                    slope)[:3]
    with edge_partitioned(None):  # the rank's own edges; combined below
        pt = gatv2_attend(xl_p, xr_p, att_p, graph.pt_idx, graph.num_pts, heads, slope,
                          residuals=True)
        cam = gatv2_attend(xl_c, xr_c, att_c, graph.cam_idx, graph.num_cams, heads, slope,
                           residuals=True)
    shard = None if group is None else table_shard()
    if shard is not None:
        pt, (cam,) = exchange_points(pt, shard, group, heads, cameras=[cam])
    elif group is not None:
        pt, cam = combine_attention_shards([pt, cam], group)
    return pt[0], cam[0], (pt[1], pt[2], cam[1], cam[2])


def attend_bwd_plain(xl, xr, att, out, m, den, g, seg_ids, num_segments, heads,
                     slope=NEGATIVE_SLOPE):
    """Plain version of one direction of the dual core's backward, the
    kernel's formulas (csrc/attend_split.cuh): alpha = exp(min(l - m, 0)) /
    den with the forward's m and den, dl = alpha (g . (xl - out)) per head,
    d xl = alpha g + dz, d xr the segment sums of dz, d att the sum of dl
    gz. At the forward's own xl this is autograd's gradient; at rows
    recomputed from a stored stream it is the JAX package's backward kernel's
    (``fused_layer_step.py:466-511``). Returns (dxl, dxr, datt (D,))."""
    E, D = xl.shape
    C = D // heads
    s = seg_ids.long()
    z = xl + xr[s]
    gz = F.leaky_relu(z, slope)
    logits = (gz * att.reshape(D)).reshape(E, heads, C).sum(-1)
    inv = torch.where(den > 0, 1.0 / den.clamp_min(1e-38), torch.zeros_like(den))
    alpha = torch.exp(torch.clamp(logits - m[s], max=0.0)) * inv[s]  # (E, H)
    gs = g.reshape(-1, heads, C)[s]  # (E, H, C)
    dl = alpha * (gs * (xl.reshape(E, heads, C) - out.reshape(-1, heads, C)[s])).sum(-1)
    dz = (dl[:, :, None] * att.reshape(1, heads, C)).reshape(E, D) * torch.where(
        z >= 0, torch.ones_like(z), torch.full_like(z, slope))
    dxl = (alpha[:, :, None] * gs).reshape(E, D) + dz
    dxr = xl.new_zeros((num_segments, D)).index_add_(0, s, dz)
    datt = (dl[:, :, None] * gz.reshape(E, heads, C)).sum(0).reshape(D)
    return dxl, dxr, datt


def dual_attend_bwd_plain(xl_p, xl_c, xr_p, xr_c, att_p, att_c, out_p, out_c,
                          m_p, den_p, m_c, den_c, g_p, g_c, graph, heads,
                          slope=NEGATIVE_SLOPE):
    """Plain version of :func:`fused_dual_attend_bwd`, the same operands and
    results (:func:`attend_bwd_plain` per direction)."""
    dxl_p, dxr_p, datt_p = attend_bwd_plain(xl_p, xr_p, att_p, out_p, m_p, den_p, g_p,
                                            graph.pt_idx, graph.num_pts, heads, slope)
    dxl_c, dxr_c, datt_c = attend_bwd_plain(xl_c, xr_c, att_c, out_c, m_c, den_c, g_c,
                                            graph.cam_idx, graph.num_cams, heads, slope)
    return dxl_p, dxl_c, dxr_p, dxr_c, datt_p, datt_c


def exchange_dual_cotangents(g_p, g_c, group, shard):
    """The outputs' cotangents at the dual core's backward entry under an
    edge mesh: summed over the edge group, or under table sharding the
    points' boundary rows added; as they are without a mesh."""
    if shard is not None:
        g_p, (g_c,) = exchange_cotangents(g_p, shard, group, [g_c])
    elif group is not None:
        g_p, g_c = sum_cotangents([g_p, g_c], group)
    return g_p, g_c


class _DualAttend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope):
        group = edge_group()
        if group is None:
            out_p, out_c, res, ins = dual_attend_forward(
                xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope, residuals=True)
        else:
            out_p, out_c, res, ins = dual_attend_combined(
                xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, group, slope)
        ctx.save_for_backward(*ins, out_p, out_c, *res)
        ctx.graph, ctx.heads, ctx.slope, ctx.group = graph, heads, slope, group
        ctx.shard = None if group is None else table_shard()
        ctx.att_shapes = (att_p.shape, att_c.shape)
        return out_p, out_c

    @staticmethod
    def backward(ctx, g_p, g_c):
        saved = ctx.saved_tensors
        g_p, g_c = exchange_dual_cotangents(g_p, g_c, ctx.group, ctx.shard)
        dxl_p, dxl_c, dxr_p, dxr_c, datt_p, datt_c = fused_dual_attend_bwd(
            *saved, g_p, g_c, ctx.graph, ctx.heads, ctx.slope)
        return (dxl_p, dxl_c, dxr_p, dxr_c, datt_p.reshape(ctx.att_shapes[0]),
                datt_c.reshape(ctx.att_shapes[1]), None, None, None)


def fused_dual_attend(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads,
                      slope=NEGATIVE_SLOPE):
    """Both aggregations of a layer. xl_p (E, Dp) / xl_c (E, Dc): source
    rows; xr_p (n, Dp) / xr_c (m, Dc): per-segment queries; att_p (Dp,) /
    att_c (Dc,). Returns (out_pt (n, Dp), out_cam (m, Dc))."""
    if xl_p.device.type == "cpu":
        return fused_dual_attend_plain(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope)
    if kb.needs_grad(xl_p, xl_c, xr_p, xr_c, att_p, att_c):
        return _DualAttend.apply(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope)
    group = edge_group()
    if group is not None:
        return dual_attend_combined(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, group,
                                    slope)[:2]
    out_p, out_c, _, _ = dual_attend_forward(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph,
                                             heads, slope)
    return out_p, out_c


fused_dual_attend.launches = 0
fused_dual_attend.residual_launches = 0  # launches that also wrote the max / den residuals


def fused_dual_attend_bwd(xl_p, xl_c, xr_p, xr_c, att_p, att_c, out_p, out_c,
                          m_p, den_p, m_c, den_c, g_p, g_c, graph, heads,
                          slope=NEGATIVE_SLOPE):
    """The dual core's backward kernel (CUDA tensors): the forward's inputs,
    outputs and residuals (see :func:`dual_attend_forward`) and the outputs'
    cotangents g_p (n, Dp), g_c (m, Dc). Returns (dxl_p, dxl_c, dxr_p,
    dxr_c, datt_p (Dp,), datt_c (Dc,)). Its plain version is autograd
    through :func:`fused_dual_attend_plain`."""
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    Dp, Dc = xl_p.shape[1], xl_c.shape[1]
    Cp, Cc = head_width(Dp, heads), head_width(Dc, heads)
    g_p = kb.cuda_f32("g_p", g_p, (n, Dp))
    g_c = kb.cuda_f32("g_c", g_c, (m, Dc))
    ins = [kb.aligned(kb.cuda_f32(name, t)) for name, t in (
        ("xl_p", xl_p), ("xl_c", xl_c), ("xr_p", xr_p), ("xr_c", xr_c), ("att_p", att_p),
        ("att_c", att_c), ("out_p", out_p), ("out_c", out_c), ("m_p", m_p),
        ("den_p", den_p), ("m_c", m_c), ("den_c", den_c), ("g_p", g_p), ("g_c", g_c))]
    dev = ins[0].device
    sp, sc = graph.pt_chunks(SPLIT_ROWS), graph.cam_chunks(SPLIT_ROWS)
    # units of the main launch: long camera and point chunks, cameras, point quads
    units = sc.n_chunks + sp.n_chunks + m + -(-n // 4)
    grid = kb.grid_for(dev, units, DUAL_BWD_WARPS, per_sm=DUAL_BWD_BLOCKS_PER_SM)
    dxl_p, dxl_c = kb.f32_empty((E, Dp), dev), kb.f32_empty((E, Dc), dev)
    dxr_p, dxr_c = kb.f32_empty((n, Dp), dev), kb.f32_empty((m, Dc), dev)
    datt = kb.f32_empty((2, 32), dev)
    partials = kb.f32_empty((grid, 64), dev)
    dxr_part_p = kb.f32_empty((sp.n_chunks, 32), dev) if sp.n_chunks else None
    dxr_part_c = kb.f32_empty((sc.n_chunks, 32), dev) if sc.n_chunks else None
    p = kb.ptr
    code = _entry("gasfm_dual_attend_bwd")(
        *(p(t) for t in ins),
        p(kb.cuda_i32("pt_ptr", graph.pt_ptr)), p(kb.cuda_i32("cam_ptr", graph.cam_ptr)),
        p(kb.cuda_i32("cam_perm", graph.cam_perm)),
        p(kb.cuda_i32("pt_chunks", sp.table)), sp.n_long, sp.n_chunks,
        p(kb.cuda_i32("cam_chunks", sc.table)), sc.n_long, sc.n_chunks,
        n, m, Dp, Cp, Dc, Cc, float(slope),
        p(dxl_p), p(dxl_c), p(dxr_p), p(dxr_c), p(datt), p(dxr_part_p), p(dxr_part_c),
        p(partials), grid, kb.stream(dev),
    )
    kb.check(code, "fused_dual_attend_bwd")
    fused_dual_attend_bwd.launches += 1
    return dxl_p, dxl_c, dxr_p, dxr_c, datt[0, :Dp], datt[1, :Dc]


fused_dual_attend_bwd.launches = 0


# ---------------------------------------------------------------------------
# layer frontend (#3, backward #4)
# ---------------------------------------------------------------------------


def frontend_prologue_plain(e, ln_scale, ln_bias, wlp, blp, wlc, blc, eps=LN_EPS,
                            raw_prologue=False):
    """Plain version of the per-edge prologue: (en = relu(LN(e)) or e under
    raw, xl_p, xl_c), in float32 from a bf16 ``e`` upcast."""
    e = kb.upcast(e)
    en = e if raw_prologue else layer_norm_relu(e, ln_scale, ln_bias, eps)
    return en, F.linear(en, wlp, blp), F.linear(en, wlc, blc)


def en_dtype_of(e, en_dtype=None) -> torch.dtype:
    """The stored dtype of the frontend's e_norm: ``en_dtype`` (the model's
    stream dtype) or e's own; a bf16 e gives a bf16 e_norm."""
    dtype = en_dtype or e.dtype
    if e.dtype == torch.bfloat16 and dtype != torch.bfloat16:
        raise TypeError(f"fused_frontend: a bf16 edge stream stores its e_norm in bf16, "
                        f"not {dtype}")
    return dtype


def fused_frontend_plain(e, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c,
                         att_p, att_c, graph, heads, eps=LN_EPS,
                         raw_prologue=False, slope=NEGATIVE_SLOPE, en_dtype=None):
    """Plain version: LN + ReLU, the two source linears, the dual core. The
    linears take e_norm in float32; e_norm is returned rounded to bf16 where
    it is stored so (:func:`en_dtype_of`)."""
    en, xl_p, xl_c = frontend_prologue_plain(e, ln_scale, ln_bias, wlp, blp, wlc, blc, eps,
                                             raw_prologue)
    out_p, out_c = fused_dual_attend_plain(xl_p, xl_c, xr_p, xr_c, att_p, att_c,
                                           graph, heads, slope)
    if raw_prologue:
        return e, out_p, out_c
    if en_dtype_of(e, en_dtype) == torch.bfloat16:
        en = en.to(torch.bfloat16)
    return en, out_p, out_c


def frontend_prologue(e, ln_scale, ln_bias, wlp, blp, wlc, blc, eps=LN_EPS,
                      raw_prologue=False, en_dtype=None, want_en=True):
    """Launch the per-edge prologue (CUDA tensors). Returns (en, xl_p, xl_c);
    under ``raw_prologue`` en is ``e``, without ``want_en`` None (not
    written). e is float32 or bf16; en is stored in :func:`en_dtype_of`
    (rounded in the kernel)."""
    E, De = e.shape
    Dp, Dc = wlp.shape[0], wlc.shape[0]
    if De > 32 or Dp > 32 or Dc > 32:
        raise ValueError(f"fused_frontend: widths De={De}, Dp={Dp}, Dc={Dc} must be <= 32")
    e = kb.aligned(kb.cuda_stream("e", e, kb.stream_dtype(e), (E, De)))
    en_dtype = en_dtype_of(e, en_dtype)
    if not raw_prologue:
        ln_scale = kb.cuda_f32("ln_scale", ln_scale, (De,))
        ln_bias = kb.cuda_f32("ln_bias", ln_bias, (De,))
    wlp = kb.cuda_f32("wlp", wlp, (Dp, De))
    blp = kb.cuda_f32("blp", blp, (Dp,))
    wlc = kb.cuda_f32("wlc", wlc, (Dc, De))
    blc = kb.cuda_f32("blc", blc, (Dc,))
    dev = e.device
    en = e if raw_prologue else (torch.empty((E, De), dtype=en_dtype, device=dev) if want_en
                                 else None)
    xl_p, xl_c = kb.f32_empty((E, Dp), dev), kb.f32_empty((E, Dc), dev)
    p = kb.ptr
    code = _entry("gasfm_frontend_prologue")(
        p(e), E, De, p(None if raw_prologue else ln_scale), p(None if raw_prologue else ln_bias),
        int(raw_prologue), float(eps), p(wlp), p(blp), Dp, p(wlc), p(blc), Dc,
        p(None if raw_prologue else en), p(xl_p), p(xl_c), kb.is_bf16(e.dtype),
        kb.is_bf16(en_dtype), front_fwd_grid(dev, E, De, Dp, Dc), kb.stream(dev),
    )
    kb.check(code, "fused_frontend")
    fused_frontend.launches += 1
    fused_frontend.bf16_launches += kb.is_bf16(en_dtype)
    return en, xl_p, xl_c


class _FrontendPrologue(torch.autograd.Function):
    """The prologue under autograd: outputs (en, xl_p, xl_c), or (xl_p,
    xl_c) under ``raw`` (en is then the input itself, outside the Function)."""

    @staticmethod
    def forward(ctx, e, ln_scale, ln_bias, wlp, blp, wlc, blc, eps, raw, en_dtype):
        en, xl_p, xl_c = frontend_prologue(e, ln_scale, ln_bias, wlp, blp, wlc, blc, eps, raw,
                                           en_dtype)
        ctx.save_for_backward(e, ln_scale, ln_bias, wlp, wlc)
        ctx.eps, ctx.raw = eps, raw
        return (xl_p, xl_c) if raw else (en, xl_p, xl_c)

    @staticmethod
    def backward(ctx, *grads):
        e, ln_scale, ln_bias, wlp, wlc = ctx.saved_tensors
        den, dxl_p, dxl_c = (None, *grads) if ctx.raw else grads
        de, dln_scale, dln_bias, dwlp, dblp, dwlc, dblc = fused_frontend_bwd(
            e, ln_scale, ln_bias, wlp, wlc, dxl_p, dxl_c, den, eps=ctx.eps,
            raw_prologue=ctx.raw)
        return de, dln_scale, dln_bias, dwlp, dblp, dwlc, dblc, None, None, None


def fused_frontend(e, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c,
                   att_p, att_c, graph, heads, eps=LN_EPS, raw_prologue=False,
                   slope=NEGATIVE_SLOPE, en_dtype=None):
    """e (E, De) raw edge features (float32, or a bf16 stream); ln_scale/
    ln_bias (De,) (ignored under ``raw_prologue``); wlp (Dp, De), blp (Dp,),
    wlc (Dc, De), blc (Dc,) the source linears in torch layout; the rest as
    in :func:`fused_dual_attend`. ``en_dtype``: e_norm's stored dtype
    (:func:`en_dtype_of`; the linears take it unrounded). Returns (e_norm =
    relu(LN(e)) or e under raw, out_pt, out_cam)."""
    if e.device.type == "cpu":
        return fused_frontend_plain(e, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c,
                                    att_p, att_c, graph, heads, eps, raw_prologue, slope,
                                    en_dtype)
    if e.shape[0] != graph.num_edges:
        raise ValueError(f"fused_frontend: {e.shape[0]} edge rows for {graph.num_edges} edges")
    if kb.needs_grad(e, ln_scale, ln_bias, wlp, blp, wlc, blc):
        outs = _FrontendPrologue.apply(e, ln_scale, ln_bias, wlp, blp, wlc, blc, eps,
                                       raw_prologue, en_dtype)
        en, xl_p, xl_c = (e, *outs) if raw_prologue else outs
    else:
        en, xl_p, xl_c = frontend_prologue(e, ln_scale, ln_bias, wlp, blp, wlc, blc, eps,
                                           raw_prologue, en_dtype)
    out_p, out_c = fused_dual_attend(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope)
    return en, out_p, out_c


fused_frontend.launches = 0
fused_frontend.bf16_launches = 0  # of them, launches on bf16 streams (a bf16 e or e_norm)


def fused_frontend_bwd(e, ln_scale, ln_bias, wlp, wlc, dxl_p, dxl_c, den=None, en=None,
                       eps=LN_EPS, raw_prologue=False):
    """The prologue's backward kernel (CUDA tensors): e (E, De) the
    prologue's input, the LayerNorm and source-linear weights, the
    cotangents of xl_p (E, Dp) and xl_c (E, Dc) (the dual core's backward
    gives them) and of e_norm (E, De, or None). ``en``, the forward's
    e_norm, is not read: the kernel recomputes it from e with the
    LayerNorm's statistics, which its backward needs anyway. Returns (de,
    dln_scale, dln_bias, dwlp, dblp, dwlc, dblc); the LayerNorm's are None
    under ``raw_prologue``; de is in e's dtype (float32, or bf16 rounded from
    the float32 sums), and den, where given, in e_norm's stored dtype
    (:func:`en_dtype_of`). Its plain version is autograd through
    :func:`fused_frontend_plain`."""
    E, De = e.shape
    Dp, Dc = wlp.shape[0], wlc.shape[0]
    if max(De, Dp, Dc) > 32:
        raise ValueError(f"fused_frontend_bwd: widths De={De}, Dp={Dp}, Dc={Dc} must be <= 32")
    al = kb.aligned
    e = al(kb.cuda_stream("e", e, kb.stream_dtype(e), (E, De)))
    den_dtype = e.dtype if den is None else en_dtype_of(e, kb.stream_dtype(den))
    if not raw_prologue:
        ln_scale = kb.cuda_f32("ln_scale", ln_scale, (De,))
        ln_bias = kb.cuda_f32("ln_bias", ln_bias, (De,))
    wlp = kb.cuda_f32("wlp", wlp, (Dp, De))
    wlc = kb.cuda_f32("wlc", wlc, (Dc, De))
    dxl_p = al(kb.cuda_f32("dxl_p", dxl_p, (E, Dp)))
    dxl_c = al(kb.cuda_f32("dxl_c", dxl_c, (E, Dc)))
    if den is not None:
        den = al(kb.cuda_stream("den", den, den_dtype, (E, De)))
    dev = e.device
    grid = front_bwd_grid(dev, E, De, Dp, Dc)
    row = front_sums_len(De, Dp, Dc)
    de = torch.empty((E, De), dtype=e.dtype, device=dev)
    partials, sums = kb.f32_empty((grid, row), dev), kb.f32_empty((row,), dev)
    p = kb.ptr
    code = _entry("gasfm_frontend_prologue_bwd")(
        p(e), E, De, p(None if raw_prologue else ln_scale), p(None if raw_prologue else ln_bias),
        int(raw_prologue), float(eps), p(wlp), Dp, p(wlc), Dc, p(dxl_p), p(dxl_c), p(den),
        p(de), p(partials), p(sums), kb.is_bf16(e.dtype), kb.is_bf16(den_dtype), grid,
        kb.stream(dev),
    )
    kb.check(code, "fused_frontend_bwd")
    fused_frontend_bwd.launches += 1
    fused_frontend_bwd.bf16_launches += kb.is_bf16(den_dtype)
    dwlp, dblp, dwlc, dblc, dg, db = split_front_sums(sums, De, Dp, Dc)
    if raw_prologue:
        dg = db = None
    return de, dg, db, dwlp, dblp, dwlc, dblc


fused_frontend_bwd.launches = 0
fused_frontend_bwd.bf16_launches = 0
