"""Merged layer step: CUDA kernel for Hopper (``csrc/fused_layer_step.cu``),
forward and backward, its plain PyTorch version, and its launch counters.

Replaces the TPU kernels of ``gasfm_tpu/ops/pallas/fused_layer_step.py``
(``fused_layer_step`` / ``_fwd_raw``; backward ``_bwd_raw`` / ``_bwd_body``):
layer l's deferred projection update

    e_l = ([en | skip2] W^T + b + pg + ps[pt] + pv[cam]) / 4  (+ res)

fused with layer l+1's frontend prologue (LayerNorm + ReLU, skipped under
``raw_prologue``, and the two GATv2 source linears), followed by the dual
core. Two launches per call: the per-edge prologue (counted here) and the
dual core (counted by ``fused_dual_attend``). The backward mirrors it: the
dual core's backward (counted by ``fused_dual_attend_bwd``), then
``fused_layer_step_bwd`` (counted here; four launches inside: the edge-tile
kernel, one column sum of its per-block partial rows of the weight
gradients, and the point and camera segment sums of d e_l / 4, the segment
sum's kernel, with its merge launch where a hub exists).

What bounds it on the H100 is bytes over its 3.35 TB/s: 784 bytes of edge
streams per edge at the flagship's interior widths against ~3.1k float32
FMAs. Both directions take tiles of 32 edges in persistent blocks that hold
the weights in shared memory (``csrc/edge_tile.cuh``) and run the small
products register-tiled on the CUDA cores in float32. The forward keeps e_l
in registers between the update and the LayerNorm, touches each stream
once, and has the next tile's rows in flight while a tile computes; the
backward recomputes the LayerNorm and its output from the saved e_l and
sums every weight gradient in registers without atomics.

A CPU tensor runs the plain version (and autograd through it is the
backward's plain version); a CUDA tensor launches the kernel or raises.

Under an edge mesh (the JAX package's ``fused_layer_step.py:856-952``) the
prologue and its backward are per edge and need no collective: their
segment sums of d e_l / 4 are the rank's partial table cotangents. The
combine of the shards' softmax and the sum of the aggregations' cotangents
over the edge group happen in the dual core (``fused_dual_attend``), which
the layer step calls.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from gasfm_tpu_torch.ops.gatv2 import NEGATIVE_SLOPE, layer_norm_relu
from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.kernels.fused_dual_attn import (
    LN_EPS,
    fused_dual_attend,
    fused_dual_attend_plain,
)
from gasfm_tpu_torch.ops.kernels.fused_proj_update import (
    TILE_BLOCKS_PER_SM,
    TILE_ROWS,
    projection_update_plain,
)
from gasfm_tpu_torch.ops.kernels.segment_kernels import sum_split

FWD_BLOCKS_PER_SM = 3  # kStepFwdBlocksPerSm: the forward's

_ARGS = (
    kb.P, kb.I, kb.P, kb.I,  # en, d_in, skip2, d2
    kb.P, kb.P, kb.P, kb.P, kb.P, kb.P, kb.P, kb.P,  # res, w, b, pg, ps, pv, pt_idx, cam_idx
    kb.I, kb.I, kb.P, kb.P, kb.I, kb.F,  # E, De, lng, lnb, raw, eps
    kb.P, kb.P, kb.I, kb.P, kb.P, kb.I,  # wlp, blp, Dp, wlc, blc, Dc
    kb.P, kb.P, kb.P, kb.P, kb.I, kb.P,  # e_l, en_next, xl_p, xl_c, grid, stream
)
_BWD_ARGS = (
    kb.P, kb.I, kb.P, kb.I, kb.P, kb.P,  # en, d_in, skip2, d2, w, e_l
    kb.P, kb.I, kb.P, kb.P, kb.I,  # pt_ptr, n_pts, cam_ptr, cam_perm, n_cams
    kb.P, kb.I, kb.I, kb.P, kb.I, kb.I, kb.P, kb.P,  # the sums' splits and their scratch
    kb.I, kb.I,  # E, De
    kb.P, kb.P, kb.I, kb.F, kb.P, kb.I, kb.P, kb.I,  # lng, lnb, raw, eps, wlp, Dp, wlc, Dc
    kb.P, kb.P, kb.P, kb.P,  # dxl_p, dxl_c, den_next, de_l_ext
    kb.P, kb.P, kb.P, kb.P, kb.P,  # d_el, den_out, dskip2, dps, dpv
    kb.P, kb.P, kb.I, kb.P,  # partials, sums, grid, stream
)


@functools.lru_cache(maxsize=None)
def _entry(symbol="gasfm_layer_step_prologue"):
    args = {"gasfm_layer_step_prologue": _ARGS, "gasfm_layer_step_bwd": _BWD_ARGS}[symbol]
    return kb.bind(kb.load("fused_layer_step"), symbol, args)


def layer_step_prologue_plain(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                              wlp, blp, wlc, blc, graph, eps=LN_EPS, raw_prologue=False):
    """Plain version of :func:`layer_step_prologue`: the update, the next
    layer's LayerNorm + ReLU (not under ``raw_prologue``) and its two source
    linears. Returns (e_l, en_next, xl_p, xl_c)."""
    e_l = projection_update_plain(en, skip2, res, w, b, ps, pv, pg, graph)
    en_next = e_l if raw_prologue else layer_norm_relu(e_l, ln_scale, ln_bias, eps)
    return e_l, en_next, F.linear(en_next, wlp, blp), F.linear(en_next, wlc, blc)


def fused_layer_step_plain(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                           wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c, graph, heads,
                           eps=LN_EPS, raw_prologue=False, slope=NEGATIVE_SLOPE):
    """Plain version: the prologue, then the dual core."""
    e_l, en_next, xl_p, xl_c = layer_step_prologue_plain(
        en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias, wlp, blp, wlc, blc, graph, eps,
        raw_prologue)
    out_p, out_c = fused_dual_attend_plain(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads,
                                           slope)
    return e_l, en_next, out_p, out_c


def layer_step_prologue(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                        wlp, blp, wlc, blc, graph, eps=LN_EPS, raw_prologue=False):
    """Launch the per-edge prologue (CUDA tensors). Returns (e_l, en_next,
    xl_p, xl_c); under ``raw_prologue`` en_next is e_l."""
    E, d_in = en.shape
    n, m = graph.num_pts, graph.num_cams
    De = w.shape[0]
    d2 = 0 if skip2 is None else skip2.shape[1]
    Dp, Dc = wlp.shape[0], wlc.shape[0]
    if max(d_in, d2, De, Dp, Dc) > 32 or E != graph.num_edges:
        raise ValueError("fused_layer_step: every width must be <= 32")
    al = kb.aligned
    en = al(kb.cuda_f32("en", en, (E, d_in)))
    if skip2 is not None:
        skip2 = al(kb.cuda_f32("skip2", skip2, (E, d2)))
    if res is not None:
        res = al(kb.cuda_f32("res", res, (E, De)))
    w = kb.cuda_f32("w", w, (De, d_in + d2))
    b = kb.cuda_f32("b", b, (De,))
    pg = kb.cuda_f32("pg", pg.reshape(-1), (De,))
    ps = al(kb.cuda_f32("ps", ps, (n, De)))
    pv = al(kb.cuda_f32("pv", pv, (m, De)))
    if not raw_prologue:
        ln_scale = kb.cuda_f32("ln_scale", ln_scale, (De,))
        ln_bias = kb.cuda_f32("ln_bias", ln_bias, (De,))
    wlp = kb.cuda_f32("wlp", wlp, (Dp, De))
    blp = kb.cuda_f32("blp", blp, (Dp,))
    wlc = kb.cuda_f32("wlc", wlc, (Dc, De))
    blc = kb.cuda_f32("blc", blc, (Dc,))
    pt_idx = kb.cuda_i32("pt_idx", graph.pt_idx)
    cam_idx = kb.cuda_i32("cam_idx", graph.cam_idx)
    dev = en.device
    e_l = kb.f32_empty((E, De), dev)
    en_next = e_l if raw_prologue else torch.empty_like(e_l)
    xl_p, xl_c = kb.f32_empty((E, Dp), dev), kb.f32_empty((E, Dc), dev)
    p = kb.ptr
    ln_s, ln_b, en_out = (None, None, None) if raw_prologue else (ln_scale, ln_bias, en_next)
    code = _entry()(
        p(en), d_in, p(skip2), d2, p(res), p(w), p(b), p(pg), p(ps), p(pv),
        p(pt_idx), p(cam_idx), E, De, p(ln_s), p(ln_b), int(raw_prologue), float(eps),
        p(wlp), p(blp), Dp, p(wlc), p(blc), Dc, p(e_l), p(en_out), p(xl_p), p(xl_c),
        kb.grid_for(dev, -(-E // TILE_ROWS), 1, per_sm=FWD_BLOCKS_PER_SM), kb.stream(dev),
    )
    kb.check(code, "fused_layer_step")
    fused_layer_step.launches += 1
    return e_l, en_next, xl_p, xl_c


class _LayerStepPrologue(torch.autograd.Function):
    """The prologue under autograd: outputs (e_l, en_next, xl_p, xl_c), or
    (e_l, xl_p, xl_c) under ``raw`` (en_next is e_l, outside the Function)."""

    @staticmethod
    def forward(ctx, en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                wlp, blp, wlc, blc, graph, eps, raw):
        e_l, en_next, xl_p, xl_c = layer_step_prologue(
            en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias, wlp, blp, wlc, blc, graph,
            eps, raw)
        ctx.save_for_backward(en, skip2, w, e_l, ln_scale, ln_bias, wlp, wlc)
        ctx.graph, ctx.eps, ctx.raw, ctx.has_res = graph, eps, raw, res is not None
        ctx.pg_shape = pg.shape
        return (e_l, xl_p, xl_c) if raw else (e_l, en_next, xl_p, xl_c)

    @staticmethod
    def backward(ctx, *grads):
        en, skip2, w, e_l, ln_scale, ln_bias, wlp, wlc = ctx.saved_tensors
        if ctx.raw:
            de_l, dxl_p, dxl_c = grads
            den_next = None
        else:
            de_l, den_next, dxl_p, dxl_c = grads
        (den, dskip2, dres, dw, db, dps, dpv, dln_scale, dln_bias, dwlp, dblp, dwlc,
         dblc) = fused_layer_step_bwd(en, skip2, w, e_l, ln_scale, ln_bias, wlp, wlc, ctx.graph,
                                      dxl_p, dxl_c, den_next, de_l, ctx.eps, ctx.raw)
        return (den, dskip2, dres if ctx.has_res else None, dw, db, dps, dpv,
                db.reshape(ctx.pg_shape), dln_scale, dln_bias, dwlp, dblp, dwlc, dblc,
                None, None, None)


def fused_layer_step(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                     wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c, graph, heads,
                     eps=LN_EPS, raw_prologue=False, slope=NEGATIVE_SLOPE):
    """en (E, d_in) the previous layer's normalized stream; skip2 (E, d2) or
    None; res (E, De) or None; w (De, d_in + d2) lin_proj's weight (columns
    for en, then skip2); b (De,); ps (n, De), pv (m, De), pg (1, De) the
    table linears; then the NEXT layer's frontend parameters as in
    :func:`fused_frontend`. Returns (e_l, e_norm_next, out_pt, out_cam);
    under ``raw_prologue`` e_norm_next is e_l."""
    if en.device.type == "cpu":
        return fused_layer_step_plain(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                                      wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c,
                                      graph, heads, eps, raw_prologue, slope)
    if kb.needs_grad(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias, wlp, blp, wlc, blc):
        outs = _LayerStepPrologue.apply(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                                        wlp, blp, wlc, blc, graph, eps, raw_prologue)
        e_l, en_next, xl_p, xl_c = (outs[0], *outs) if raw_prologue else outs
    else:
        e_l, en_next, xl_p, xl_c = layer_step_prologue(
            en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias, wlp, blp, wlc, blc, graph,
            eps, raw_prologue)
    out_p, out_c = fused_dual_attend(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope)
    return e_l, en_next, out_p, out_c


fused_layer_step.launches = 0


def step_sums_len(De, K, Dp, Dc):
    """Floats in the backward's partial row of weight gradients (``StepRow``
    of csrc/edge_tile.cuh) for the update's W (De, K) and the source
    linears (Dp, De), (Dc, De)."""
    return (Dp + Dc) * (De + 1) + De * (K + 1) + 2 * De


def split_step_sums(sums, De, K, Dp, Dc):
    """The backward's summed partial row (``step_sums_len`` floats) as
    (d wlp (Dp, De), d blp, d wlc (Dc, De), d blc, d w (De, K), d b,
    d ln_scale, d ln_bias), views in the row's order."""
    dwlp, dblp, dwlc, dblc, dw, db, dg, dbn = torch.split(
        sums, (Dp * De, Dp, Dc * De, Dc, De * K, De, De, De))
    return dwlp.view(Dp, De), dblp, dwlc.view(Dc, De), dblc, dw.view(De, K), db, dg, dbn


def fused_layer_step_bwd(en, skip2, w, e_l, ln_scale, ln_bias, wlp, wlc, graph,
                         dxl_p, dxl_c, den_next=None, de_l=None, eps=LN_EPS,
                         raw_prologue=False):
    """The layer step prologue's backward kernel (CUDA tensors): the update's
    inputs en (E, d_in), skip2 (E, d2) or None and weight w (De, d_in + d2),
    the saved e_l (E, De; the kernel recomputes the LayerNorm's output from
    it), the next layer's LayerNorm and source-linear weights, the cotangents
    of xl_p / xl_c (from the dual core's backward), of e_norm_next (or None)
    and of e_l (or None). Returns (den, dskip2, dres, dw, db, dps, dpv,
    dln_scale, dln_bias, dwlp, dblp, dwlc, dblc): dres is the total
    cotangent of e_l, and d pg equals db. Its plain version is autograd
    through :func:`fused_layer_step_plain`."""
    E, d_in = en.shape
    n, m = graph.num_pts, graph.num_cams
    De = w.shape[0]
    d2 = 0 if skip2 is None else skip2.shape[1]
    K = d_in + d2
    Dp, Dc = wlp.shape[0], wlc.shape[0]
    if max(d_in, d2, De, Dp, Dc) > 32 or E != graph.num_edges:
        raise ValueError("fused_layer_step_bwd: every width must be <= 32")
    al = kb.aligned
    en = al(kb.cuda_f32("en", en, (E, d_in)))
    if skip2 is not None:
        skip2 = al(kb.cuda_f32("skip2", skip2, (E, d2)))
    w = kb.cuda_f32("w", w, (De, K))
    e_l = al(kb.cuda_f32("e_l", e_l, (E, De)))
    if not raw_prologue:
        ln_scale = kb.cuda_f32("ln_scale", ln_scale, (De,))
        ln_bias = kb.cuda_f32("ln_bias", ln_bias, (De,))
    wlp = kb.cuda_f32("wlp", wlp, (Dp, De))
    wlc = kb.cuda_f32("wlc", wlc, (Dc, De))
    dxl_p = al(kb.cuda_f32("dxl_p", dxl_p, (E, Dp)))
    dxl_c = al(kb.cuda_f32("dxl_c", dxl_c, (E, Dc)))
    if den_next is not None:
        den_next = al(kb.cuda_f32("den_next", den_next, (E, De)))
    if de_l is not None:
        de_l = al(kb.cuda_f32("de_l", de_l, (E, De)))
    dev = en.device
    grid = kb.grid_for(dev, -(-E // TILE_ROWS), 1, per_sm=TILE_BLOCKS_PER_SM)
    row = step_sums_len(De, K, Dp, Dc)
    d_el = kb.f32_empty((E, De), dev)
    den = kb.f32_empty((E, d_in), dev)
    dskip2 = None if skip2 is None else kb.f32_empty((E, d2), dev)
    dps, dpv = kb.f32_empty((n, De), dev), kb.f32_empty((m, De), dev)
    partials, sums = kb.f32_empty((grid, row), dev), kb.f32_empty((row,), dev)
    split_p, n_long_p, n_chunks_p, part_p = sum_split(graph, "point", De, dev)
    split_c, n_long_c, n_chunks_c, part_c = sum_split(graph, "camera", De, dev)
    p = kb.ptr
    ln_s, ln_b = (None, None) if raw_prologue else (ln_scale, ln_bias)
    code = _entry("gasfm_layer_step_bwd")(
        p(en), d_in, p(skip2), d2, p(w), p(e_l),
        p(kb.cuda_i32("pt_ptr", graph.pt_ptr)), n, p(kb.cuda_i32("cam_ptr", graph.cam_ptr)),
        p(kb.cuda_i32("cam_perm", graph.cam_perm)), m,
        p(split_p), n_long_p, n_chunks_p, p(split_c), n_long_c, n_chunks_c, p(part_p),
        p(part_c), E, De,
        p(ln_s), p(ln_b), int(raw_prologue), float(eps), p(wlp), Dp, p(wlc), Dc,
        p(dxl_p), p(dxl_c), p(den_next), p(de_l),
        p(d_el), p(den), p(dskip2), p(dps), p(dpv), p(partials), p(sums), grid,
        kb.stream(dev),
    )
    kb.check(code, "fused_layer_step_bwd")
    fused_layer_step_bwd.launches += 1
    dwlp, dblp, dwlc, dblc, dw, db, dg, dbn = split_step_sums(sums, De, K, Dp, Dc)
    if raw_prologue:
        dg = dbn = None
    return den, dskip2, d_el, dw, db, dps, dpv, dg, dbn, dwlp, dblp, dwlc, dblc


fused_layer_step_bwd.launches = 0
