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

bf16 edge streams (``compile.stream_dtype``; en, skip2, res all bf16): the
kernels load the rows upcast, compute in float32 and store e_l and
e_norm_next rounded (``csrc/edge_tile.cuh``), as the JAX package's do
(``fused_layer_step.py:196-218``); the source rows xl_p, xl_c stay float32
and unrounded. Under autograd the step runs as :class:`_StoredStep`: it
keeps e_l as stored and no source rows, and its backward recomputes them
from e_l (one more frontend prologue launch, #3 on the bf16 stream), runs
the dual core's backward at them against the forward's softmax, then the
prologue's backward, whose LayerNorm recomputes from e_l too: the JAX
package's backward kernel recomputes both from its saved stream
(``fused_layer_step.py:439-458``). d en, d skip2 and d res come back
bf16, rounded from the float32 total, and the tables' sums take the total
in float32. Its plain version (``plain=True``) is the same Function over
the plain versions (:func:`layer_step_bwd_plain`,
``fused_dual_attn.dual_attend_bwd_plain``).

Under an edge mesh (the JAX package's ``fused_layer_step.py:856-952``) the
prologue and its backward are per edge and need no collective: their
segment sums of d e_l / 4 are the rank's partial table cotangents. The
combine of the shards' softmax and the sum of the aggregations' cotangents
over the edge group happen in the dual core (``fused_dual_attend``), which
the layer step calls.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from gasfm_tpu_torch.ops.gatv2 import NEGATIVE_SLOPE, layer_norm_relu
from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.kernels.fused_dual_attn import (
    LN_EPS,
    dual_attend_bwd_plain,
    dual_attend_residuals,
    exchange_dual_cotangents,
    frontend_prologue,
    frontend_prologue_plain,
    fused_dual_attend,
    fused_dual_attend_bwd,
    fused_dual_attend_plain,
)
from gasfm_tpu_torch.ops.kernels.fused_proj_update import (
    TILE_BLOCKS_PER_SM,
    TILE_ROWS,
    projection_update_plain,
    update_f32,
)
from gasfm_tpu_torch.ops.kernels.segment_kernels import sum_split
from gasfm_tpu_torch.ops.segment import edge_group, table_shard

FWD_BLOCKS_PER_SM = 3  # kStepFwdBlocksPerSm: the forward's
SHIFT_MARGIN = 1.0  # the bf16 step's backward softmax shift above the forward's max
SHIFT_SCALE = math.exp(-SHIFT_MARGIN)  # its denominators' factor

_ARGS = (
    kb.P, kb.I, kb.P, kb.I,  # en, d_in, skip2, d2
    kb.P, kb.P, kb.P, kb.P, kb.P, kb.P, kb.P, kb.P,  # res, w, b, pg, ps, pv, pt_idx, cam_idx
    kb.I, kb.I, kb.P, kb.P, kb.I, kb.F,  # E, De, lng, lnb, raw, eps
    kb.P, kb.P, kb.I, kb.P, kb.P, kb.I,  # wlp, blp, Dp, wlc, blc, Dc
    kb.P, kb.P, kb.P, kb.P, kb.I, kb.I, kb.P,  # e_l, en_next, xl_p, xl_c, bf16, grid, stream
)
_BWD_ARGS = (
    kb.P, kb.I, kb.P, kb.I, kb.P, kb.P,  # en, d_in, skip2, d2, w, e_l
    kb.P, kb.I, kb.P, kb.P, kb.I,  # pt_ptr, n_pts, cam_ptr, cam_perm, n_cams
    kb.P, kb.I, kb.I, kb.P, kb.I, kb.I, kb.P, kb.P,  # the sums' splits and their scratch
    kb.I, kb.I,  # E, De
    kb.P, kb.P, kb.I, kb.F, kb.P, kb.I, kb.P, kb.I,  # lng, lnb, raw, eps, wlp, Dp, wlc, Dc
    kb.P, kb.P, kb.P, kb.P,  # dxl_p, dxl_c, den_next, de_l_ext
    kb.P, kb.P, kb.P, kb.P, kb.P,  # d_el, den_out, dskip2, dps, dpv
    kb.P, kb.P, kb.P, kb.I, kb.I, kb.P,  # partials, sums, dres, bf16, grid, stream
)


@functools.lru_cache(maxsize=None)
def _entry(symbol="gasfm_layer_step_prologue"):
    args = {"gasfm_layer_step_prologue": _ARGS, "gasfm_layer_step_bwd": _BWD_ARGS}[symbol]
    return kb.bind(kb.load("fused_layer_step"), symbol, args)


def layer_step_prologue_plain(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                              wlp, blp, wlc, blc, graph, eps=LN_EPS, raw_prologue=False):
    """Plain version of :func:`layer_step_prologue`: the update, the next
    layer's LayerNorm + ReLU (not under ``raw_prologue``) and its two source
    linears. Returns (e_l, en_next, xl_p, xl_c). With bf16 streams the
    prologue runs on the float32 update, and e_l and en_next are stored
    rounded to bf16 (the JAX package's ``fused_layer_step.py:196-218``)."""
    if en.dtype != torch.bfloat16:
        e_l = projection_update_plain(en, skip2, res, w, b, ps, pv, pg, graph)
        en_next = e_l if raw_prologue else layer_norm_relu(e_l, ln_scale, ln_bias, eps)
        return e_l, en_next, F.linear(en_next, wlp, blp), F.linear(en_next, wlc, blc)
    e_u = update_f32(en, skip2, res, w, b, ps, pv, pg, graph)
    e_l = e_u.to(torch.bfloat16)
    v, xl_p, xl_c = frontend_prologue_plain(e_u, ln_scale, ln_bias, wlp, blp, wlc, blc, eps,
                                            raw_prologue)
    return e_l, e_l if raw_prologue else v.to(torch.bfloat16), xl_p, xl_c


def layer_step_bwd_plain(en, skip2, w, e_l, ln_scale, ln_bias, wlp, wlc, graph,
                         dxl_p, dxl_c, den_next=None, de_l=None, eps=LN_EPS,
                         raw_prologue=False, want_res=True):
    """Plain version of :func:`fused_layer_step_bwd`, the same operands and
    results: autograd of the update and of the next layer's prologue
    recomputed from e_l as stored (a bf16 e_l: the JAX package's backward
    kernel, which recomputes its LayerNorm from the saved stream), the
    update's value taken as e_l's and its gradient passed through."""
    De, K = w.shape
    Dp, Dc = wlp.shape[0], wlc.shape[0]
    with torch.enable_grad():
        def leaf(t):
            return None if t is None else t.detach().requires_grad_()

        ln = (None, None) if raw_prologue else (leaf(ln_scale), leaf(ln_bias))
        en_, skip2_, w_, wlp_, wlc_ = map(leaf, (en, skip2, w, wlp, wlc))
        res_ = e_l.new_zeros(e_l.shape).requires_grad_() if want_res else None
        b_, pg_ = (leaf(e_l.new_zeros((De,), dtype=torch.float32)) for _ in range(2))
        ps_ = leaf(e_l.new_zeros((graph.num_pts, De), dtype=torch.float32))
        pv_ = leaf(e_l.new_zeros((graph.num_cams, De), dtype=torch.float32))
        blp_ = leaf(e_l.new_zeros((Dp,), dtype=torch.float32))
        blc_ = leaf(e_l.new_zeros((Dc,), dtype=torch.float32))
        e_u = update_f32(en_, skip2_, res_, w_, b_, ps_, pv_, pg_, graph)
        e_s = kb.upcast(e_l)
        e_r = e_u + (e_s - e_u).detach()  # e_l's value, the update's gradient
        v, xl_p, xl_c = frontend_prologue_plain(e_r, *ln, wlp_, blp_, wlc_, blc_, eps,
                                                raw_prologue)
        outs = [(e_r, de_l), (xl_p, dxl_p), (xl_c, dxl_c)]
        if not raw_prologue:
            outs.append((v, den_next))
        outs = [(o, kb.upcast(g)) for o, g in outs if g is not None]
        wrt = [t for t in (en_, skip2_, res_, w_, b_, ps_, pv_, *ln, wlp_, blp_, wlc_, blc_)
               if t is not None]
        got = dict(zip(map(id, wrt), torch.autograd.grad(
            [o for o, _ in outs], wrt, [g for _, g in outs], allow_unused=True)))

    def grad(t, like=None):
        if t is None:
            return None
        d = got[id(t)]
        return torch.zeros_like(like if like is not None else t) if d is None else d

    dres = grad(res_)
    return (grad(en_), grad(skip2_), dres, grad(w_), grad(b_), grad(ps_), grad(pv_),
            grad(ln[0]), grad(ln[1]), grad(wlp_), grad(blp_), grad(wlc_), grad(blc_))


class _StoredStep(torch.autograd.Function):
    """The layer step over bf16 streams, as the JAX package's kernels run it
    (``fused_layer_step.py:196-218``, ``:439-530``): the forward takes the
    update e_u in float32 through the next layer's prologue and the dual
    core, storing e_l and en_next rounded; the backward recomputes the
    source rows from e_l as stored (the frontend's prologue on a bf16
    stream, #3), runs the dual core's backward at them against the
    forward's outputs, softmax max and denominators, then the prologue's
    backward, which recomputes its LayerNorm from e_l likewise. ``plain``:
    every stage's plain version (CPU tensors), else its kernel. Outputs
    (e_l, en_next, out_p, out_c), or (e_l, out_p, out_c) under raw."""

    @staticmethod
    def forward(ctx, plain, graph, heads, eps, raw, slope, en, skip2, res, w, b, ps, pv, pg,
                ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c):
        prologue = layer_step_prologue_plain if plain else layer_step_prologue
        e_l, en_next, xl_p, xl_c = prologue(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                                            wlp, blp, wlc, blc, graph, eps, raw)
        out_p, out_c, resid = dual_attend_residuals(xl_p, xl_c, xr_p, xr_c, att_p, att_c,
                                                    graph, heads, slope, plain)
        ctx.save_for_backward(en, skip2, w, e_l, ln_scale, ln_bias, wlp, blp, wlc, blc,
                              xr_p, xr_c, att_p, att_c, out_p, out_c, *resid)
        ctx.plain, ctx.graph, ctx.heads, ctx.eps, ctx.raw, ctx.slope = (
            plain, graph, heads, eps, raw, slope)
        ctx.group = edge_group()
        ctx.shard = None if ctx.group is None else table_shard()
        ctx.has_res, ctx.pg_shape = res is not None, pg.shape
        ctx.att_shapes = (att_p.shape, att_c.shape)
        return (e_l, out_p, out_c) if raw else (e_l, en_next, out_p, out_c)

    @staticmethod
    def backward(ctx, *grads):
        (en, skip2, w, e_l, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c,
         out_p, out_c, m_p, den_p, m_c, den_c) = ctx.saved_tensors
        if ctx.raw:
            de_l, g_p, g_c = grads
            den_next = None
        else:
            de_l, den_next, g_p, g_c = grads
        plain, graph, eps, raw = ctx.plain, ctx.graph, ctx.eps, ctx.raw
        if plain:
            _, xl_p, xl_c = frontend_prologue_plain(e_l, ln_scale, ln_bias, wlp, blp, wlc, blc,
                                                    eps, raw)
        else:
            _, xl_p, xl_c = frontend_prologue(e_l, ln_scale, ln_bias, wlp, blp, wlc, blc, eps,
                                              raw, want_en=False)
        g_p, g_c = exchange_dual_cotangents(g_p, g_c, ctx.group, ctx.shard)
        # The backward clamps exp(l - m) at 1. The rows recomputed from the
        # stored stream may pass the forward's per-segment max m: shift by
        # m + 1 with the denominators scaled by e^-1 (the same softmax), as
        # the JAX kernel's shift, a window's or the whole camera table's max,
        # is not passed.
        m_p, m_c = m_p + SHIFT_MARGIN, m_c + SHIFT_MARGIN
        den_p, den_c = den_p * SHIFT_SCALE, den_c * SHIFT_SCALE
        dual_bwd = dual_attend_bwd_plain if plain else fused_dual_attend_bwd
        dxl_p, dxl_c, dxr_p, dxr_c, datt_p, datt_c = dual_bwd(
            xl_p, xl_c, xr_p, xr_c, att_p, att_c, out_p, out_c, m_p, den_p, m_c, den_c,
            g_p, g_c, graph, ctx.heads, ctx.slope)
        step_bwd = layer_step_bwd_plain if plain else fused_layer_step_bwd
        (den, dskip2, dres, dw, db, dps, dpv, dln_scale, dln_bias, dwlp, dblp, dwlc,
         dblc) = step_bwd(en, skip2, w, e_l, ln_scale, ln_bias, wlp, wlc, graph, dxl_p, dxl_c,
                          den_next, de_l, eps, raw, ctx.has_res)
        return (None,) * 6 + (
            den, dskip2, dres if ctx.has_res else None, dw, db, dps, dpv,
            db.reshape(ctx.pg_shape), dln_scale, dln_bias, dwlp, dblp, dwlc, dblc, dxr_p,
            dxr_c, datt_p.reshape(ctx.att_shapes[0]), datt_c.reshape(ctx.att_shapes[1]))


def stored_step(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias, wlp, blp, wlc, blc,
                xr_p, xr_c, att_p, att_c, graph, heads, eps, raw_prologue, slope, plain):
    """:class:`_StoredStep` (bf16 streams). Returns (e_l, e_norm_next,
    out_pt, out_cam); under ``raw_prologue`` e_norm_next is e_l."""
    outs = _StoredStep.apply(plain, graph, heads, eps, raw_prologue, slope, en, skip2, res, w,
                             b, ps, pv, pg, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c,
                             att_p, att_c)
    return (outs[0], *outs) if raw_prologue else outs


def fused_layer_step_plain(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                           wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c, graph, heads,
                           eps=LN_EPS, raw_prologue=False, slope=NEGATIVE_SLOPE):
    """Plain version: the prologue, then the dual core (with bf16 streams
    :class:`_StoredStep` of the plain versions)."""
    if en.dtype == torch.bfloat16:
        return stored_step(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias, wlp, blp, wlc,
                           blc, xr_p, xr_c, att_p, att_c, graph, heads, eps, raw_prologue,
                           slope, plain=True)
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
    e_l = torch.empty((E, De), dtype=sd, device=dev)
    en_next = e_l if raw_prologue else torch.empty_like(e_l)
    xl_p, xl_c = kb.f32_empty((E, Dp), dev), kb.f32_empty((E, Dc), dev)
    p = kb.ptr
    ln_s, ln_b, en_out = (None, None, None) if raw_prologue else (ln_scale, ln_bias, en_next)
    code = _entry()(
        p(en), d_in, p(skip2), d2, p(res), p(w), p(b), p(pg), p(ps), p(pv),
        p(pt_idx), p(cam_idx), E, De, p(ln_s), p(ln_b), int(raw_prologue), float(eps),
        p(wlp), p(blp), Dp, p(wlc), p(blc), Dc, p(e_l), p(en_out), p(xl_p), p(xl_c),
        kb.is_bf16(sd), kb.grid_for(dev, -(-E // TILE_ROWS), 1, per_sm=FWD_BLOCKS_PER_SM),
        kb.stream(dev),
    )
    kb.check(code, "fused_layer_step")
    fused_layer_step.launches += 1
    fused_layer_step.bf16_launches += kb.is_bf16(sd)
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
                                      dxl_p, dxl_c, den_next, de_l, ctx.eps, ctx.raw,
                                      ctx.has_res)
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
    prologue_grad = kb.needs_grad(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias, wlp,
                                  blp, wlc, blc)
    if en.dtype == torch.bfloat16 and (prologue_grad or kb.needs_grad(xr_p, xr_c, att_p, att_c)):
        return stored_step(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias, wlp, blp, wlc,
                           blc, xr_p, xr_c, att_p, att_c, graph, heads, eps, raw_prologue,
                           slope, plain=False)
    if prologue_grad:
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
fused_layer_step.bf16_launches = 0  # of them, launches on bf16 streams


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
                         raw_prologue=False, want_res=True):
    """The layer step prologue's backward kernel (CUDA tensors): the update's
    inputs en (E, d_in), skip2 (E, d2) or None and weight w (De, d_in + d2),
    the saved e_l (E, De; the kernel recomputes the LayerNorm's output from
    it), the next layer's LayerNorm and source-linear weights, the cotangents
    of xl_p / xl_c (from the dual core's backward), of e_norm_next (or None)
    and of e_l (or None). Returns (den, dskip2, dres, dw, db, dps, dpv,
    dln_scale, dln_bias, dwlp, dblp, dwlc, dblc): dres is the total
    cotangent of e_l, and d pg equals db. The streams (en, skip2, e_l and
    the cotangents of e_norm_next and e_l) are all float32 or all bf16; with
    bf16 den, dskip2 and dres are bf16, rounded from the float32 sums, and
    dres is written only with ``want_res`` (else None), while the tables'
    sums take the total cotangent in float32. Its plain version is autograd
    through :func:`fused_layer_step_plain`."""
    E, d_in = en.shape
    n, m = graph.num_pts, graph.num_cams
    De = w.shape[0]
    d2 = 0 if skip2 is None else skip2.shape[1]
    K = d_in + d2
    Dp, Dc = wlp.shape[0], wlc.shape[0]
    if max(d_in, d2, De, Dp, Dc) > 32 or E != graph.num_edges:
        raise ValueError("fused_layer_step_bwd: every width must be <= 32")
    sd = kb.stream_dtype(en, skip2, e_l, den_next, de_l)
    al = kb.aligned
    en = al(kb.cuda_stream("en", en, sd, (E, d_in)))
    if skip2 is not None:
        skip2 = al(kb.cuda_stream("skip2", skip2, sd, (E, d2)))
    w = kb.cuda_f32("w", w, (De, K))
    e_l = al(kb.cuda_stream("e_l", e_l, sd, (E, De)))
    if not raw_prologue:
        ln_scale = kb.cuda_f32("ln_scale", ln_scale, (De,))
        ln_bias = kb.cuda_f32("ln_bias", ln_bias, (De,))
    wlp = kb.cuda_f32("wlp", wlp, (Dp, De))
    wlc = kb.cuda_f32("wlc", wlc, (Dc, De))
    dxl_p = al(kb.cuda_f32("dxl_p", dxl_p, (E, Dp)))
    dxl_c = al(kb.cuda_f32("dxl_c", dxl_c, (E, Dc)))
    if den_next is not None:
        den_next = al(kb.cuda_stream("den_next", den_next, sd, (E, De)))
    if de_l is not None:
        de_l = al(kb.cuda_stream("de_l", de_l, sd, (E, De)))
    dev = en.device
    grid = kb.grid_for(dev, -(-E // TILE_ROWS), 1, per_sm=TILE_BLOCKS_PER_SM)
    row = step_sums_len(De, K, Dp, Dc)
    bf16 = kb.is_bf16(sd)
    d_el = kb.f32_empty((E, De), dev)
    dres = torch.empty((E, De), dtype=sd, device=dev) if bf16 and want_res else None
    den = torch.empty((E, d_in), dtype=sd, device=dev)
    dskip2 = None if skip2 is None else torch.empty((E, d2), dtype=sd, device=dev)
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
        p(d_el), p(den), p(dskip2), p(dps), p(dpv), p(partials), p(sums), p(dres), bf16, grid,
        kb.stream(dev),
    )
    kb.check(code, "fused_layer_step_bwd")
    fused_layer_step_bwd.launches += 1
    fused_layer_step_bwd.bf16_launches += bf16
    dwlp, dblp, dwlc, dblc, dw, db, dg, dbn = split_step_sums(sums, De, K, Dp, Dc)
    if raw_prologue:
        dg = dbn = None
    if not bf16:
        dres = d_el
    return den, dskip2, dres, dw, db, dps, dpv, dg, dbn, dwlp, dblp, dwlc, dblc


fused_layer_step_bwd.launches = 0
fused_layer_step_bwd.bf16_launches = 0
