"""Merged layer step: CUDA kernel for Hopper (``csrc/fused_layer_step.cu``),
its plain PyTorch version, and its launch counter.

Replaces the TPU kernel of ``gasfm_tpu/ops/pallas/fused_layer_step.py``
(``fused_layer_step`` / ``_fwd_raw``): layer l's deferred projection update

    e_l = ([en | skip2] W^T + b + pg + ps[pt] + pv[cam]) / 4  (+ res)

fused with layer l+1's frontend prologue (LayerNorm + ReLU, skipped under
``raw_prologue``, and the two GATv2 source linears), followed by the dual
core. Two launches per call: the per-edge prologue (counted here) and the
dual core (counted by ``fused_dual_attend``).

What bounds it on the H100 is bytes over its 3.35 TB/s: about 0.9 KB of
edge streams per edge against a few thousand flops. The prologue keeps e_l
in registers between the update and the LayerNorm and touches each stream
once; the update and frontend weights sit in shared memory.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. ``fused_layer_step.launches`` counts the prologue launches.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from gasfm_tpu_torch.ops.gatv2 import NEGATIVE_SLOPE
from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.kernels.fused_dual_attn import (
    LN_EPS,
    fused_dual_attend,
    fused_frontend_plain,
)

_ARGS = (
    kb.P, kb.I, kb.P, kb.I,  # en, d_in, skip2, d2
    kb.P, kb.P, kb.P, kb.P, kb.P, kb.P, kb.P, kb.P,  # res, w, b, pg, ps, pv, pt_idx, cam_idx
    kb.I, kb.I, kb.P, kb.P, kb.I, kb.F,  # E, De, lng, lnb, raw, eps
    kb.P, kb.P, kb.I, kb.P, kb.P, kb.I,  # wlp, blp, Dp, wlc, blc, Dc
    kb.P, kb.P, kb.P, kb.P, kb.I, kb.P,  # e_l, en_next, xl_p, xl_c, grid, stream
)


@functools.lru_cache(maxsize=None)
def _entry():
    return kb.bind(kb.load("fused_layer_step"), "gasfm_layer_step_prologue", _ARGS)


def projection_update_plain(en, skip2, res, w, b, ps, pv, pg, graph):
    """e_l of the deferred projection update, in plain PyTorch."""
    x = en if skip2 is None else torch.cat([en, skip2], dim=1)
    gathered = ps[graph.pt_idx.long()] + pv[graph.cam_idx.long()]
    e_l = (F.linear(x, w) + (b + pg.reshape(-1)) + gathered) * 0.25
    return e_l if res is None else e_l + res


def fused_layer_step_plain(en, skip2, res, w, b, ps, pv, pg, ln_scale, ln_bias,
                           wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c, graph, heads,
                           eps=LN_EPS, raw_prologue=False, slope=NEGATIVE_SLOPE):
    """Plain version: the update, then the frontend on e_l."""
    e_l = projection_update_plain(en, skip2, res, w, b, ps, pv, pg, graph)
    en_next, out_p, out_c = fused_frontend_plain(
        e_l, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c,
        graph, heads, eps, raw_prologue, slope)
    return e_l, en_next, out_p, out_c


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
    E, d_in = en.shape
    n, m = graph.num_pts, graph.num_cams
    De = w.shape[0]
    d2 = 0 if skip2 is None else skip2.shape[1]
    Dp, Dc = wlp.shape[0], wlc.shape[0]
    if max(d_in, d2, De, Dp, Dc) > 32 or E != graph.num_edges:
        raise ValueError("fused_layer_step: every width must be <= 32")
    en = kb.cuda_f32("en", en, (E, d_in))
    if skip2 is not None:
        skip2 = kb.cuda_f32("skip2", skip2, (E, d2))
    if res is not None:
        res = kb.cuda_f32("res", res, (E, De))
    w = kb.cuda_f32("w", w, (De, d_in + d2))
    b = kb.cuda_f32("b", b, (De,))
    pg = kb.cuda_f32("pg", pg.reshape(-1), (De,))
    ps = kb.cuda_f32("ps", ps, (n, De))
    pv = kb.cuda_f32("pv", pv, (m, De))
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
    e_l = torch.empty((E, De), dtype=torch.float32, device=dev)
    en_next = e_l if raw_prologue else torch.empty_like(e_l)
    xl_p = torch.empty((E, Dp), dtype=torch.float32, device=dev)
    xl_c = torch.empty((E, Dc), dtype=torch.float32, device=dev)
    p = kb.ptr
    ln_s, ln_b, en_out = (None, None, None) if raw_prologue else (ln_scale, ln_bias, en_next)
    code = _entry()(
        p(en), d_in, p(skip2), d2, p(res), p(w), p(b), p(pg), p(ps), p(pv),
        p(pt_idx), p(cam_idx), E, De, p(ln_s), p(ln_b), int(raw_prologue), float(eps),
        p(wlp), p(blp), Dp, p(wlc), p(blc), Dc, p(e_l), p(en_out), p(xl_p), p(xl_c),
        kb.grid_for(dev, E, 8), kb.stream(dev),
    )
    kb.check(code, "fused_layer_step")
    fused_layer_step.launches += 1
    out_p, out_c = fused_dual_attend(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope)
    return e_l, en_next, out_p, out_c


fused_layer_step.launches = 0
