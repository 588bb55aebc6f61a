"""Dual GATv2 segment attention and the layer frontend: CUDA kernels for
Hopper (``csrc/fused_dual_attn.cu``), their plain PyTorch versions, and
their launch counters.

Replaces the TPU kernels of ``gasfm_tpu/ops/pallas/fused_dual_attn.py``:

- ``fused_dual_attend``: ``fused_dual_attend`` / ``_dual_fwd_raw`` — both
  per-layer aggregations (edges -> points, edges -> cameras) in one launch.
- ``fused_frontend``: ``fused_frontend`` / ``_front_fwd_raw`` — LayerNorm +
  ReLU (skipped under ``raw_prologue``) and the two GATv2 source linears per
  edge, then the dual core. Two launches: the per-edge prologue (counted
  here) and the dual core (counted by ``fused_dual_attend``).

What bounds them on the H100 is bytes over its 3.35 TB/s, not operations:
per edge and feature the work is a few flops. The kernels read each edge
row once, keep the online softmax in registers, and walk each segment's
own edge list (point CSR; camera CSR through ``cam_perm``) instead of the
TPU kernel's one-hot matmuls. See the CUDA source for the launch layout.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper's ``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from gasfm_tpu_torch.ops.gatv2 import NEGATIVE_SLOPE, gatv2_attend, layer_norm_relu
from gasfm_tpu_torch.ops.kernels import build as kb

LN_EPS = 1e-5

_DUAL_ARGS = (kb.P,) * 9 + (kb.I,) * 6 + (kb.F,) + (kb.P,) * 3
_FRONT_ARGS = (kb.P, kb.I, kb.I, kb.P, kb.P, kb.I, kb.F, kb.P, kb.P, kb.I, kb.P, kb.P,
               kb.I, kb.P, kb.P, kb.P, kb.I, kb.P)


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    args = _DUAL_ARGS if symbol == "gasfm_dual_attend" else _FRONT_ARGS
    return kb.bind(kb.load("fused_dual_attn"), symbol, args)


def head_width(D: int, heads: int) -> int:
    """Features per head C = D / heads; the kernels take D <= 32 and C a
    power of two (one lane per feature, per-head sums by lane shuffles)."""
    C = D // heads
    if D > 32 or C * heads != D or C & (C - 1):
        raise ValueError(f"width {D} with {heads} heads: need D <= 32 and D/heads a power of two")
    return C


# ---------------------------------------------------------------------------
# dual core (#1)
# ---------------------------------------------------------------------------


def fused_dual_attend_plain(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads,
                            slope=NEGATIVE_SLOPE):
    """Plain version: two single-direction segment attentions."""
    out_p = gatv2_attend(xl_p, xr_p, att_p, graph.pt_idx, graph.num_pts, heads, slope)
    out_c = gatv2_attend(xl_c, xr_c, att_c, graph.cam_idx, graph.num_cams, heads, slope)
    return out_p, out_c


def fused_dual_attend(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads,
                      slope=NEGATIVE_SLOPE):
    """Both aggregations of a layer. xl_p (E, Dp) / xl_c (E, Dc): source
    rows; xr_p (n, Dp) / xr_c (m, Dc): per-segment queries; att_p (Dp,) /
    att_c (Dc,). Returns (out_pt (n, Dp), out_cam (m, Dc))."""
    if xl_p.device.type == "cpu":
        return fused_dual_attend_plain(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    Dp, Dc = xl_p.shape[1], xl_c.shape[1]
    Cp, Cc = head_width(Dp, heads), head_width(Dc, heads)
    xl_p = kb.cuda_f32("xl_p", xl_p, (E, Dp))
    xl_c = kb.cuda_f32("xl_c", xl_c, (E, Dc))
    xr_p = kb.cuda_f32("xr_p", xr_p, (n, Dp))
    xr_c = kb.cuda_f32("xr_c", xr_c, (m, Dc))
    att_p = kb.cuda_f32("att_p", att_p.reshape(-1), (Dp,))
    att_c = kb.cuda_f32("att_c", att_c.reshape(-1), (Dc,))
    pt_ptr = kb.cuda_i32("pt_ptr", graph.pt_ptr)
    cam_ptr = kb.cuda_i32("cam_ptr", graph.cam_ptr)
    cam_perm = kb.cuda_i32("cam_perm", graph.cam_perm)
    out_p = torch.empty((n, Dp), dtype=torch.float32, device=xl_p.device)
    out_c = torch.empty((m, Dc), dtype=torch.float32, device=xl_p.device)
    p = kb.ptr
    code = _entry("gasfm_dual_attend")(
        p(xl_p), p(xl_c), p(xr_p), p(xr_c), p(att_p), p(att_c), p(pt_ptr), p(cam_ptr),
        p(cam_perm), n, m, Dp, Cp, Dc, Cc, float(slope), p(out_p), p(out_c),
        kb.stream(xl_p.device),
    )
    kb.check(code, "fused_dual_attend")
    fused_dual_attend.launches += 1
    return out_p, out_c


fused_dual_attend.launches = 0


# ---------------------------------------------------------------------------
# layer frontend (#3)
# ---------------------------------------------------------------------------


def fused_frontend_plain(e, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c,
                         att_p, att_c, graph, heads, eps=LN_EPS,
                         raw_prologue=False, slope=NEGATIVE_SLOPE):
    """Plain version: LN + ReLU, the two source linears, the dual core."""
    en = e if raw_prologue else layer_norm_relu(e, ln_scale, ln_bias, eps)
    xl_p = F.linear(en, wlp, blp)
    xl_c = F.linear(en, wlc, blc)
    out_p, out_c = fused_dual_attend_plain(xl_p, xl_c, xr_p, xr_c, att_p, att_c,
                                           graph, heads, slope)
    return en, out_p, out_c


def fused_frontend(e, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c,
                   att_p, att_c, graph, heads, eps=LN_EPS, raw_prologue=False,
                   slope=NEGATIVE_SLOPE):
    """e (E, De) raw edge features; ln_scale/ln_bias (De,) (ignored under
    ``raw_prologue``); wlp (Dp, De), blp (Dp,), wlc (Dc, De), blc (Dc,) the
    source linears in torch layout; the rest as in :func:`fused_dual_attend`.
    Returns (e_norm = relu(LN(e)) or e under raw, out_pt, out_cam)."""
    if e.device.type == "cpu":
        return fused_frontend_plain(e, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c,
                                    att_p, att_c, graph, heads, eps, raw_prologue, slope)
    E, De = e.shape
    Dp, Dc = wlp.shape[0], wlc.shape[0]
    if De > 32 or Dp > 32 or Dc > 32 or E != graph.num_edges:
        raise ValueError(f"fused_frontend: widths De={De}, Dp={Dp}, Dc={Dc} must be <= 32")
    e = kb.cuda_f32("e", e, (E, De))
    if not raw_prologue:
        ln_scale = kb.cuda_f32("ln_scale", ln_scale, (De,))
        ln_bias = kb.cuda_f32("ln_bias", ln_bias, (De,))
    wlp = kb.cuda_f32("wlp", wlp, (Dp, De))
    blp = kb.cuda_f32("blp", blp, (Dp,))
    wlc = kb.cuda_f32("wlc", wlc, (Dc, De))
    blc = kb.cuda_f32("blc", blc, (Dc,))
    dev = e.device
    en = e if raw_prologue else torch.empty_like(e)
    xl_p = torch.empty((E, Dp), dtype=torch.float32, device=dev)
    xl_c = torch.empty((E, Dc), dtype=torch.float32, device=dev)
    p = kb.ptr
    code = _entry("gasfm_frontend_prologue")(
        p(e), E, De, p(None if raw_prologue else ln_scale), p(None if raw_prologue else ln_bias),
        int(raw_prologue), float(eps), p(wlp), p(blp), Dp, p(wlc), p(blc), Dc,
        p(None if raw_prologue else en), p(xl_p), p(xl_c),
        kb.grid_for(dev, E, 8), kb.stream(dev),
    )
    kb.check(code, "fused_frontend")
    fused_frontend.launches += 1
    out_p, out_c = fused_dual_attend(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, slope)
    return en, out_p, out_c


fused_frontend.launches = 0
