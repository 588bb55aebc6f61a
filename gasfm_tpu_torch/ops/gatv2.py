"""GATv2-style segment attention over the port's view graph.

Counterpart of the JAX package's ops/gatv2.py. Semantics match PyG
``GATv2Conv(add_self_loops=False, share_weights=False, concat=True)`` on the
star graphs of the reference: all source edges of a segment attend into one
aggregation node. Per head,

    score_e = att_h . LeakyReLU(xl_e + xr_seg(e), 0.2)
    out_s   = sum_e softmax_seg(score)_e * xl_e        (0 for empty segments)

Features are flat and head-major: ``xl`` (E, H*C), ``xr`` (S, H*C), ``att``
(H*C,). Linear weights keep torch's (out, in) layout.

``gatv2_attend_pool`` and ``gatv2_attend`` are plain PyTorch (the JAX
package leaves the pools to XLA as well). ``gatv2_attend_dual``,
``gatv2_layer_frontend`` and ``merged_layer_frontend`` dispatch to the
kernel wrappers of ``ops/kernels``, which launch the CUDA kernels for CUDA
tensors and run their plain versions for CPU tensors; ``plain=True`` asks
for the plain versions explicitly (the on-card comparison does).
"""

from __future__ import annotations

import torch

from gasfm_tpu_torch.ops.segment import gather_segments, segment_max, segment_sum

NEGATIVE_SLOPE = 0.2


def layer_norm_relu(e: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """flax-form LayerNorm (``var = E[x^2] - mean^2``) + ReLU over the last
    axis — the JAX package's ``_layer_norm_relu``."""
    mean = e.mean(-1, keepdim=True)
    var = (e * e).mean(-1, keepdim=True) - mean * mean
    return torch.relu((e - mean) * torch.rsqrt(var + eps) * scale + bias)


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
    g = torch.nn.functional.leaky_relu(xl + xr0.reshape(1, D), negative_slope)
    logits = (g * att).reshape(E, heads, C).sum(-1)  # (E, H)
    logits = logits.masked_fill(~row_mask[:, None], float("-inf"))
    m = logits.max(0).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m).masked_fill(~row_mask[:, None], 0.0)
    den = p.sum(0)  # (H,)
    num = torch.einsum("eh,ehc->hc", p, xl.reshape(E, heads, C))
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (num / den[:, None]).reshape(1, D)


def gatv2_attend(
    xl: torch.Tensor,  # (E, H*C)
    xr: torch.Tensor,  # (S, H*C)
    att: torch.Tensor,  # (H*C,)
    seg_ids: torch.Tensor,  # (E,)
    num_segments: int,
    heads: int,
    negative_slope: float = NEGATIVE_SLOPE,
) -> torch.Tensor:
    """(S, H*C) attention-aggregated source rows per segment, as the JAX
    package's composite path computes it: shifted exponentials, one sum for
    the numerators and one for the denominators, then ``num / den``."""
    E, D = xl.shape
    C = D // heads
    g = torch.nn.functional.leaky_relu(xl + gather_segments(xr, seg_ids), negative_slope)
    logits = (g * att).reshape(E, heads, C).sum(-1)  # (E, H)
    m = segment_max(logits, seg_ids, num_segments)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - gather_segments(m, seg_ids))  # (E, H)
    num = segment_sum((p[:, :, None] * xl.reshape(E, heads, C)).reshape(E, D), seg_ids, num_segments)
    den = segment_sum(p, seg_ids, num_segments)  # (S, H)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (num.reshape(num_segments, heads, C) / den[:, :, None]).reshape(num_segments, D)


def gatv2_attend_dual(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads, plain=False):
    """Both per-layer aggregations (edges -> points, edges -> cameras) in
    one pass: the dual-attend kernel (``ops/kernels/fused_dual_attn.py``)."""
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as k

    fn = k.fused_dual_attend_plain if plain else k.fused_dual_attend
    return fn(xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, heads)


def gatv2_layer_frontend(e, ln_scale, ln_bias, eps, wlp, blp, wlc, blc,
                         xr_p, xr_c, att_p, att_c, graph, heads,
                         raw_prologue=False, plain=False):
    """LN + ReLU (skipped under ``raw_prologue``) + both GATv2 source
    linears + both aggregations: the frontend kernel. Returns
    (e_norm, out_pt (n, Dp), out_cam (m, Dc)); under ``raw_prologue`` e_norm
    is ``e`` itself."""
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as k

    fn = k.fused_frontend_plain if plain else k.fused_frontend
    return fn(e, ln_scale, ln_bias, wlp, blp, wlc, blc, xr_p, xr_c, att_p, att_c,
              graph, heads, eps=eps, raw_prologue=raw_prologue)


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
