"""Counts of a GASFM training step (see :mod:`benchmark.counts`).

The port takes one of two paths per scene: the merged one (an edge stream
32 wide, LayerNorm on the stream, no update MLP, at most 1024 cameras),
where per layer the layer-step kernel materializes the previous layer's
edge update, normalizes the stream and makes both source rows, and the
dual core aggregates them into points and cameras; and the unfused one,
where the points' aggregation is the attention kernel, the cameras' a
composite of gathers, a segment max and a segment sum, and the edge update
the edge-combine kernel.
"""

from __future__ import annotations

from benchmark.counts import (agg_width, attend, attend_bwd, dual_attend, dual_attend_bwd,
                              edge_combine, edge_combine_bwd, esfm_terms, frontend, frontend_bwd,
                              gather_rows, layer_step, layer_step_bwd, lin, repro_gathers,
                              segment_sum)

MERGED_MAX_CAMERAS = 1024
SKIP = 2  # the init skip's width: the embedding of the 2D observation


def _widths(c: dict):
    return (c["num_layers"], c["n_heads"], c["n_feat_proj"], c["n_feat_scenepoint"],
            c["n_feat_view"], c["n_feat_global"])


def merged(c: dict, shape: dict) -> bool:
    return (c["n_feat_proj"] == 32 and c.get("use_norm_proj_update", True)
            and c.get("n_hidden_layers_proj_update", 0) == 0 and shape["m"] <= MERGED_MAX_CAMERAS)


def model_flops(c: dict, shape: dict) -> float:
    E, n, m = shape["E"], shape["n"], shape["m"]
    L, H, D, S, V, G = _widths(c)
    hv = c.get("n_hidden_layers_view_update", 0)
    hs = c.get("n_hidden_layers_scenepoint_update", 0)
    hg = c.get("n_hidden_layers_global_update", 0)

    def aggregate(d_in, stateful):
        ap, ac = agg_width(d_in, H), agg_width(d_in, H)
        f = lin(E, d_in, ap) + lin(E, d_in, ac)
        if stateful:
            f += (lin(n, S, d_in) if S != d_in else 0) + lin(n, d_in, ap)
            f += (lin(m, V, d_in) if V != d_in else 0) + lin(m, d_in, ac)
        f += (lin(n, ap, S) if ap != S else 0) + (lin(m, ac, V) if ac != V else 0)
        return f + (1 + hs) * lin(n, S, S) + (1 + hv) * lin(m, V, V)

    first = lin(E, 2, 2)  # the embedding: its input needs no gradient
    fwd = 0.0
    for i in range(L):
        d_in, stateful = (2, False) if i == 0 else (D, True)
        fwd += aggregate(d_in, stateful)
        s2g, v2g = agg_width(S, H), agg_width(V, H)
        fwd += lin(m, V, v2g) + lin(n, S, s2g)
        if stateful:
            fwd += (lin(1, G, V) if G != V else 0) + lin(1, V, v2g)
            fwd += (lin(1, G, S) if G != S else 0) + lin(1, S, s2g)
        fwd += (lin(1, v2g + s2g, G) if v2g + s2g != G else 0) + (1 + hg) * lin(1, G, G)
        fwd += lin(E, d_in + (0 if i == 0 else SKIP), D) + lin(n, S, D) + lin(m, V, D)
        fwd += lin(1, G, D) + (lin(E, d_in, D) if d_in != D else 0)
    fwd += aggregate(D, True)
    fwd += c["view_head"]["n_hidden_layers"] * lin(m, V, V) + lin(m, V, 7)
    fwd += c["scenepoint_head"]["n_hidden_layers"] * lin(n, S, S) + lin(n, S, 3)
    return 3.0 * fwd + 2.0 * first


def _merged_launches(c: dict, shape: dict) -> list:
    """The frontend and dual core of the first layer, then per layer one
    layer step (the update fused with the next layer's prologue, the last
    one into the final aggregation's raw prologue) and its dual core; the
    loss; our_repro's gathers; the backward in reverse."""
    L, H, D, _, _, _ = _widths(c)
    a0 = agg_width(SKIP, H)
    fwd = frontend(shape, SKIP, a0, a0) + dual_attend(shape, a0, a0, H)
    bwd = dual_attend_bwd(shape, a0, a0, H) + frontend_bwd(shape, SKIP, a0, a0)
    for i in range(1, L + 1):
        d_in, d2, raw = (SKIP, 0, False) if i == 1 else (D, SKIP, i == L)
        fwd += layer_step(shape, d_in, d2, D, D, D, raw) + dual_attend(shape, D, D, H)
        bwd = (dual_attend_bwd(shape, D, D, H)
               + layer_step_bwd(shape, d_in, d2, D, D, D, raw, de_l=i < L) + bwd)
    return fwd + esfm_terms(shape)[:1] + repro_gathers(shape) + esfm_terms(shape)[1:] + bwd


def _unfused_launches(c: dict, shape: dict) -> list:
    """Per layer and in the final aggregation: the points by the attention
    kernel, the cameras by the composite (the queries gathered to the
    edges, the logits' segment max, the max gathered back, one segment sum
    of the weighted rows and weights), the update by the edge combine; the
    backward of each."""
    E, m = shape["E"], shape["m"]
    L, H, D, _, _, _ = _widths(c)
    fwd, bwd = [], []
    for i in range(L + 1):
        a = agg_width(SKIP if i == 0 else D, H)
        fwd += attend(shape, a, H, "point")
        fwd += [gather_rows(m, a, E)] + segment_sum(E, H, m, shape["cam_deg"], True)  # the max
        fwd += [gather_rows(m, H, E)] + segment_sum(E, a + H, m, shape["cam_deg"], True)
        layer_bwd = attend_bwd(shape, a, H, "point")
        layer_bwd += [gather_rows(m, a + H, E)] + segment_sum(E, a, m, shape["cam_deg"], True)
        if i < L:
            fwd += edge_combine(shape, D)
            layer_bwd = edge_combine_bwd(shape, D) + layer_bwd
        bwd = layer_bwd + bwd
    return fwd + esfm_terms(shape)[:1] + repro_gathers(shape) + esfm_terms(shape)[1:] + bwd


def kernel_launches(c: dict, shape: dict) -> list:
    return _merged_launches(c, shape) if merged(c, shape) else _unfused_launches(c, shape)
