"""Counts of a DPESFM training step (see :mod:`benchmark.counts`).

Per set-of-sets layer the port sums the edge stream per point and per
camera (segment sums) and combines the edge linear with the means' rows
(edge combine); the backward gathers the means' cotangents back to the
edges, where the layer's input needs a gradient.
"""

from __future__ import annotations

from benchmark.counts import (edge_combine, edge_combine_bwd, esfm_terms, gather_rows, lin,
                              repro_gathers, segment_sum)


def model_flops(c: dict, shape: dict) -> float:
    E, n, m = shape["E"], shape["n"], shape["m"]
    F = c["num_features"]
    total = 0.0
    d_in = 2
    for b in range(c["num_blocks"]):
        for j in range(c["block_size"]):
            f = lin(E, d_in, F) + lin(n, d_in, F) + lin(m, d_in, F) + lin(1, d_in, F)
            total += (2.0 if (b, j) == (0, 0) else 3.0) * f  # the input needs no gradient
            d_in = F
    heads = (lin(n, F, F) + lin(m, F, F)
             + c["view_head"]["n_hidden_layers"] * lin(m, F, F) + lin(m, F, 7)
             + c["scenepoint_head"]["n_hidden_layers"] * lin(n, F, F) + lin(n, F, 3))
    return total + 3.0 * heads


def kernel_launches(c: dict, shape: dict) -> list:
    """Per layer the point and camera sums of its input (the means) and the
    edge combine; the final update's two sums; the loss; our_repro's
    gathers. The backward: each edge combine's, and the gathers of the
    means' cotangents wherever the input needs a gradient (all but the
    first layer's, the raw observations)."""
    E, n, m = shape["E"], shape["n"], shape["m"]
    F = c["num_features"]
    layers = c["num_blocks"] * c["block_size"]
    fwd, bwd = [], []
    for i in range(layers + 1):  # the layers, then the final update
        d_in = 2 if i == 0 else F
        fwd += (segment_sum(E, d_in, n, shape["pt_deg"], False)
                + segment_sum(E, d_in, m, shape["cam_deg"], True))
        if i:
            bwd += [gather_rows(n, d_in, E), gather_rows(m, d_in, E)]
        if i < layers:
            fwd += edge_combine(shape, F)
            bwd += edge_combine_bwd(shape, F)
    return fwd + esfm_terms(shape)[:1] + repro_gathers(shape) + esfm_terms(shape)[1:] + bwd
