"""The set-of-sets edge combine: CUDA kernels for Hopper
(``csrc/fused_update.cu``), forward and backward, their plain PyTorch
version, and their launch counters.

Replaces the TPU kernels of ``gasfm_tpu/ops/pallas/fused_update.py``
(``fused_edge_combine`` / ``_fwd_raw``; backward ``_bwd_raw``):

    out = (pe + ps[pt] + pv[cam] + pg) / 4

with pe (E, D), ps (n, D), pv (m, D) and pg (1, D), D from 1 to 256. The
backward gives d pe = g / 4, d ps and d pv the point and camera CSR sums of
g / 4, and d pg its column sum: the point side is the segment sum's split
walk with its COMBINE flag (``csrc/segment.cuh``: it also writes d pe and
one partial row of column sums per block), the camera side the segment sum
itself, then the column sum of the partial rows (three launches inside one
call, one more for each side with a hub, counted once by
``fused_edge_combine_bwd``).

What bounds them on the H100 is bytes over its 3.35 TB/s: the forward
reads pe and writes out, ~0.1 flop per byte (see the source for the
design). No float atomics; results are bitwise reproducible on a given
card, and the forward's adds follow the plain version's order.

A CPU tensor runs the plain version (the JAX package's composite line,
``ops/edge_update.py:53-58``; autograd through it is the backward's plain
version); a CUDA tensor launches the kernel or raises.

Under an edge mesh it needs no collective (the JAX package's
``ops/edge_update.py:11``): each edge reads whole tables, and the backward's
table gradients are the rank's partials, which the interior sums upstream
(their backward) or the final sum of the gradients complete.
"""

from __future__ import annotations

import functools

import torch

from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.kernels.segment_kernels import MAX_WIDTH, sum_split
from gasfm_tpu_torch.ops.segment import gather_segments



@functools.lru_cache(maxsize=None)
def _entry(symbol):
    args = {"gasfm_edge_combine": (kb.P,) * 6 + (kb.I, kb.I, kb.P, kb.P),
            # g, D, E, pt_ptr, n_pts, the point split, cam_ptr, cam_perm, the camera
            # split, n_cams, dpe, dps, dpv, dpg, partials, pt_part, cam_part, stream
            "gasfm_edge_combine_bwd": (kb.P, kb.I, kb.I, kb.P, kb.I, kb.P, kb.I, kb.I, kb.P,
                                       kb.P, kb.P, kb.I, kb.I, kb.I) + (kb.P,) * 8}[symbol]
    return kb.bind(kb.load("fused_update"), symbol, args)


def fused_edge_combine_plain(pe, ps, pv, pg, graph):
    """Plain version: the composite gather path."""
    return (pe + gather_segments(ps, graph.pt_idx) + gather_segments(pv, graph.cam_idx)
            + pg) / 4.0


def edge_combine_forward(pe, ps, pv, pg, graph):
    """Launch the forward kernel (CUDA tensors)."""
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    D = pe.shape[-1]
    if not 1 <= D <= MAX_WIDTH:
        raise ValueError(f"fused_edge_combine: width {D} not in [1, {MAX_WIDTH}]")
    pe = kb.aligned(kb.cuda_f32("pe", pe, (E, D)))
    ps = kb.aligned(kb.cuda_f32("ps", ps, (n, D)))
    pv = kb.aligned(kb.cuda_f32("pv", pv, (m, D)))
    pg = kb.aligned(kb.cuda_f32("pg", pg.reshape(1, D), (1, D)))
    dev = pe.device
    out = kb.f32_empty((E, D), dev)
    p = kb.ptr
    code = _entry("gasfm_edge_combine")(
        p(pe), p(ps), p(pv), p(pg), p(kb.cuda_i32("pt_idx", graph.pt_idx)),
        p(kb.cuda_i32("cam_idx", graph.cam_idx)), E, D, p(out), kb.stream(dev))
    kb.check(code, "fused_edge_combine")
    fused_edge_combine.launches += 1
    return out


class _EdgeCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pe, ps, pv, pg, graph):
        ctx.graph, ctx.pg_shape = graph, pg.shape
        return edge_combine_forward(pe, ps, pv, pg, graph)

    @staticmethod
    def backward(ctx, g):
        dpe, dps, dpv, dpg = fused_edge_combine_bwd(g, ctx.graph)
        return dpe, dps, dpv, dpg.reshape(ctx.pg_shape), None


def fused_edge_combine(pe, ps, pv, pg, graph):
    """(pe + ps[pt] + pv[cam] + pg) / 4 over the graph's edges: (E, D)."""
    if pe.device.type == "cpu":
        return fused_edge_combine_plain(pe, ps, pv, pg, graph)
    if kb.needs_grad(pe, ps, pv, pg):
        return _EdgeCombine.apply(pe, ps, pv, pg, graph)
    return edge_combine_forward(pe, ps, pv, pg, graph)


fused_edge_combine.launches = 0


def fused_edge_combine_bwd(g, graph):
    """The backward kernel (CUDA tensors): from the cotangent g (E, D),
    (d pe (E, D), d ps (n, D), d pv (m, D), d pg (D,)). Its plain version
    is autograd through :func:`fused_edge_combine_plain`."""
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    D = g.shape[-1]
    if not 1 <= D <= MAX_WIDTH:
        raise ValueError(f"fused_edge_combine_bwd: width {D} not in [1, {MAX_WIDTH}]")
    g = kb.aligned(kb.cuda_f32("g", g, (E, D)))
    dev = g.device
    dpe, dps = kb.f32_empty((E, D), dev), kb.f32_empty((n, D), dev)
    dpv, dpg = kb.f32_empty((m, D), dev), kb.f32_empty((D,), dev)
    split_p, n_long_p, n_chunks_p, part_p = sum_split(graph, "point", D, dev)
    split_c, n_long_c, n_chunks_c, part_c = sum_split(graph, "camera", D, dev)
    # one partial row per block of the point pass: its parts, then at most
    # a block per 32 short points
    partials = kb.f32_empty((n_chunks_p + -(-n // 32), D), dev)
    p = kb.ptr
    code = _entry("gasfm_edge_combine_bwd")(
        p(g), D, E, p(kb.cuda_i32("pt_ptr", graph.pt_ptr)), n, p(split_p), n_long_p, n_chunks_p,
        p(kb.cuda_i32("cam_ptr", graph.cam_ptr)), p(kb.cuda_i32("cam_perm", graph.cam_perm)),
        p(split_c), n_long_c, n_chunks_c, m, p(dpe), p(dps), p(dpv), p(dpg), p(partials),
        p(part_p), p(part_c), kb.stream(dev))
    kb.check(code, "fused_edge_combine_bwd")
    fused_edge_combine_bwd.launches += 1
    return dpe, dps, dpv, dpg


fused_edge_combine_bwd.launches = 0
