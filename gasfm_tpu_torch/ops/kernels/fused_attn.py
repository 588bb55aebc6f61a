"""Single-direction GATv2 segment attention: CUDA kernels for Hopper
(``csrc/fused_attn.cu``), forward and backward, their plain PyTorch
versions, and their launch counters.

Replaces the TPU kernels of ``gasfm_tpu/ops/pallas/fused_attn.py``:
``fused_attend`` is ``fused_attend_h`` / ``_fused_attn_fwd_raw`` — one
direction's segment-softmax aggregation of the source rows ``xl`` (E, D)
with the segments' queries ``xr`` (S, D) and the attention vector ``att``
(D,) — and ``fused_attend_bwd`` its backward ``_fused_attn_bwd_raw`` (d xl,
d xr, d att). The JAX package runs them where the dual kernel does not
apply: on a scene of more than 1024 cameras, its point direction
(``gasfm_tpu/ops/gatv2.py:146-184``). Here a "side" names the segments:
``"point"`` walks the contiguous point runs, and no warp walks more than
``ATTEND_CHUNK`` edges of one point: a point of up to that many edges is
short, and a warp walks four short points at once (8 lanes each); a longer
point is cut into chunks of ``ATTEND_CHUNK`` edges, a warp each, whose
partial results a second launch merges in chunk order (the split is built
once per graph on the host, ``ViewGraph.pt_chunks``); ``"camera"`` walks the
camera CSR, a block per camera (the device code of the dual kernel's camera
direction, ``csrc/attend.cuh``). Both take D = H * C <= 32 with C a power
of two.

What bounds them on the H100 is bytes over its 3.35 TB/s: each edge row is
read once, the online softmax stays in registers.

Gradients: when an input requires grad the wrapper runs through a
``torch.autograd.Function``; the forward then also writes each segment's
per-head softmax max and denominator, which the backward reads (the dual
kernel's scheme). Without grad it launches the forward kernel alone and
writes no residuals. The plain version is the composite ``gatv2_attend``
(``ops/gatv2.py``); the plain version of the backward is autograd through
it.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. ``launches`` counts the kernel launches of each wrapper.

Under an edge mesh (``ops/segment.py`` ``edge_partitioned``; the JAX
package's ``fused_attn.py:542-610``, on replicated tables) the kernel runs on
the rank's edge shard with its residuals written, ``ops/attn_combine.py``
combines the shards' (out, max, den) over the edge group, and the backward
sums the output's cotangent over the group before it takes the combined
residuals. The plain version reaches the group through the segment max and
sums of ``ops/segment.py``. Under table sharding (``ops/segment.py``
``table_sharded``; the JAX package's ``fused_attn.py:579-603``) the point
side takes the boundary exchange of ``ops/attn_combine.py`` instead, and
its backward the boundary add; the kernels are the same.
"""

from __future__ import annotations

import functools

import torch

from gasfm_tpu_torch.ops.attn_combine import (combine_attention_shards, exchange_cotangents,
                                              exchange_points, sum_cotangents)
from gasfm_tpu_torch.ops.gatv2 import NEGATIVE_SLOPE, gatv2_attend
from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.kernels.fused_dual_attn import head_width
from gasfm_tpu_torch.ops.kernels.segment_kernels import side_csr, side_ids
from gasfm_tpu_torch.ops.segment import edge_group, table_shard

# of csrc/fused_attn.cu: kAttendChunk, the most edges of one point a warp
# walks; kQuad, short points per warp; kPointWarps, warps per point-side
# block; kPointBwdBlocksPerSm, the point-side backward's blocks per SM (one
# d att partial row each)
ATTEND_CHUNK = 32
QUAD = 4
POINT_WARPS = 8
POINT_BWD_BLOCKS_PER_SM = 4

_P, _I, _F = kb.P, kb.I, kb.F
_SIGNATURES = {
    "gasfm_attend": (_P,) * 6 + (_I,) * 5 + (_F,) + (_P,) * 5,
    "gasfm_attend_bwd": (_P,) * 10 + (_I,) * 5 + (_F,) + (_P,) * 5 + (_I, _P),
}


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    return kb.bind(kb.load("fused_attn"), symbol, _SIGNATURES[symbol])


def point_split(graph, side):
    """(split table, long points, chunks) of the point side's split at
    ``ATTEND_CHUNK`` edges (``ViewGraph.pt_chunks``, built once per graph);
    (None, 0, 0) on the camera side."""
    if side != "point":
        return None, 0, 0
    split = graph.pt_chunks(ATTEND_CHUNK)
    return kb.cuda_i32("pt_chunks", split.table), split.n_long, split.n_chunks


def fused_attend_plain(xl, xr, att, graph, side, heads, slope=NEGATIVE_SLOPE):
    """Plain version: the composite segment attention over ``side``."""
    ids, S = side_ids(graph, side)
    return gatv2_attend(xl, xr, att, ids, S, heads, slope, side=side)


def attend_forward(xl, xr, att, graph, side, heads, slope=NEGATIVE_SLOPE, residuals=False):
    """Launch the forward kernel (CUDA tensors). Returns (out, res, ins):
    ``res`` is (m, den), each (S, H), each segment's per-head softmax max and
    denominator, when ``residuals``, else None; ``ins`` the validated
    inputs (xl, xr, att)."""
    _, S = side_ids(graph, side)
    E, D = graph.num_edges, xl.shape[1]
    C = head_width(D, heads)
    xl = kb.aligned(kb.cuda_f32("xl", xl, (E, D)))
    xr = kb.aligned(kb.cuda_f32("xr", xr, (S, D)))
    att = kb.aligned(kb.cuda_f32("att", att.reshape(-1), (D,)))
    ptr, perm = side_csr(graph, side)
    split, n_long, n_chunks = point_split(graph, side)
    dev = xl.device
    out = kb.f32_empty((S, D), dev)
    res = (kb.f32_empty((S, heads), dev), kb.f32_empty((S, heads), dev)) if residuals else None
    part = kb.f32_empty((n_chunks, 96), dev) if n_chunks else None
    p = kb.ptr
    code = _entry("gasfm_attend")(
        p(xl), p(xr), p(att), p(ptr), p(perm), p(split), n_long, n_chunks, S, D, C,
        float(slope), p(out), *(p(t) for t in (res or (None, None))), p(part), kb.stream(dev))
    kb.check(code, "fused_attend")
    fused_attend.launches += 1
    fused_attend.residual_launches += residuals
    return out, res, (xl, xr, att)


def attend_combined(xl, xr, att, graph, side, heads, group, slope=NEGATIVE_SLOPE):
    """The forward kernel on this rank's edge shard, combined over the edge
    ``group``: (out, (m, den), ins), the output and residuals the scene's
    (under table sharding the point side's on the points the shard's edges
    touch)."""
    out, res, ins = attend_forward(xl, xr, att, graph, side, heads, slope, residuals=True)
    shard = table_shard() if side == "point" else None
    if shard is None:
        ((out, m, den),) = combine_attention_shards([(out, *res)], group)
    else:
        (out, m, den), _ = exchange_points((out, *res), shard, group, heads)
    return out, (m, den), ins


class _Attend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xl, xr, att, graph, side, heads, slope):
        group = edge_group()
        if group is None:
            out, res, ins = attend_forward(xl, xr, att, graph, side, heads, slope,
                                           residuals=True)
        else:
            out, res, ins = attend_combined(xl, xr, att, graph, side, heads, group, slope)
        ctx.save_for_backward(*ins, out, *res)
        ctx.graph, ctx.side, ctx.heads, ctx.slope, ctx.group = graph, side, heads, slope, group
        ctx.shard = table_shard() if group is not None and side == "point" else None
        ctx.att_shape = att.shape
        return out

    @staticmethod
    def backward(ctx, g):
        xl, xr, att, out, m, den = ctx.saved_tensors
        if ctx.shard is not None:
            g, _ = exchange_cotangents(g, ctx.shard, ctx.group)
        elif ctx.group is not None:
            (g,) = sum_cotangents([g], ctx.group)
        dxl, dxr, datt = fused_attend_bwd(xl, xr, att, out, m, den, g, ctx.graph, ctx.side,
                                          ctx.heads, ctx.slope)
        return dxl, dxr, datt.reshape(ctx.att_shape), None, None, None, None


def fused_attend(xl, xr, att, graph, side, heads, slope=NEGATIVE_SLOPE):
    """(S, D) attention-aggregated rows of ``xl`` (E, D) per segment of
    ``side`` ("point" or "camera"), with queries ``xr`` (S, D), attention
    vector ``att`` (D,) and ``heads`` heads; 0 for an empty segment."""
    if xl.device.type == "cpu":
        return fused_attend_plain(xl, xr, att, graph, side, heads, slope)
    if kb.needs_grad(xl, xr, att):
        return _Attend.apply(xl, xr, att, graph, side, heads, slope)
    group = edge_group()
    if group is not None:
        return attend_combined(xl, xr, att, graph, side, heads, group, slope)[0]
    return attend_forward(xl, xr, att, graph, side, heads, slope)[0]


fused_attend.launches = 0
fused_attend.residual_launches = 0  # launches that also wrote the max / den residuals


def fused_attend_bwd(xl, xr, att, out, m, den, g, graph, side, heads, slope=NEGATIVE_SLOPE):
    """The backward kernel (CUDA tensors): the forward's inputs, output and
    residuals (see :func:`attend_forward`) and the output's cotangent g (S,
    D). Returns (dxl (E, D), dxr (S, D), datt (D,)). Its plain version is
    autograd through :func:`fused_attend_plain`."""
    _, S = side_ids(graph, side)
    E, D = graph.num_edges, xl.shape[1]
    C = head_width(D, heads)
    ins = [kb.aligned(kb.cuda_f32(name, t, shape)) for name, t, shape in (
        ("xl", xl, (E, D)), ("xr", xr, (S, D)), ("att", att.reshape(-1), (D,)),
        ("out", out, (S, D)), ("m", m, (S, heads)), ("den", den, (S, heads)),
        ("g", g, (S, D)))]
    ptr, perm = side_csr(graph, side)
    split, n_long, n_chunks = point_split(graph, side)
    dev = ins[0].device
    dxl, dxr, datt = kb.f32_empty((E, D), dev), kb.f32_empty((S, D), dev), kb.f32_empty((32,), dev)
    if perm is None:  # quads and chunks strided over resident blocks, one d att row each
        grid = kb.grid_for(dev, -(-S // QUAD) + n_chunks, POINT_WARPS,
                           per_sm=POINT_BWD_BLOCKS_PER_SM)
    else:  # a block per camera
        grid = S
    partials = kb.f32_empty((max(grid, 1), 32), dev)
    dxr_part = kb.f32_empty((n_chunks, 32), dev) if n_chunks else None
    p = kb.ptr
    code = _entry("gasfm_attend_bwd")(
        *(p(t) for t in ins), p(ptr), p(perm), p(split), n_long, n_chunks, S, D, C,
        float(slope), p(dxl), p(dxr), p(datt), p(dxr_part), p(partials), grid, kb.stream(dev))
    kb.check(code, "fused_attend_bwd")
    fused_attend_bwd.launches += 1
    return dxl, dxr, datt[:D]


fused_attend_bwd.launches = 0
