"""ESFM loss terms: CUDA kernels for Hopper (``csrc/fused_loss.cu``),
forward and backward, their plain PyTorch version, and their launch
counters.

Replaces the TPU kernels of ``gasfm_tpu/ops/pallas/fused_loss.py``
(``fused_esfm_terms`` / ``_fwd_raw``; backward ``_bwd_raw``): per edge the
homogeneous projection ``P[cam] . X[pt]``, the hinge or reprojection term,
and three scalars — the sum of the terms, the number of edges and the
number of edges whose depth passes the margin. The backward gives the
cameras' and points' gradients with the reference's gradient-direction
equalization (``eq_mode``: "none", "all", "valid_only"), which acts on the
backward only.

What bounds them on the H100 is bytes over its 3.35 TB/s: each edge gathers
a 48-byte camera row and a 16-byte point row and reads its observation and
two ids, against ~40 flops; at the bench scenes' sizes a call is its launch
and a few DRAM latencies. Forward: one launch, each thread two edges with
their loads issued ahead, one partial triple per block, the partials summed
in block order by the last block to finish (a ticket on a counter that
belongs to the stream, :func:`_ticket`). Backward: the two table gradients
are segment sums on the segment sum's walk and split
(``segment_kernels.sum_split``; a point of more than LONG_POINT edges, a
camera of more than SUM_ROWS, takes a block), each edge's gradient row
computed in place of loaded, both sides in one launch (plus a merge launch
per side where a hub has several parts). No float atomics: deterministic
throughout.

A CPU tensor runs the plain version (autograd through it, with the
equalization Function below, is the backward's plain version); a CUDA
tensor launches the kernel or raises. ``launches`` counts the calls that
launched.

Under an edge mesh (``ops/segment.py`` ``edge_partitioned``) the three
scalars are the rank's own, over its edge shard; the loss takes their
``all_sum_final``. The equalization's count is the scene's: its forward sums
the shards' counts over the edge group (the JAX package's
``fused_loss.py:349-359``), and the backward divides by it.
"""

from __future__ import annotations

import functools

import torch

from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.kernels.segment_kernels import sum_split
from gasfm_tpu_torch.ops.segment import all_sum_final, edge_group

TERMS_EDGES = 512  # edges per block of the forward: kTermsThreads x kTermsEdges
LONG_POINT = 32  # kLossLongPoint of csrc/fused_loss.cu: the longest point a lane group walks
EQ_MODES = {"none": 0, "all": 1, "valid_only": 2}
_ARGS = (kb.P,) * 5 + (kb.I, kb.F, kb.I, kb.F) + (kb.P,) * 4
_BWD_ARGS = ((kb.P,) * 8 + (kb.I,) * 3 + (kb.F, kb.I, kb.F, kb.I) + (kb.P,) * 2
             + (kb.P, kb.I, kb.I) * 2 + (kb.P,) * 5)
_TICKETS = {}


@functools.lru_cache(maxsize=None)
def _entry(symbol="gasfm_esfm_terms"):
    args = _ARGS if symbol == "gasfm_esfm_terms" else _BWD_ARGS
    return kb.bind(kb.load("fused_loss"), symbol, args)


def _ticket(dev):
    """The forward's ticket counter on the current stream of ``dev``: one
    int32 per (device, stream), zeroed once; each call leaves it at 0 (the
    last block's atomicInc wraps it), and calls on one stream run in order,
    so no two calls share a counter at once. A CUDA graph reads the counter
    of the stream it was recorded on, at each replay's start at 0 as the
    previous call left it. The counter is never made inside a recording
    (raises): there it would come from the graph's private memory, which
    this table outlives; a recording's eager warm-up on its stream makes it
    first (``train/loop.py``)."""
    key = (dev.index, kb.stream(dev))
    t = _TICKETS.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused_esfm_terms: the loss's ticket counter of this stream is "
                               "made in a CUDA graph recording; run the step once on the "
                               "recording's stream first")
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def _tables(P_flat, Xt, graph):
    """The kernels' table operands, validated: P_flat (m, 12) and Xt (n, 4)
    16-byte aligned (a camera row is read as three float4, a point as one),
    uv (E, 2) 8-byte aligned (one float2 per edge)."""
    P_flat = kb.aligned(kb.cuda_f32("P_flat", P_flat, (graph.num_cams, 12)))
    Xt = kb.aligned(kb.cuda_f32("Xt", Xt, (graph.num_pts, 4)))
    uv = kb.aligned(kb.cuda_f32("uv", graph.uv, (graph.num_edges, 2)))
    return P_flat, Xt, uv


class EqualizeGrads(torch.autograd.Function):
    """Identity on the per-edge projections (E, 3) whose backward normalizes
    each row's cotangent and scales it by ``inv_count`` — the reference's
    backward hook (``F.normalize(grad, dim=1) / count``), the JAX package's
    ``_equalize_grads_all`` / ``_equalize_grads_valid_only``. Under
    ``valid_only`` only rows with ``pos`` are normalized; the others keep
    their cotangent. ``pos`` and ``inv_count`` carry no gradient."""

    @staticmethod
    def forward(ctx, proj, pos, inv_count, valid_only):
        ctx.save_for_backward(pos, inv_count)
        ctx.valid_only = valid_only
        return proj.clone()

    @staticmethod
    def backward(ctx, g):
        pos, inv_count = ctx.saved_tensors
        norm = torch.linalg.vector_norm(g, dim=1, keepdim=True)
        normalized = g / norm.clamp_min(1e-12) * inv_count
        if ctx.valid_only:
            normalized = torch.where(pos[:, None], normalized, g)
        return normalized, None, None, None


def fused_esfm_terms_plain(P_flat, Xt, graph, margin, hinge, hinge_w, eq_mode="none"):
    """Plain version. P_flat (m, 12) row-major cameras, Xt (n, 4) homogeneous
    points. Returns (3,) = (sum of terms, #edges, #positive-depth edges); the
    counts carry no gradient."""
    P_e = P_flat[graph.cam_idx.long()].reshape(-1, 3, 4)
    X_e = Xt[graph.pt_idx.long()]
    proj = (P_e * X_e[:, None, :]).sum(-1)  # (E, 3)
    depth = proj[:, 2].detach()
    pos = depth >= margin if hinge else depth.abs() >= margin
    n_pos = pos.to(proj.dtype).sum()
    n_edges = torch.tensor(float(graph.num_edges), dtype=proj.dtype, device=proj.device)
    if eq_mode != "none":
        counts = all_sum_final(torch.stack([n_edges, n_pos]))  # the scene's under a mesh
        count = counts[1] if eq_mode == "valid_only" else counts[0]
        proj = EqualizeGrads.apply(proj, pos, 1.0 / count.clamp_min(1.0), eq_mode == "valid_only")
    depth = proj[:, 2]
    denom = torch.where(pos, depth, torch.ones_like(depth))
    r = proj[:, :2] / denom[:, None] - graph.uv
    sq = (r * r).sum(1)
    nz = sq > 0
    rnorm = torch.where(nz, torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))), torch.zeros_like(sq))
    term = torch.where(pos, rnorm, (margin - depth) * hinge_w)
    return torch.stack([term.sum(), n_edges, n_pos])


def esfm_terms_forward(P_flat, Xt, graph, margin, hinge, hinge_w):
    """Launch the forward kernel (CUDA tensors). Returns (terms (3,), P_flat,
    Xt) with the validated operands."""
    E = graph.num_edges
    P_flat, Xt, uv = _tables(P_flat, Xt, graph)
    dev = P_flat.device
    partials = kb.f32_empty((max(1, -(-E // TERMS_EDGES)), 3), dev)
    out = kb.f32_empty((3,), dev)
    p = kb.ptr
    code = _entry()(p(P_flat), p(Xt), p(uv), p(kb.cuda_i32("cam_idx", graph.cam_idx)),
                    p(kb.cuda_i32("pt_idx", graph.pt_idx)), E, float(margin), int(bool(hinge)),
                    float(hinge_w), p(partials), p(_ticket(dev)), p(out), kb.stream(dev))
    kb.check(code, "fused_esfm_terms")
    fused_esfm_terms.launches += 1
    return out, P_flat, Xt


class _EsfmTerms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, P_flat, Xt, graph, margin, hinge, hinge_w, eq_mode):
        out, P_c, X_c = esfm_terms_forward(P_flat, Xt, graph, margin, hinge, hinge_w)
        counts = out
        if eq_mode != "none" and edge_group() is not None:
            counts = all_sum_final(out)  # the scene's counts, for the equalization
        ctx.save_for_backward(P_c, X_c, counts)
        ctx.args = (graph, margin, hinge, hinge_w, eq_mode)
        return out  # the counts' cotangents are ignored by the backward

    @staticmethod
    def backward(ctx, g_terms):
        P_c, X_c, out = ctx.saved_tensors
        graph, margin, hinge, hinge_w, eq_mode = ctx.args
        count = out[2:3] if eq_mode == "valid_only" else out[1:2]
        dP, dX = fused_esfm_terms_bwd(P_c, X_c, graph, g_terms[0:1], count, margin, hinge,
                                      hinge_w, eq_mode)
        return dP, dX, None, None, None, None, None


def fused_esfm_terms(P_flat, Xt, graph, margin, hinge, hinge_w, eq_mode="none"):
    """The three ESFM loss scalars (see module docstring); only the first
    is differentiable, with the equalization ``eq_mode`` in its backward."""
    if P_flat.device.type == "cpu":
        return fused_esfm_terms_plain(P_flat, Xt, graph, margin, hinge, hinge_w, eq_mode)
    if kb.needs_grad(P_flat, Xt):
        return _EsfmTerms.apply(P_flat, Xt, graph, margin, hinge, hinge_w, eq_mode)
    return esfm_terms_forward(P_flat, Xt, graph, margin, hinge, hinge_w)[0]


fused_esfm_terms.launches = 0


def fused_esfm_terms_bwd(P_flat, Xt, graph, coef, count, margin, hinge, hinge_w,
                         eq_mode="none"):
    """The loss terms' backward kernel (CUDA tensors): coef (1,) the
    cotangent of the sum of terms; count (1,) the equalization count
    (positive-depth edges for "valid_only", all edges for "all"; unused
    under "none"), both read on the card. Returns (dP (m, 12), dX (n, 4)).
    Its plain version is autograd through :func:`fused_esfm_terms_plain`."""
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    P_flat, Xt, uv = _tables(P_flat, Xt, graph)
    coef = kb.cuda_f32("coef", coef.reshape(1), (1,))
    count = kb.cuda_f32("count", count.reshape(1), (1,))
    dev = P_flat.device
    pt_split, pt_long, pt_chunks, pt_part = sum_split(graph, "point", 4, dev, LONG_POINT)
    cam_split, cam_long, cam_chunks, cam_part = sum_split(graph, "camera", 12, dev)
    dP, dX = kb.f32_empty((m, 12), dev), kb.f32_empty((n, 4), dev)
    p = kb.ptr
    code = _entry("gasfm_esfm_terms_bwd")(
        p(P_flat), p(Xt), p(uv), p(kb.cuda_i32("cam_idx", graph.cam_idx)),
        p(kb.cuda_i32("pt_idx", graph.pt_idx)), p(kb.cuda_i32("pt_ptr", graph.pt_ptr)),
        p(kb.cuda_i32("cam_ptr", graph.cam_ptr)), p(kb.cuda_i32("cam_perm", graph.cam_perm)),
        E, n, m, float(margin), int(bool(hinge)), float(hinge_w), EQ_MODES[eq_mode], p(coef),
        p(count), p(pt_split), pt_long, pt_chunks, p(cam_split), cam_long, cam_chunks,
        p(pt_part), p(cam_part), p(dP), p(dX), kb.stream(dev),
    )
    kb.check(code, "fused_esfm_terms_bwd")
    fused_esfm_terms_bwd.launches += 1
    return dP, dX


fused_esfm_terms_bwd.launches = 0
