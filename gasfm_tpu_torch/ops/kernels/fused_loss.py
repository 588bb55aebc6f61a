"""ESFM loss terms, forward: CUDA kernel for Hopper (``csrc/fused_loss.cu``),
its plain PyTorch version, and its launch counter.

Replaces the TPU kernel of ``gasfm_tpu/ops/pallas/fused_loss.py``
(``fused_esfm_terms`` / ``_fwd_raw``): per edge the homogeneous projection
``P[cam] . X[pt]``, the hinge or reprojection term, and three scalars — the
sum of the terms, the number of edges and the number of edges whose depth
passes the margin.

What bounds it on the H100 is bytes over its 3.35 TB/s: each edge gathers a
48-byte camera row and a 16-byte point row and reads its observation and two
ids, against ~40 flops. One thread per edge, nothing per edge written back,
a fixed-order block tree and a second one-block pass over the block partials
(two launches per call, counted once): deterministic, no float atomics.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. ``fused_esfm_terms.launches`` counts the calls that launched.
"""

from __future__ import annotations

import functools

import torch

from gasfm_tpu_torch.ops.kernels import build as kb

_THREADS = 256
_ARGS = (kb.P,) * 5 + (kb.I, kb.F, kb.I, kb.F) + (kb.P,) * 3


@functools.lru_cache(maxsize=None)
def _entry():
    return kb.bind(kb.load("fused_loss"), "gasfm_esfm_terms", _ARGS)


def fused_esfm_terms_plain(P_flat, Xt, graph, margin, hinge, hinge_w):
    """Plain version. P_flat (m, 12) row-major cameras, Xt (n, 4) homogeneous
    points. Returns (3,) = (sum of terms, #edges, #positive-depth edges)."""
    P_e = P_flat[graph.cam_idx.long()].reshape(-1, 3, 4)
    X_e = Xt[graph.pt_idx.long()]
    proj = (P_e * X_e[:, None, :]).sum(-1)  # (E, 3)
    depth = proj[:, 2]
    pos = depth >= margin if hinge else depth.abs() >= margin
    denom = torch.where(pos, depth, torch.ones_like(depth))
    r = proj[:, :2] / denom[:, None] - graph.uv
    sq = (r * r).sum(1)
    nz = sq > 0
    rnorm = torch.where(nz, torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))), torch.zeros_like(sq))
    term = torch.where(pos, rnorm, (margin - depth) * hinge_w)
    n_edges = torch.tensor(float(graph.num_edges), dtype=term.dtype, device=term.device)
    return torch.stack([term.sum(), n_edges, pos.to(term.dtype).sum()])


def fused_esfm_terms(P_flat, Xt, graph, margin, hinge, hinge_w):
    """The three ESFM loss scalars (see module docstring)."""
    if P_flat.device.type == "cpu":
        return fused_esfm_terms_plain(P_flat, Xt, graph, margin, hinge, hinge_w)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    P_flat = kb.cuda_f32("P_flat", P_flat, (m, 12))
    Xt = kb.cuda_f32("Xt", Xt, (n, 4))
    if Xt.data_ptr() % 16:  # the kernel reads each point as one float4
        Xt = Xt.clone()
    uv = kb.cuda_f32("uv", graph.uv, (E, 2))
    cam_idx = kb.cuda_i32("cam_idx", graph.cam_idx)
    pt_idx = kb.cuda_i32("pt_idx", graph.pt_idx)
    dev = P_flat.device
    partials = torch.empty((max(1, -(-E // _THREADS)), 3), dtype=torch.float32, device=dev)
    out = torch.empty((3,), dtype=torch.float32, device=dev)
    p = kb.ptr
    code = _entry()(p(P_flat), p(Xt), p(uv), p(cam_idx), p(pt_idx), E, float(margin),
                    int(bool(hinge)), float(hinge_w), p(partials), p(out), kb.stream(dev))
    kb.check(code, "fused_esfm_terms")
    fused_esfm_terms.launches += 1
    return out


fused_esfm_terms.launches = 0
