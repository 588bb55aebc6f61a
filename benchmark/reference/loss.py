"""The ESFM loss and the mean reprojection error, in plain PyTorch.

ESFM: each observation's projection ``P[cam] @ X[pt]``; where its depth is
at least the margin, the distance of its perspective division from the
normalized observation, else ``(margin - depth) * hinge_weight``; the mean
over the observations. With the gradient equalization on, the backward
replaces each projection's cotangent by its unit vector over the count of
observations (with ``normalize_grad_wrt_valid_projections_only``, only those
of positive depth, over their count; the others keep theirs).

``our_repro``: the mean pixel distance between the projections of the
predicted cameras (``Ns^-1 @ Ps_norm``) and the observations, over the
observations whose error is finite and whose depth is not 0.
"""

from __future__ import annotations

import torch


class _Equalize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj, pos, scale, valid_only):
        ctx.save_for_backward(pos)
        ctx.scale, ctx.valid_only = scale, valid_only
        return proj.clone()

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        unit = g / torch.linalg.vector_norm(g, dim=1, keepdim=True).clamp_min(1e-12) * ctx.scale
        if ctx.valid_only:
            unit = torch.where(pos[:, None], unit, g)
        return unit, None, None, None


def project(Ps: torch.Tensor, pts: torch.Tensor, graph) -> torch.Tensor:
    """(E, 3) projections of each edge's point by its camera."""
    return torch.einsum("eij,ej->ei", Ps[graph.cam], pts.T[graph.pt])


def esfm_loss(pred: dict, graph, loss_conf: dict, edges=None) -> torch.Tensor:
    """The loss; ``edges`` (a slice) restricts it to those observations."""
    margin = float(loss_conf["infinity_pts_margin"])
    hinge = bool(loss_conf["hinge_loss"])
    weight = float(loss_conf["hinge_loss_weight"]) if hinge else 0.0
    proj = project(pred["Ps_norm"], pred["pts3D"], graph)
    uv = graph.uv
    if edges is not None:
        proj, uv = proj[edges], uv[edges]
    depth = proj[:, 2].detach()
    pos = depth >= margin if hinge else depth.abs() >= margin
    if loss_conf["pts_grad_equalization_pre_perspective_divide"]:
        valid_only = bool(loss_conf["normalize_grad_wrt_valid_projections_only"])
        count = int(pos.sum()) if valid_only else proj.shape[0]
        proj = _Equalize.apply(proj, pos, 1.0 / max(count, 1), valid_only)
    z = proj[:, 2]
    r = proj[:, :2] / torch.where(pos, z, torch.ones_like(z))[:, None] - uv
    sq = (r * r).sum(1)
    nz = sq > 0
    dist = torch.where(nz, torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))
    term = torch.where(pos, dist, (margin - z) * weight)
    return term.sum() / max(proj.shape[0], 1)


@torch.no_grad()
def our_repro(pred: dict, graph) -> torch.Tensor:
    Ps = torch.einsum("mij,mjk->mik", graph.Ns_inv, pred["Ps_norm"])
    proj = project(Ps, pred["pts3D"], graph)
    z = proj[:, 2]
    uv_proj = proj[:, :2] / torch.where(z == 0, torch.ones_like(z), z)[:, None]
    obs = torch.cat([graph.uv, torch.ones_like(graph.uv[:, :1])], dim=1)
    pix = torch.einsum("eij,ej->ei", graph.Ns_inv[graph.cam], obs)
    w = pix[:, 2]
    pix = pix[:, :2] / torch.where(w == 0, torch.ones_like(w), w)[:, None]
    err = torch.sqrt(((uv_proj - pix) ** 2).sum(1))
    valid = torch.isfinite(err) & (z != 0) & (w != 0)
    return torch.where(valid, err, torch.zeros_like(err)).sum() / valid.sum().clamp_min(1)
