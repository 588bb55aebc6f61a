"""Loss functions over the port's edge graph.

Counterpart of the JAX package's losses.py. ``ESFMLoss`` is the reference's
unsupervised hinge-robustified reprojection loss (code/loss_functions.py:
69-123) in edge form: the mean over observed edges of the reprojection
error, or of ``(margin - depth) * weight`` where the depth fails the margin.
It runs through the ESFM-terms kernel (``ops/kernels/fused_loss.py``).
The reference's gradient-direction equalization (its backward hook,
loss_functions.py:100-110) acts on the backward only: with
``pts_grad_equalization`` each edge's projection cotangent is normalized and
divided by the number of edges, or, with ``normalize_grad_valid_only``,
only the positive-depth edges' are, divided by their number.

``DirectDepthLoss`` is the depth head's supervised loss (reference
loss_functions.py:24-66, the JAX package's losses.py:303-333): L1 or L2
between the predicted and the GT per-edge depths, each divided by its mean
over the edges. The JAX package computes it in XLA with no Pallas kernel;
here it is plain PyTorch on every device.

``ExpDepthRegularizedOSELoss`` (the object-space error plus an exponential
push on the depths, reference loss_functions.py:126-150) and ``GTLoss`` (the
supervised pose loss, :153-204) are plain PyTorch too, as the JAX package
runs both in XLA. ``GTLoss`` follows the JAX package's reading of the
reference's calibrated branch, which calls functions the reference lacks:
the L2 distance of the rotations' quaternions plus that of the normalized
camera centres, the predictions taken from ``Ps_norm``.

Each loss has a ``from_conf`` builder with the JAX package's keys and
asserts, and :func:`get_loss_func` builds the loss a conf's ``loss.func``
names (``gasfm_tpu/losses.py:344-359``). The port's graph holds valid
edges and cameras only, so its means run over E and m.

Under an edge mesh (``ops/segment.py`` ``edge_partitioned``) each loss is
the scene's: its sums over edges are ``all_sum_final`` of the ranks' (the
JAX package's losses.py:149-235), except ``DirectDepthLoss``'s ``s_pred``,
which every edge's divide reads back and so is the interior ``all_sum``
(:323-325); its means divide by the scene's edges. ``GTLoss`` reads the
camera tables only, the same on every rank: its gradient is counted on the
edge group's first rank (``replicated_final``).
"""

from __future__ import annotations

from typing import Dict

import torch

from gasfm_tpu_torch.geometry.rotations import matrix_to_quaternion
from gasfm_tpu_torch.ops.kernels.fused_loss import fused_esfm_terms, fused_esfm_terms_plain
from gasfm_tpu_torch.ops.segment import all_sum, all_sum_final, replicated_final

# The loss of confs/gasfm/optim_euc_gasfm.conf, as ESFMLoss's keyword arguments.
FLAGSHIP_LOSS = dict(infinity_pts_margin=1e-4, hinge_loss=True, hinge_loss_weight=1.0,
                     pts_grad_equalization=True, normalize_grad_valid_only=True)
# The loss of confs/dpesfm/learning_euc_noaug_dpesfm.conf (:112-120): equalization
# over all edges.
DPESFM_LOSS = dict(infinity_pts_margin=1e-4, hinge_loss=True, hinge_loss_weight=1.0,
                   pts_grad_equalization=True, normalize_grad_valid_only=False)


# The depth loss of confs/synth/optim_synth_depth_gasfm.conf (:64-67).
DEPTH_LOSS = dict(cost_fcn="L1")


class ESFMLoss:
    def __init__(self, infinity_pts_margin: float = 1e-4, hinge_loss: bool = True,
                 hinge_loss_weight: float = 1.0, pts_grad_equalization: bool = False,
                 normalize_grad_valid_only: bool = False):
        self.infinity_pts_margin = float(infinity_pts_margin)
        self.hinge_loss = bool(hinge_loss)
        self.hinge_loss_weight = float(hinge_loss_weight) if hinge_loss else 0.0
        self.pts_grad_equalization = bool(pts_grad_equalization)
        self.normalize_grad_valid_only = bool(normalize_grad_valid_only) and self.pts_grad_equalization

    @classmethod
    def from_conf(cls, conf) -> "ESFMLoss":
        """The JAX package's ``ESFMLoss(conf)`` (``gasfm_tpu/losses.py:
        109-131``): ``loss.pts_grad_equalization_pre_perspective_divide`` is
        ``pts_grad_equalization``, ``loss.normalize_grad_wrt_valid_projections_only``
        ``normalize_grad_valid_only`` (read only with the equalization on);
        the hinge weight is read only with the hinge on."""
        assert conf.get_bool("model.view_head.enabled", default=False)
        assert conf.get_bool("model.scenepoint_head.enabled", default=False)
        eq = conf.get_bool("loss.pts_grad_equalization_pre_perspective_divide")
        hinge = conf.get_bool("loss.hinge_loss")
        return cls(
            infinity_pts_margin=conf.get_float("loss.infinity_pts_margin"),
            hinge_loss=hinge,
            hinge_loss_weight=conf.get_float("loss.hinge_loss_weight") if hinge else 0.0,
            pts_grad_equalization=eq,
            normalize_grad_valid_only=(
                conf.get_bool("loss.normalize_grad_wrt_valid_projections_only") if eq else False),
        )

    @property
    def eq_mode(self) -> str:
        if not self.pts_grad_equalization:
            return "none"
        return "valid_only" if self.normalize_grad_valid_only else "all"

    def __call__(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        graph = scene.graph
        fn = fused_esfm_terms_plain if plain else fused_esfm_terms
        terms = fn(pred["Ps_norm"].reshape(graph.num_cams, 12), pred["pts3D"].T,
                   graph, self.infinity_pts_margin, self.hinge_loss, self.hinge_loss_weight,
                   self.eq_mode)
        terms = all_sum_final(terms)
        return terms[0] / terms[1].clamp_min(1.0)


class DirectDepthLoss:
    """Mean over the edges of ``|d / s_pred - d_gt / s_gt|`` (L1) or its
    square (L2), with ``s_pred`` the mean predicted depth and ``s_gt`` the
    mean GT depth (1 where that is 0). Needs ``scene.gt_depths`` (a scene
    built with depth targets). Calibrated scenes only, as in the JAX
    package. ``plain`` is accepted for the session's interface; the loss has
    no kernel."""

    def __init__(self, cost_fcn: str = "L1", calibrated: bool = True):
        if cost_fcn not in ("L1", "L2"):
            raise ValueError(f"DirectDepthLoss: cost_fcn {cost_fcn!r}, expected 'L1' or 'L2'")
        if not calibrated:
            raise NotImplementedError("DirectDepthLoss of an uncalibrated scene (the JAX "
                                      "package and the reference have none either)")
        self.cost_fcn = cost_fcn

    @classmethod
    def from_conf(cls, conf) -> "DirectDepthLoss":
        """The JAX package's ``DirectDepthLoss(conf)`` (``gasfm_tpu/losses.py:
        309-314``)."""
        assert conf.get_bool("model.depth_head.enabled")
        cost_fcn = conf.get_string("loss.cost_fcn")
        assert cost_fcn in ("L1", "L2")
        return cls(cost_fcn=cost_fcn, calibrated=conf.get_bool("dataset.calibrated"))

    def __call__(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        if scene.gt_depths is None:
            raise ValueError("DirectDepthLoss needs a scene built with depth targets "
                             "(SceneData(store_depth_targets=True))")
        d_pred, d_gt = pred["depths"], scene.gt_depths.to(pred["depths"].dtype)
        n = max(scene.graph.scene_edges, 1)
        s_pred = all_sum(d_pred.sum()) / n
        s_gt = all_sum_final(d_gt.sum()) / n
        diff = d_pred / s_pred - d_gt / torch.where(s_gt == 0, torch.ones_like(s_gt), s_gt)
        per_edge = diff.abs() if self.cost_fcn == "L1" else diff * diff
        return all_sum_final(per_edge.sum()) / n


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm whose gradient at 0 is 0 (the JAX package's ``safe_norm``)."""
    sq = (x * x).sum(dim)
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def project_edges(Ps: torch.Tensor, pts3D: torch.Tensor, graph) -> torch.Tensor:
    """(E, 3) homogeneous projections ``P[cam_e] @ X[:, pt_e]`` (plain
    PyTorch)."""
    P_e = Ps.reshape(graph.num_cams, 12)[graph.cam_idx].reshape(-1, 3, 4)
    X_e = pts3D.T[graph.pt_idx]
    return torch.einsum("eij,ej->ei", P_e, X_e)


class ExpDepthRegularizedOSELoss:
    """Mean over the edges of the object-space error ``||proj_xy - depth *
    uv||`` plus ``depth_regul_weight * exp(-depth)`` (reference
    loss_functions.py:126-150; the JAX package's losses.py:215-236).
    ``plain`` is accepted for the session's interface; the loss has no
    kernel."""

    def __init__(self, depth_regul_weight: float):
        self.depth_regul_weight = float(depth_regul_weight)

    @classmethod
    def from_conf(cls, conf) -> "ExpDepthRegularizedOSELoss":
        assert conf.get_bool("model.view_head.enabled", default=False)
        assert conf.get_bool("model.scenepoint_head.enabled", default=False)
        return cls(conf.get_float("loss.depth_regul_weight"))

    def __call__(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        graph = scene.graph
        proj = project_edges(pred["Ps_norm"], pred["pts3D"], graph)
        depth = proj[:, 2]
        ose = safe_norm(proj[:, :2] - depth[:, None] * graph.uv, dim=1)
        per_edge = ose + self.depth_regul_weight * torch.exp(-depth)
        return all_sum_final(per_edge.sum()) / max(graph.scene_edges, 1)


class GTLoss:
    """The supervised pose loss (reference loss_functions.py:153-204, as
    the JAX package's losses.py:239-300 reads it): the mean over the cameras
    of the orientation error plus the mean of the distance between the GT
    camera centres (centred and scaled to mean norm 1) and the predicted
    ones. Calibrated, the orientation error is the L2 distance of the
    rotations' quaternions (``matrix_to_quaternion``, w >= 0); projective,
    the smaller of ``||V_p - V_g||`` and ``||V_p + V_g||`` over the
    Frobenius-normalized inverse-transposed 3x3 blocks. ``plain`` is
    accepted for the session's interface; the loss has no kernel."""

    def __init__(self, calibrated: bool):
        self.calibrated = bool(calibrated)

    @classmethod
    def from_conf(cls, conf) -> "GTLoss":
        assert conf.get_bool("model.view_head.enabled", default=False)
        assert conf.get_bool("model.scenepoint_head.enabled", default=False)
        return cls(conf.get_bool("dataset.calibrated"))

    def __call__(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        y = scene.Ps_gt.to(pred["Ps_norm"].dtype)
        Ns_invT = scene.Ns_inv.to(y.dtype).transpose(1, 2)
        m = max(y.shape[0], 1)
        A_inv = torch.linalg.inv(y[:, :3, :3])
        V_gt = A_inv.transpose(1, 2)
        t_gt = -torch.einsum("mij,mj->mi", A_inv, y[:, :3, 3])
        trans = t_gt.sum(0) / m
        scale = torch.linalg.norm(t_gt - trans, dim=1).sum() / m
        t_gt = (t_gt - trans) / torch.clamp(scale, min=1e-12)

        Ps = pred["Ps_norm"]
        Vs = torch.linalg.inv(Ps[:, :3, :3]).transpose(1, 2)
        ts = -torch.einsum("mij,mj->mi", Vs.transpose(1, 2), Ps[:, :3, 3])
        translation_err = torch.linalg.norm(t_gt - ts, dim=1)

        if self.calibrated:
            Rs_gt = matrix_to_quaternion((Ns_invT @ V_gt).transpose(1, 2))
            Rs = matrix_to_quaternion((Ns_invT @ Vs).transpose(1, 2))
            orient_err = torch.linalg.norm(Rs - Rs_gt, dim=1)
        else:
            def fro_normalized(V):
                fro = torch.linalg.norm(V.reshape(V.shape[0], -1), dim=1)
                return V / torch.clamp(fro, min=1e-12)[:, None, None]

            Vg, Vp = fro_normalized(V_gt), fro_normalized(Vs)
            d1 = torch.linalg.norm((Vp - Vg).reshape(Vp.shape[0], -1), dim=1)
            d2 = torch.linalg.norm((Vp + Vg).reshape(Vp.shape[0], -1), dim=1)
            orient_err = torch.minimum(d1, d2)
        return replicated_final(orient_err.sum() / m + translation_err.sum() / m)


_LOSS_REGISTRY = {
    "ESFMLoss": ESFMLoss,
    "ExpDepthRegularizedOSELoss": ExpDepthRegularizedOSELoss,
    "GTLoss": GTLoss,
    "DirectDepthLoss": DirectDepthLoss,
}


def get_loss_func(conf):
    """The loss of ``loss.func``, with the JAX package's head asserts
    (``gasfm_tpu/losses.py:344-359``, reference loss_functions.py:8-21):
    ``AssertionError`` for a head combination the loss does not take and for
    an unknown loss."""
    spec = conf.get_string("loss.func")
    if spec in ("ESFMLoss", "ExpDepthRegularizedOSELoss", "GTLoss"):
        assert conf.get_bool("model.view_head.enabled")
        assert conf.get_bool("model.scenepoint_head.enabled")
        assert not conf.get_bool("model.depth_head.enabled"), (
            "model.depth_head.enabled must be False when no loss is applied to that output.")
    elif spec == "DirectDepthLoss":
        assert conf.get_bool("model.depth_head.enabled")
        assert not conf.get_bool("model.view_head.enabled")
        assert not conf.get_bool("model.scenepoint_head.enabled")
    else:
        raise AssertionError(f"Unknown loss function: {spec}.")
    return _LOSS_REGISTRY[spec].from_conf(conf)
