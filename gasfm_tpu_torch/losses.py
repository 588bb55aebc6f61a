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
"""

from __future__ import annotations

from typing import Dict

import torch

from gasfm_tpu_torch.ops.kernels.fused_loss import fused_esfm_terms, fused_esfm_terms_plain

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

    def __call__(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        if scene.gt_depths is None:
            raise ValueError("DirectDepthLoss needs a scene built with depth targets "
                             "(SceneData(store_depth_targets=True))")
        d_pred, d_gt = pred["depths"], scene.gt_depths.to(pred["depths"].dtype)
        n = max(d_pred.shape[0], 1)
        s_pred = d_pred.sum() / n
        s_gt = d_gt.sum() / n
        diff = d_pred / s_pred - d_gt / torch.where(s_gt == 0, torch.ones_like(s_gt), s_gt)
        per_edge = diff.abs() if self.cost_fcn == "L1" else diff * diff
        return per_edge.sum() / n
