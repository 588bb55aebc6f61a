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
