"""Loss functions over the port's edge graph (forward values).

Counterpart of the JAX package's losses.py. ``ESFMLoss`` is the reference's
unsupervised hinge-robustified reprojection loss (code/loss_functions.py:
69-123) in edge form: the mean over observed edges of the reprojection
error, or of ``(margin - depth) * weight`` where the depth fails the margin.
It runs through the ESFM-terms kernel (``ops/kernels/fused_loss.py``). The
reference's gradient-direction equalization acts on the backward only and
comes with the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from gasfm_tpu_torch.ops.kernels.fused_loss import fused_esfm_terms, fused_esfm_terms_plain


class ESFMLoss:
    def __init__(self, infinity_pts_margin: float = 1e-4, hinge_loss: bool = True,
                 hinge_loss_weight: float = 1.0):
        self.infinity_pts_margin = float(infinity_pts_margin)
        self.hinge_loss = bool(hinge_loss)
        self.hinge_loss_weight = float(hinge_loss_weight) if hinge_loss else 0.0

    def __call__(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        graph = scene.graph
        fn = fused_esfm_terms_plain if plain else fused_esfm_terms
        terms = fn(pred["Ps_norm"].reshape(graph.num_cams, 12), pred["pts3D"].T.contiguous(),
                   graph, self.infinity_pts_margin, self.hinge_loss, self.hinge_loss_weight)
        return terms[0] / terms[1].clamp_min(1.0)
