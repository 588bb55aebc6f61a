"""The training session's forward and loss.

Counterpart of ``TrainingSession.forward`` in the JAX package's
train/loop.py — the evaluation forward that ``epoch_evaluation`` drives to
predict cameras and 3D points for a scene — and of its loss. The training
methods (backward, Adam, schedules) come with the next slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from gasfm_tpu_torch.losses import ESFMLoss
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.utils.device import resolve_device


class TrainingSession:
    """Holds a model and its loss on one device (``cuda`` unless the caller
    passes ``device="cpu"``; raises when CUDA is asked for and absent)."""

    def __init__(self, model: GraphAttnSfMNet, loss_func: ESFMLoss,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_func = loss_func

    @torch.no_grad()
    def forward(self, scene, plain: bool = False) -> Dict[str, torch.Tensor]:
        """Predicted ``Ps_norm`` (m, 3, 4) and ``pts3D`` (4, n) for a
        :class:`~gasfm_tpu_torch.graph.view_graph.SceneGraph` on this
        session's device. ``plain=True`` runs the kernels' plain versions
        (for comparing the two on the card)."""
        return self.model(scene.graph, plain=plain)

    @torch.no_grad()
    def loss(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        return self.loss_func(pred, scene, plain=plain)
