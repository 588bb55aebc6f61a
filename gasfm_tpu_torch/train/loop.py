"""The training session: forward, loss, gradients and optimizer steps.

Counterpart of ``TrainingSession`` in the JAX package's train/loop.py
(:153-305), single device: ``forward`` (the evaluation forward that
``epoch_evaluation`` drives), ``loss``, ``loss_and_grads``, ``update``,
``advance_schedule``, ``lr_at`` and ``fused_step`` — one training step,
forward, ESFM loss, backward, global gradient norm, Adam with the per-batch
LR schedule, and the on-device ``our_repro`` of the step's predictions.

A model with the depth head (and ``DirectDepthLoss``) has no cameras or
points to take ``our_repro`` of: it trains through ``loss_and_grads`` +
``update``, as the JAX package's ``epoch_train`` does for it
(train/loop.py:443, :495-527), and ``fused_step`` raises.

Where the JAX package returns new parameters and optimizer state, the port
updates the model's parameters and its optimizer state in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from gasfm_tpu_torch.eval.metrics import core_errors_device
from gasfm_tpu_torch.losses import DirectDepthLoss, ESFMLoss
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
from gasfm_tpu_torch.train.state import FLAGSHIP_OPTIM, build_optimizer, global_norm
from gasfm_tpu_torch.utils.device import resolve_device


class TrainingSession:
    """Holds a model (GASFM's ``GraphAttnSfMNet`` or DPESFM's
    ``SetOfSetNet``), its loss and its optimizer on one device (``cuda``
    unless the caller passes ``device="cpu"``; raises when CUDA is asked for
    and absent). ``optim``: :func:`~gasfm_tpu_torch.train.state.build_optimizer`'s
    keyword arguments, the flagship conf's by default."""

    def __init__(self, model: Union[GraphAttnSfMNet, SetOfSetNet],
                 loss_func: Union[ESFMLoss, DirectDepthLoss],
                 device: Optional[Union[str, torch.device]] = None,
                 optim: Optional[dict] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_func = loss_func
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = build_optimizer(self.params, **(optim or FLAGSHIP_OPTIM))

    @torch.no_grad()
    def forward(self, scene, plain: bool = False) -> Dict[str, torch.Tensor]:
        """Predicted ``Ps_norm`` (m, 3, 4) and ``pts3D`` (4, n), or with the
        depth head ``depths`` (E,), for a
        :class:`~gasfm_tpu_torch.graph.view_graph.SceneGraph` on this
        session's device. ``plain=True`` runs the kernels' plain versions
        (for comparing the two on the card)."""
        return self.model(scene.graph, plain=plain)

    @torch.no_grad()
    def loss(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        return self.loss_func(pred, scene, plain=plain)

    def loss_and_grads(self, scene, plain: bool = False
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
        """(loss, predictions, one gradient per parameter): forward and
        backward through the kernels (their plain versions with ``plain``).
        Parameters a configuration leaves unused get zero gradients, as
        optax treats them."""
        with torch.enable_grad():
            pred = self.model(scene.graph, plain=plain)
            loss = self.loss_func(pred, scene, plain=plain)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        # contiguous: the kernels' weight gradients can be views of one sums
        # buffer, and PyTorch's multi-tensor Adam and norm fall back to one
        # kernel per tensor when a gradient is not contiguous
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for p, g in zip(self.params, grads)]
        return loss.detach(), {k: v.detach() for k, v in pred.items()}, grads

    def update(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """One optimizer step from ``grads`` (in place); returns their global
        norm before clipping."""
        norm = global_norm(grads)
        self.optimizer.step(grads, norm)
        return norm

    def advance_schedule(self) -> None:
        """Step only the LR schedule (a batch without valid samples)."""
        self.optimizer.advance_schedule()

    def lr_at(self, step: int) -> float:
        return self.optimizer.lr_at(step)

    def fused_step(self, scene, plain: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One training step on ``scene``: updates the model's parameters and
        the optimizer state in place and returns (loss, our_repro,
        grad_norm) as 0-d tensors on the device, without synchronising.
        ``our_repro`` is that of the predictions the loss was taken on.
        ``plain=True`` runs the kernels' plain versions throughout. Needs a
        model with the view and scenepoint heads."""
        if self.model.depth_head_enabled:
            raise ValueError("fused_step takes our_repro of the view and scenepoint heads' "
                             "predictions; a depth-head model trains through loss_and_grads "
                             "and update")
        loss, pred, grads = self.loss_and_grads(scene, plain=plain)
        grad_norm = self.update(grads)
        with torch.no_grad():
            repro = core_errors_device(pred, scene, plain=plain)["our_repro"]
        return loss, repro, grad_norm
