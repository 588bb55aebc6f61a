"""Optimizer construction: Adam with the per-batch LR schedule and optional
gradient clipping.

Counterpart of ``build_optimizer`` and ``advance_schedule_count`` in the JAX
package's train/state.py (reference: torch.optim.Adam with default betas and
eps, train.py:437; clipping by global norm or by value before the update,
train.py:141-151). Until the port reads confs, the builder takes the conf's
values as keyword arguments; ``FLAGSHIP_OPTIM`` holds those of
``confs/gasfm/optim_euc_gasfm.conf``, ``DPESFM_OPTIM`` those of
``confs/dpesfm/learning_euc_noaug_dpesfm.conf``.

Two counters, as in the JAX package: the schedule's count advances on every
batch (:meth:`Optimizer.advance_schedule` for a batch without an update),
Adam's own step count (bias correction) only on real updates. Update k
(counting batches from 0) uses lr = schedule(k).

The bf16 first-moment / second-moment storage and the bf16-parameter
(f32 master) options of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch

from gasfm_tpu_torch.train.schedules import build_lr_schedule

FLAGSHIP_OPTIM = dict(lr=1e-4, main_scheduler="exponential", lr_warmup_n_steps=2500,
                      exp_n_steps=35000, exp_gamma_after_n_steps=0.1, grad_clip_mode=None)
# The optimizer of confs/dpesfm/learning_euc_noaug_dpesfm.conf (:67-79, :117).
DPESFM_OPTIM = dict(lr=1e-3, main_scheduler="multistep", lr_warmup_n_steps=0,
                    multistep_milestones=[60000], multistep_gamma=0.5, grad_clip_mode=None)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares of every element of every tensor) — optax's
    ``global_norm``, as a 0-d tensor (no host synchronisation)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def clip_grads(grads: List[torch.Tensor], mode: Optional[str], threshold: Optional[float],
               norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax's clipping formulas. "norm": ``clip_by_global_norm`` — the
    gradients unchanged when their global norm is below the threshold, else
    ``g / norm * threshold`` (no epsilon, unlike ``clip_grad_norm_``);
    "value": ``clip`` to [-threshold, threshold]; None: unchanged."""
    if mode is None:
        return grads
    if mode == "norm":
        norm = global_norm(grads) if norm is None else norm
        keep = norm < threshold
        return [torch.where(keep, g, g / norm * threshold) for g in grads]
    if mode == "value":
        return [g.clamp(-threshold, threshold) for g in grads]
    raise AssertionError(f'Could not interpret gradient clipping mode "{mode}".')


class Optimizer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8; ``torch.optim.Adam``, the
    reference's optimizer) with the LR schedule and optional clipping."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, main_scheduler: str,
                 lr_warmup_n_steps: int = 0, exp_gamma_after_n_steps: Optional[float] = None,
                 exp_n_steps: Optional[float] = None,
                 multistep_milestones: Optional[Sequence[int]] = None,
                 multistep_gamma: float = 0.1, milestone_shift: int = 0,
                 grad_clip_mode: Optional[str] = None, grad_clip_th: Optional[float] = None):
        self.params = list(params)
        self.schedule = build_lr_schedule(
            lr, main_scheduler, lr_warmup_n_steps, exp_gamma_after_n_steps, exp_n_steps,
            multistep_milestones, multistep_gamma, milestone_shift)
        if grad_clip_mode is not None and grad_clip_th is None:
            raise ValueError("grad_clip_mode needs grad_clip_th")
        self.grad_clip_mode, self.grad_clip_th = grad_clip_mode, grad_clip_th
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.schedule_count = 0  # batches seen, updates or not

    def lr_at(self, step: int) -> float:
        return float(self.schedule(step))

    def step(self, grads: Sequence[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads`` (one per parameter, in order), in place:
        clip, set this batch's LR, Adam, advance the schedule."""
        grads = clip_grads(list(grads), self.grad_clip_mode, self.grad_clip_th, norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.schedule_count)
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.schedule_count += 1

    def advance_schedule(self) -> None:
        """A batch without an update: the schedule steps, Adam's count does not."""
        self.schedule_count += 1


def build_optimizer(params: Iterable[torch.nn.Parameter], **conf) -> Optimizer:
    """Adam + per-batch LR schedule + optional clipping from the conf's
    ``train.lr``, ``train.lr_schedule.*`` and ``loss.grad_clip_*`` values,
    given as keyword arguments (see :class:`Optimizer`)."""
    return Optimizer(params, **conf)
