"""Learning-rate schedules stepped per batch.

Counterpart of the JAX package's train/schedules.py (reference
code/train.py:437-472: torch LinearLR warm-up chained via SequentialLR into
{constant, exponential, multistep}):

- warm-up (t < W):      lr * (1/(W+1) + (1 - 1/(W+1)) * t / W)
- exponential (t >= W): lr * gamma^(t - W), gamma = rate^(1/steps)
- multistep  (t >= W):  lr * gamma^#{milestones <= t - W}

``t`` is the number of batches seen before this one, so update k (counting
from 0) uses schedule(k), as optax evaluates its schedule on the count
before incrementing it. The schedule computes in float32, as the JAX
package's does, on a Python number or a tensor of steps.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def build_lr_schedule(
    base_lr: float,
    main_scheduler: str,
    lr_warmup_n_steps: int = 0,
    exp_gamma_after_n_steps: Optional[float] = None,
    exp_n_steps: Optional[float] = None,
    multistep_milestones: Optional[Sequence[int]] = None,
    multistep_gamma: float = 0.1,
    milestone_shift: int = 0,
) -> Callable:
    """Returns schedule(step) -> lr, a float32 tensor of the step's shape.
    ``milestone_shift`` is the sequential-view-increment milestone offset
    (reference train.py:452-453)."""
    W = int(lr_warmup_n_steps)
    f32 = torch.float32

    if main_scheduler == "constant":
        def main(t):
            return torch.ones_like(t)
    elif main_scheduler == "exponential":
        assert exp_gamma_after_n_steps is not None and exp_n_steps is not None
        gamma = float(exp_gamma_after_n_steps) ** (1.0 / float(exp_n_steps))

        def main(t):
            return torch.pow(torch.tensor(gamma, dtype=f32), t)
    elif main_scheduler == "multistep":
        assert multistep_milestones is not None
        milestones = torch.tensor([m + milestone_shift for m in multistep_milestones], dtype=f32)
        gamma = float(multistep_gamma)

        def main(t):
            # torch MultiStepLR: the factor after t steps is gamma^#{m : m <= t}.
            n_passed = (t[..., None] >= milestones).sum(-1).to(f32)
            return torch.pow(torch.tensor(gamma, dtype=f32), n_passed)
    else:
        raise NotImplementedError(f"Unknown LR scheduler: {main_scheduler}")

    def schedule(step):
        t = torch.as_tensor(step, dtype=f32)
        if W > 0:
            start = 1.0 / (W + 1)
            warm = start + (1.0 - start) * torch.clamp(t, max=float(W)) / W
        else:
            warm = torch.ones_like(t)
        factor = torch.where(t < W, warm, main(torch.clamp(t - W, min=0.0)))
        return base_lr * factor

    return schedule


def schedule_kwargs_from_conf(conf, milestone_shift: int = 0) -> dict:
    """:func:`build_lr_schedule`'s keyword arguments from a conf's
    ``train.lr`` and ``train.lr_schedule.*``, with the JAX package's
    defaults (``gasfm_tpu/train/schedules.py:75-86``, reference
    train.py:434-472)."""
    sub = "train.lr_schedule"
    return dict(
        base_lr=conf.get_float("train.lr"),
        main_scheduler=conf.get_string(f"{sub}.main_scheduler"),
        lr_warmup_n_steps=conf.get_int(f"{sub}.lr_warmup_n_steps", default=0),
        exp_gamma_after_n_steps=conf.get_float(f"{sub}.exp_gamma_after_n_steps", default=None),
        exp_n_steps=conf.get_float(f"{sub}.exp_n_steps", default=None),
        multistep_milestones=conf.get_list(f"{sub}.multistep_milestones", default=None),
        multistep_gamma=conf.get_float(f"{sub}.multistep_gamma", default=0.1),
        milestone_shift=milestone_shift,
    )


def schedule_from_conf(conf, milestone_shift: int = 0) -> Callable:
    """The LR schedule of a conf (the JAX package's ``schedule_from_conf``)."""
    return build_lr_schedule(**schedule_kwargs_from_conf(conf, milestone_shift))
