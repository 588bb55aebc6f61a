"""Adam (b1 0.9, b2 0.999, eps 1e-8) with the per-batch learning-rate
schedule of the configurations, in plain PyTorch.

Schedule of update t (counting from 0): a linear warm-up over W steps,
``lr * (1/(W+1) + (1 - 1/(W+1)) * t/W)``, then exponential decay
``lr * gamma^(t-W)`` with ``gamma = rate^(1/steps)``, or multistep
``lr * gamma^#{milestones <= t-W}``; computed in float32.
"""

from __future__ import annotations

from typing import List

import torch


def learning_rate(train_conf: dict, t: int) -> float:
    sched = train_conf["lr_schedule"]
    base = torch.tensor(float(train_conf["lr"]), dtype=torch.float32)
    W = int(sched.get("lr_warmup_n_steps", 0))
    tt = torch.tensor(float(t), dtype=torch.float32)
    if t < W:
        start = 1.0 / (W + 1)
        return float(base * (start + (1.0 - start) * tt / W))
    after = tt - W
    kind = sched["main_scheduler"]
    if kind == "exponential":
        gamma = float(sched["exp_gamma_after_n_steps"]) ** (1.0 / float(sched["exp_n_steps"]))
        factor = torch.pow(torch.tensor(gamma, dtype=torch.float32), after)
    elif kind == "multistep":
        passed = sum(1 for m in sched["multistep_milestones"] if m <= float(after))
        factor = torch.pow(torch.tensor(float(sched["multistep_gamma"]), dtype=torch.float32),
                           torch.tensor(float(passed)))
    elif kind == "constant":
        factor = torch.tensor(1.0)
    else:
        raise NotImplementedError(f"the reference has no scheduler {kind!r}")
    return float(base * factor)


class Adam:
    def __init__(self, params: List[torch.Tensor], b1=0.9, b2=0.999, eps=1e-8):
        self.params = params
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr / c1 * m / (v.sqrt() / c2 ** 0.5 + self.eps))
