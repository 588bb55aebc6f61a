"""Optimizer construction: Adam with the per-batch LR schedule and optional
gradient clipping; checkpoints of a training session and weight files.

Counterpart of ``build_optimizer``, ``advance_schedule_count``,
``save_checkpoint`` / ``restore_checkpoint`` and ``save_params`` /
``load_params`` in the JAX package's train/state.py (reference:
torch.optim.Adam with default betas and eps, train.py:437; clipping by
global norm or by value before the update, train.py:141-151). The builder
takes the conf's values as keyword arguments, which :func:`optim_from_conf`
reads from a conf as the JAX package's ``build_optimizer`` does
(``gasfm_tpu/train/state.py:162-210``); ``FLAGSHIP_OPTIM`` holds those of
``confs/gasfm/optim_euc_gasfm.conf``, ``DPESFM_OPTIM`` those of
``confs/dpesfm/learning_euc_noaug_dpesfm.conf``.

Two counters, as in the JAX package: the schedule's count advances on every
batch (:meth:`Optimizer.advance_schedule` for a batch without an update),
Adam's own step count (bias correction) only on real updates. Update k
(counting batches from 0) uses lr = schedule(k).

The optimizer's state lives on the parameters' device, so that a CUDA graph
can record the update: Adam is PyTorch's fused one, its learning rate a 0-d
float32 tensor that :meth:`Optimizer.set_lr` fills from the schedule
(computed on the host) before each update, and its step count a tensor
(``adam.state[p]["step"]``). The same optimizer serves the CPU, the eager
card path and the captured one (``capturable`` on the card, which the CPU
refuses).

Checkpoints (:func:`save_checkpoint` / :func:`restore_checkpoint`) are the
port's own format, one ``torch.save`` file of tensors per step (no orbax):
the parameters, Adam's moments and step count, the schedule's count and the
caller's step. A restore copies into the session's existing tensors, so a
CUDA graph recorded on them stays valid. Weight files (:func:`save_params` /
:func:`load_params`) are the JAX package's flat npz under its flax key paths,
so either package loads the other's.

The bf16 first-moment / second-moment storage and the bf16-parameter
(f32 master) options of the JAX package are not ported yet: a conf that
sets ``train.adam_mu_dtype``, ``train.adam_nu_dtype`` or
``train.param_dtype`` to bf16 raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from gasfm_tpu_torch.train.schedules import build_lr_schedule, schedule_kwargs_from_conf

FLAGSHIP_OPTIM = dict(lr=1e-4, main_scheduler="exponential", lr_warmup_n_steps=2500,
                      exp_n_steps=35000, exp_gamma_after_n_steps=0.1, grad_clip_mode=None)
# The optimizer of confs/dpesfm/learning_euc_noaug_dpesfm.conf (:67-79, :117).
# (The exponential keys are the conf's too; the multistep schedule ignores them.)
DPESFM_OPTIM = dict(lr=1e-3, main_scheduler="multistep", lr_warmup_n_steps=0,
                    exp_n_steps=250000, exp_gamma_after_n_steps=0.1,
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
    reference's optimizer, fused) with the LR schedule and optional
    clipping. ``lr`` is the rate tensor Adam reads on every update."""

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
        device = self.params[0].device
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=device)
        self.adam = torch.optim.Adam(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                     fused=True, capturable=device.type == "cuda")
        self.schedule_count = 0  # batches seen, updates or not

    def lr_at(self, step: int) -> float:
        return float(self.schedule(step))

    def step(self, grads: Sequence[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads`` (one per parameter, in order), in place:
        set this batch's LR, clip, Adam, advance the schedule."""
        self.set_lr()
        self.apply(grads, norm)
        self.advance_schedule()

    def set_lr(self) -> None:
        """Fill :attr:`lr` with this batch's rate, schedule(schedule_count),
        computed on the host. Runs before every update, a CUDA graph's
        replay too: the graph reads the tensor."""
        self.lr.fill_(self.lr_at(self.schedule_count))

    def apply(self, grads: Sequence[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """Clip and take Adam's step with the rate in :attr:`lr`: device work
        only, which a CUDA graph can record. The ``p.grad`` assignments stay
        inside a recording: the graph reads the gradients at the addresses
        it was recorded with."""
        grads = clip_grads(list(grads), self.grad_clip_mode, self.grad_clip_th, norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        for p in self.params:
            p.grad = None

    def advance_schedule(self) -> None:
        """A batch without an update: the schedule steps, Adam's count does
        not. Also the last part of every update, on the host (a CUDA graph's
        replay runs it too)."""
        self.schedule_count += 1


def build_optimizer(params: Iterable[torch.nn.Parameter], **conf) -> Optimizer:
    """Adam + per-batch LR schedule + optional clipping from the conf's
    ``train.lr``, ``train.lr_schedule.*`` and ``loss.grad_clip_*`` values,
    given as keyword arguments (see :class:`Optimizer`)."""
    return Optimizer(params, **conf)


def optim_from_conf(conf, milestone_shift: int = 0) -> dict:
    """:class:`Optimizer`'s keyword arguments from a conf: ``train.lr``,
    ``train.lr_schedule.*`` (``milestone_shift`` added to the milestones),
    ``loss.grad_clip_mode`` (norm, value or null; another mode is an
    ``AssertionError``, as in the JAX package) and ``loss.grad_clip_th``.
    bf16 moments or parameters (``train.adam_mu_dtype``,
    ``train.adam_nu_dtype``, ``train.param_dtype``) raise
    ``NotImplementedError``: the port keeps Adam and the weights in float32
    and does not run another optimizer than the conf asks for."""
    for key in ("train.param_dtype", "train.adam_mu_dtype", "train.adam_nu_dtype"):
        if conf.get_string(key, default=None) == "bf16":
            raise NotImplementedError(f"{key} = bf16: the port keeps Adam's moments and the "
                                      f"parameters in float32 (bf16 storage is not ported yet)")
    kw = schedule_kwargs_from_conf(conf, milestone_shift)
    kw["lr"] = kw.pop("base_lr")
    mode = conf.get_string("loss.grad_clip_mode", default=None)
    threshold = None
    if mode is not None:
        threshold = conf.get_float("loss.grad_clip_th")
        if mode not in ("norm", "value"):
            raise AssertionError(f'Could not interpret gradient clipping mode "{mode}".')
    return dict(kw, grad_clip_mode=mode, grad_clip_th=threshold)


# ---------------------------------------------------------------------------
# Weight files (the JAX package's npz) and checkpoints (the port's own)
# ---------------------------------------------------------------------------


def save_params(path: str, model: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> None:
    """A flat npz of the model's weights (or of a ``state_dict`` of it) under
    the JAX package's keys (``"params/..."``, the ``"/"``-joined flax key
    paths its ``save_params`` writes), in flax's layouts: the JAX package's
    ``load_params`` restores it into its init of the same configuration."""
    from gasfm_tpu_torch.models.convert import params_to_jax

    flat = params_to_jax(model.state_dict() if isinstance(model, torch.nn.Module) else model)
    np.savez(path, **{f"params/{k}": v for k, v in flat.items()})


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a weight file written by either package's ``save_params`` into
    ``model`` in place, as the JAX package's ``load_params`` does (the
    reference's pretrained-weight loading, main.py:168-190): the keys the
    file lacks keep their init values, the file's keys that the model lacks
    (another model's heads) are ignored, both printed; a shape that differs
    raises."""
    from gasfm_tpu_torch.models.convert import params_from_jax

    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    state = params_from_jax(tree)
    own = model.state_dict()
    missing = [k for k in own if k not in state]
    extra = [k for k in state if k not in own]
    for k, v in state.items():
        if k in own and v.shape != own[k].shape:
            raise ValueError(f"{path}: shape mismatch for {k}: {tuple(v.shape)} vs "
                             f"{tuple(own[k].shape)}")
    if missing:
        print(f"[load_params] keeping init values for {len(missing)} missing keys "
              f"(e.g. {missing[:3]})")
    if extra:
        print(f"[load_params] ignoring {len(extra)} keys the model lacks (e.g. {extra[:3]})")
    model.load_state_dict({k: v for k, v in state.items() if k in own}, strict=False)
    return model


_CKPT = re.compile(r"step_(\d+)\.pt$")


def _checkpoints(ckpt_dir: str) -> Dict[int, str]:
    """{step: path} of the checkpoints in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return {}
    found = (_CKPT.fullmatch(name) for name in os.listdir(ckpt_dir))
    return {int(m.group(1)): os.path.join(ckpt_dir, m.group(0)) for m in found if m}


def _named_params(session) -> List:
    return [(k, p) for k, p in session.model.named_parameters() if p.requires_grad]


def save_checkpoint(ckpt_dir: str, session, step: int, keep: int = 3,
                    meta: Optional[Dict[str, int]] = None) -> str:
    """Write the session's training state as ``<ckpt_dir>/step_<step>.pt``
    (``torch.save`` of tensors on the CPU): the parameters, Adam's moments
    and step count, the schedule's count, ``step`` (the caller's: an
    epoch or an update count) and the caller's integer counters ``meta``.
    Keeps the newest ``keep`` checkpoints. Returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    adam = session.optimizer.adam.state
    state = {
        "step": int(step),
        "meta": {k: int(v) for k, v in (meta or {}).items()},
        "schedule_count": int(session.optimizer.schedule_count),
        "params": {k: p.detach().cpu() for k, p in _named_params(session)},
        "adam": {k: {n: t.detach().cpu() for n, t in adam[p].items()}
                 for k, p in _named_params(session) if p in adam},
    }
    path = os.path.join(ckpt_dir, f"step_{int(step):09d}.pt")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    found = _checkpoints(ckpt_dir)
    for old in sorted(found)[:-keep]:
        os.remove(found[old])
    return path


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, session, step: Optional[int] = None,
                       meta: Optional[Dict[str, int]] = None) -> Optional[int]:
    """Restore the checkpoint of ``step`` (the newest by default) into
    ``session``, copying into its existing tensors (the parameters, Adam's
    moments and step count; Adam's state is made first where the session has
    taken no step, zeroed where the checkpoint's had taken none), so a CUDA
    graph recorded on them stays valid; and the schedule's count. The
    checkpoint's counters are copied into ``meta`` where one is given.
    Returns the checkpoint's step, or None where ``ckpt_dir`` holds none."""
    found = _checkpoints(ckpt_dir)
    if not found:
        return None
    step = max(found) if step is None else int(step)
    state = torch.load(found[step], weights_only=True)
    named = _named_params(session)
    if sorted(state["params"]) != sorted(k for k, _ in named):
        raise KeyError(f"{found[step]}: its parameters are not the session's")
    adam = session.optimizer.adam.state
    for k, p in named:
        p.copy_(state["params"][k])
        saved = state["adam"].get(k)
        if saved is None:  # saved before any update: Adam's state is all zeros
            for t in adam[p].values() if p in adam else ():
                t.zero_()
            continue
        if p not in adam:  # Adam's own layout: moments like p, step a 0-d float32 on p's device
            adam[p] = {n: torch.zeros_like(t, device=p.device) for n, t in saved.items()}
        for n, t in saved.items():
            adam[p][n].copy_(t)
    session.optimizer.schedule_count = int(state["schedule_count"])
    if meta is not None:
        meta.update(state.get("meta", {}))
    return int(state["step"])
