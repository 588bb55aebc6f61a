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

Mixed precision (the JAX package's ``train.adam_mu_dtype``,
``train.adam_nu_dtype`` and ``train.param_dtype``, :29-156): with any of
them bf16, Adam is the port's own multi-tensor kernel
(``ops/kernels/adam.py``, ``csrc/adam.cu``) with its state on the device
(:class:`~gasfm_tpu_torch.ops.kernels.adam.AdamBuffers`): the int32 count,
the moments in their dtypes and, with bf16 weights, the f32 master, whose
bf16 rounding the model's parameters receive in place after each update
(the JAX wrapper's "updates are the new params", so a recorded graph stays
valid). Clipping keeps its place in the chain; with bf16 weights it acts on
the f32 upcast of the bf16 gradients. The float32 default stays on
PyTorch's fused Adam. Weight files carry bf16 leaves as the JAX package's
``np.savez`` of ``ml_dtypes`` bfloat16 arrays stores them (``|V2``, raw
bfloat16 bits); checkpoints hold the master, the moments and the count in
their dtypes.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from gasfm_tpu_torch.ops.kernels.adam import AdamBuffers, adam_update
from gasfm_tpu_torch.train.schedules import build_lr_schedule, schedule_kwargs_from_conf

FLAGSHIP_OPTIM = dict(lr=1e-4, main_scheduler="exponential", lr_warmup_n_steps=2500,
                      exp_n_steps=35000, exp_gamma_after_n_steps=0.1, grad_clip_mode=None)
# The optimizer of confs/dpesfm/learning_euc_noaug_dpesfm.conf (:67-79, :117).
# (The exponential keys are the conf's too; the multistep schedule ignores them.)
DPESFM_OPTIM = dict(lr=1e-3, main_scheduler="multistep", lr_warmup_n_steps=0,
                    exp_n_steps=250000, exp_gamma_after_n_steps=0.1,
                    multistep_milestones=[60000], multistep_gamma=0.5, grad_clip_mode=None)


DTYPES = {"bf16": torch.bfloat16}  # the conf's dtype names; any other value is float32


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares of every element of every tensor) — optax's
    ``global_norm``, as a 0-d tensor (no host synchronisation); in float32
    for bf16 gradients (the norm that clipping takes under the f32 master)."""
    grads = list(grads)
    if all(g.dtype == torch.float32 for g in grads):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2, torch.float32)))


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


def cast_params_for_training(model: torch.nn.Module, param_dtype: Optional[str]
                              ) -> torch.nn.Module:
    """``train.param_dtype``: with "bf16" the model's weights become bf16
    in place, before the optimizer is built (the JAX package's
    ``cast_params_for_training``, train/state.py:149); otherwise unchanged."""
    if param_dtype == "bf16":
        model.to(torch.bfloat16)
    return model


class Optimizer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with the LR schedule and optional
    clipping. ``lr`` is the rate tensor Adam reads on every update. In
    float32 (the default) Adam is ``torch.optim.Adam``, the reference's
    optimizer, fused (:attr:`adam`); with ``mu_dtype``, ``nu_dtype`` or
    ``param_dtype`` "bf16" it is the port's kernel on :attr:`buffers`
    (:mod:`~gasfm_tpu_torch.ops.kernels.adam`), and with ``param_dtype``
    "bf16" the parameters must be bf16 already
    (:func:`cast_params_for_training`)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, main_scheduler: str,
                 lr_warmup_n_steps: int = 0, exp_gamma_after_n_steps: Optional[float] = None,
                 exp_n_steps: Optional[float] = None,
                 multistep_milestones: Optional[Sequence[int]] = None,
                 multistep_gamma: float = 0.1, milestone_shift: int = 0,
                 grad_clip_mode: Optional[str] = None, grad_clip_th: Optional[float] = None,
                 mu_dtype: Optional[str] = None, nu_dtype: Optional[str] = None,
                 param_dtype: Optional[str] = None):
        self.params = list(params)
        self.schedule = build_lr_schedule(
            lr, main_scheduler, lr_warmup_n_steps, exp_gamma_after_n_steps, exp_n_steps,
            multistep_milestones, multistep_gamma, milestone_shift)
        if grad_clip_mode is not None and grad_clip_th is None:
            raise ValueError("grad_clip_mode needs grad_clip_th")
        self.grad_clip_mode, self.grad_clip_th = grad_clip_mode, grad_clip_th
        device = self.params[0].device
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=device)
        self.adam: Optional[torch.optim.Adam] = None
        self.buffers: Optional[AdamBuffers] = None
        if (mu_dtype, nu_dtype, param_dtype) == (None, None, None):
            self.adam = torch.optim.Adam(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                         fused=True, capturable=device.type == "cuda")
        else:
            self.buffers = AdamBuffers(self.params, DTYPES.get(mu_dtype, torch.float32),
                                       DTYPES.get(nu_dtype, torch.float32),
                                       master=param_dtype == "bf16")
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
        it was recorded with. The kernel's path clips the f32 upcast of bf16
        gradients, and without clipping reads them as they are."""
        if self.buffers is not None:
            grads = list(grads)
            if self.grad_clip_mode is not None:
                grads = clip_grads([g.float() for g in grads], self.grad_clip_mode,
                                   self.grad_clip_th, norm)
            adam_update(grads, self.buffers, self.lr)
            return
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
    ``AssertionError``, as in the JAX package) and ``loss.grad_clip_th``;
    and ``mu_dtype`` / ``nu_dtype`` / ``param_dtype`` "bf16" where
    ``train.adam_mu_dtype`` / ``train.adam_nu_dtype`` / ``train.param_dtype``
    is bf16 (another value is float32, as in the JAX package, and leaves the
    key out)."""
    kw = schedule_kwargs_from_conf(conf, milestone_shift)
    for name in ("mu_dtype", "nu_dtype", "param_dtype"):
        key = f"train.{'adam_' if name != 'param_dtype' else ''}{name}"
        if conf.get_string(key, default=None) == "bf16":
            kw[name] = "bf16"
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
    and step count (with bf16 options: the kernel's count, moments and f32
    master, in their dtypes), the schedule's count, ``step`` (the caller's: an
    epoch or an update count) and the caller's integer counters ``meta``.
    Keeps the newest ``keep`` checkpoints. Returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    opt = session.optimizer
    named = _named_params(session)
    state = {
        "step": int(step),
        "meta": {k: int(v) for k, v in (meta or {}).items()},
        "schedule_count": int(opt.schedule_count),
        "params": {k: p.detach().cpu() for k, p in named},
    }
    if opt.adam is not None:
        adam = opt.adam.state
        state["adam"] = {k: {n: t.detach().cpu() for n, t in adam[p].items()}
                         for k, p in named if p in adam}
    else:  # the kernel's state, each tensor in its dtype
        buf = opt.buffers
        state["mixed"] = {
            "count": buf.count.cpu(),
            "mu": {k: t.cpu() for (k, _), t in zip(named, buf.mu)},
            "nu": {k: t.cpu() for (k, _), t in zip(named, buf.nu)},
            "master": {k: t.cpu() for (k, _), t in zip(named, buf.params)} if buf.master else {},
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
    taken no step, zeroed where the checkpoint's had taken none; with bf16
    options the kernel's count, moments and master), so a CUDA
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
    opt = session.optimizer
    if ("adam" in state) != (opt.adam is not None):
        raise ValueError(f"{found[step]}: written by another optimizer (fused float32 Adam "
                         f"or the bf16 options' kernel) than the session's")
    if opt.adam is None:
        buf, saved = opt.buffers, state["mixed"]
        for i, (k, p) in enumerate(named):
            p.copy_(state["params"][k])
            buf.mu[i].copy_(saved["mu"][k])
            buf.nu[i].copy_(saved["nu"][k])
            if buf.master:
                buf.params[i].copy_(saved["master"][k])
        buf.count.copy_(saved["count"])
    else:
        adam = opt.adam.state
        for k, p in named:
            p.copy_(state["params"][k])
            saved = state["adam"].get(k)
            if saved is None:  # saved before any update: Adam's state is all zeros
                for t in adam[p].values() if p in adam else ():
                    t.zero_()
                continue
            if p not in adam:  # Adam's own layout: moments like p, step a 0-d float32
                adam[p] = {n: torch.zeros_like(t, device=p.device) for n, t in saved.items()}
            for n, t in saved.items():
                adam[p][n].copy_(t)
    session.optimizer.schedule_count = int(state["schedule_count"])
    if meta is not None:
        meta.update(state.get("meta", {}))
    return int(state["step"])
