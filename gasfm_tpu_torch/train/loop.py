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

On the card the session records its steps as CUDA graphs (``capture``, on by
default there), the counterpart of the JAX package's jitted step
(``jax.jit(_fused_step)``, train/loop.py:236; ``_grad_fn`` and
``_update_fn``, :181 and :204, for the depth models): per scene, the first
call of ``fused_step`` (or ``loss_and_grads``) runs eagerly on the session's
capture stream, a real step as a jitted function's first call is; the second
records the step into a graph and replays it; later calls replay it, one
launch for the ~3,000 kernels of a step. The host keeps only what changes
from step to step: it fills the learning-rate tensor before each step and
advances the schedule's count after it. ``update`` is recorded the same way,
once per set of gradients it is given: a captured ``loss_and_grads``' own
gradients are read where that graph leaves them; other gradients are copied
into the update graph's own inputs first. A kernel's ``launches`` counter
counts a recording once and a replay not at all.

The evaluation forward is recorded the same way, the counterpart of the JAX
package's ``_fwd_fn = jax.jit(model.apply)`` (train/loop.py:182): per scene
the first ``forward`` runs eagerly on the capture stream, the second records
and replays, later ones replay; the graph reads the parameters where they
lie, so a replay after training steps sees the updated weights, and a
replay's predictions are copies. Recorded under ``no_grad``, the kernels
take their variants that write no softmax residuals. ``loss`` stays eager,
as the JAX package takes no loss inside its jitted forward.

:meth:`TrainingSession.from_conf` builds the session from a conf as the JAX
package's ``TrainingSession(conf, model, milestone_shift)`` does
(train/loop.py:156-160): the loss of ``loss.func`` and the optimizer of
``train.*`` and ``loss.grad_clip_*``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from gasfm_tpu_torch.eval.metrics import core_errors_device
from gasfm_tpu_torch.losses import DirectDepthLoss, ESFMLoss, get_loss_func
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
from gasfm_tpu_torch.train.state import (FLAGSHIP_OPTIM, build_optimizer, global_norm,
                                         optim_from_conf)
from gasfm_tpu_torch.utils.device import resolve_device


class _Program:
    """A function of the session recorded as one CUDA graph: the first call
    runs it eagerly on the capture stream, the second records it on its
    arguments and replays the recording, later calls replay it (their
    arguments are ignored: the graph reads the recorded ones where they
    lie). ``keep`` holds the tensors the recording reads (the scene), so
    that their addresses stay valid while the graph lives."""

    def __init__(self, fn: Callable, stream: "torch.cuda.Stream", keep=None):
        self.fn, self.stream, self.keep = fn, stream, keep
        self.calls = 0
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.out = None

    def __call__(self, *args):
        self.calls += 1
        if self.graph is not None:
            self.graph.replay()
            return self.out
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        if self.calls == 1:
            # the warm-up: every lazily built operand of the step (the
            # graph's splits, the loss's ticket counter, Adam's state, the
            # BLAS workspaces of this stream) is made here, outside the
            # recording
            with torch.cuda.stream(self.stream):
                out = self.fn(*args)
            main.wait_stream(self.stream)
            return out
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            out = self.fn(*args)
        self.graph, self.out = graph, out
        graph.replay()
        return out


class TrainingSession:
    """Holds a model (GASFM's ``GraphAttnSfMNet`` or DPESFM's
    ``SetOfSetNet``), its loss and its optimizer on one device (``cuda``
    unless the caller passes ``device="cpu"``; raises when CUDA is asked for
    and absent). ``optim``: :func:`~gasfm_tpu_torch.train.state.build_optimizer`'s
    keyword arguments, the flagship conf's by default. ``capture``: record
    the training steps as CUDA graphs (see the module docstring); on by
    default for a CUDA session, and refused for a CPU one."""

    def __init__(self, model: Union[GraphAttnSfMNet, SetOfSetNet],
                 loss_func: Union[ESFMLoss, DirectDepthLoss],
                 device: Optional[Union[str, torch.device]] = None,
                 optim: Optional[dict] = None, capture: Optional[bool] = None):
        self.device = resolve_device(device)
        if capture is None:
            capture = self.device.type == "cuda"
        elif capture and self.device.type != "cuda":
            raise ValueError(f"capture=True records CUDA graphs; this session runs on "
                             f"{self.device}")
        self.capture = capture
        self.model = model.to(self.device)
        self.loss_func = loss_func
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = build_optimizer(self.params, **(optim or FLAGSHIP_OPTIM))
        self._stream = torch.cuda.Stream(self.device) if capture else None
        self._programs: Dict[tuple, _Program] = {}
        self._update_inputs: Optional[List[torch.Tensor]] = None

    @classmethod
    def from_conf(cls, conf, model: Union[GraphAttnSfMNet, SetOfSetNet],
                  milestone_shift: int = 0, device: Optional[Union[str, torch.device]] = None,
                  capture: Optional[bool] = None) -> "TrainingSession":
        """The session of a conf: ``get_loss_func(conf)`` and the optimizer
        of ``optim_from_conf(conf, milestone_shift)``. A
        ``parallel.mesh_shape`` of more than one device raises
        ``NotImplementedError``: the port runs on one device, and does not
        run another layout than the conf asks for."""
        mesh = conf.get_list("parallel.mesh_shape", default=None)
        if mesh is not None and math.prod(int(d) for d in mesh) > 1:
            raise NotImplementedError(f"parallel.mesh_shape = {mesh}: the port runs on one "
                                      f"device (multi-device execution is not ported yet)")
        return cls(model, get_loss_func(conf), device=device,
                   optim=optim_from_conf(conf, milestone_shift), capture=capture)

    def _program(self, key: tuple, fn: Callable, keep=None) -> _Program:
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program(fn, self._stream, keep)
        return prog

    def _forward(self, scene, plain: bool = False) -> Dict[str, torch.Tensor]:
        return self.model(scene.graph, plain=plain)

    @torch.no_grad()
    def forward(self, scene, plain: bool = False) -> Dict[str, torch.Tensor]:
        """Predicted ``Ps_norm`` (m, 3, 4) and ``pts3D`` (4, n), or with the
        depth head ``depths`` (E,), for a
        :class:`~gasfm_tpu_torch.graph.view_graph.SceneGraph` on this
        session's device. ``plain=True`` runs the kernels' plain versions
        (for comparing the two on the card), eagerly. Captured, the forward
        replays this scene's recording and the predictions are copies of
        its outputs."""
        if plain or not self.capture:
            return self._forward(scene, plain)
        pred = self._program(("forward", id(scene)), self._forward, keep=scene)(scene)
        return {k: v.clone() for k, v in pred.items()}

    @torch.no_grad()
    def loss(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        return self.loss_func(pred, scene, plain=plain)

    def _loss_and_grads(self, scene, plain: bool = False):
        with torch.enable_grad():
            pred = self.model(scene.graph, plain=plain)
            loss = self.loss_func(pred, scene, plain=plain)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        # contiguous: the kernels' weight gradients can be views of one sums
        # buffer, and PyTorch's multi-tensor Adam and norm fall back to one
        # kernel per tensor when a gradient is not contiguous; the zeros of
        # unused parameters are made inside a recording too
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for p, g in zip(self.params, grads)]
        return loss.detach(), {k: v.detach() for k, v in pred.items()}, grads

    def loss_and_grads(self, scene, plain: bool = False
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
        """(loss, predictions, one gradient per parameter): forward and
        backward through the kernels (their plain versions with ``plain``).
        Parameters a configuration leaves unused get zero gradients, as
        optax treats them. Captured, the loss and predictions are copies;
        the gradients are the graph's own outputs, which its next replay
        overwrites (``update`` reads them there)."""
        if plain or not self.capture:
            return self._loss_and_grads(scene, plain)
        prog = self._program(("loss_and_grads", id(scene)), self._loss_and_grads, keep=scene)
        loss, pred, grads = prog(scene)
        return loss.clone(), {k: v.clone() for k, v in pred.items()}, grads

    def _update(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        norm = global_norm(grads)
        self.optimizer.apply(grads, norm)
        return norm

    def update(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """One optimizer step from ``grads`` (in place); returns their global
        norm before clipping."""
        self.optimizer.set_lr()
        if not self.capture:
            norm = self._update(grads)
        else:
            norm = self._captured_update(grads).clone()
        self.optimizer.advance_schedule()
        return norm

    def _captured_update(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The update's recording that reads ``grads`` where they lie when
        they are a recorded ``loss_and_grads``' outputs, else the one that
        reads the session's own input buffers, ``grads`` copied in first
        (its eager warm-up reads them where they lie)."""
        for key, prog in self._programs.items():
            if key[0] == "loss_and_grads" and prog.out is not None and all(
                    a is b for a, b in zip(prog.out[2], grads)):
                return self._program(("update", key[1]), self._update, keep=grads)(grads)
        prog = self._program(("update", None), self._update)
        if prog.calls:
            if self._update_inputs is None:
                self._update_inputs = [torch.empty_like(p) for p in self.params]
            torch._foreach_copy_(self._update_inputs, list(grads))
            grads = self._update_inputs
        return prog(grads)

    def advance_schedule(self) -> None:
        """Step only the LR schedule (a batch without valid samples)."""
        self.optimizer.advance_schedule()

    def lr_at(self, step: int) -> float:
        return self.optimizer.lr_at(step)

    def _fused_step(self, scene, plain: bool = False):
        loss, pred, grads = self._loss_and_grads(scene, plain)
        grad_norm = self._update(grads)
        with torch.no_grad():
            repro = core_errors_device(pred, scene, plain=plain)["our_repro"]
        return loss, repro, grad_norm

    def fused_step(self, scene, plain: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One training step on ``scene``: updates the model's parameters and
        the optimizer state in place and returns (loss, our_repro,
        grad_norm) as 0-d tensors on the device, without synchronising.
        ``our_repro`` is that of the predictions the loss was taken on.
        ``plain=True`` runs the kernels' plain versions throughout, eagerly.
        Captured, the step replays this scene's graph and the three values
        are copies of its outputs. Needs a model with the view and
        scenepoint heads."""
        if self.model.depth_head_enabled:
            raise ValueError("fused_step takes our_repro of the view and scenepoint heads' "
                             "predictions; a depth-head model trains through loss_and_grads "
                             "and update")
        self.optimizer.set_lr()
        if plain or not self.capture:
            out = self._fused_step(scene, plain)
        else:
            prog = self._program(("fused_step", id(scene)), self._fused_step, keep=scene)
            out = tuple(torch.stack(prog(scene)).unbind())
        self.optimizer.advance_schedule()
        return out
