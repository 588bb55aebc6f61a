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

The drivers (the JAX package's train/loop.py :313-1173, reference
code/train.py) run a session: ``epoch_train`` (one epoch: the fused step
where the heads allow it, else ``loss_and_grads`` per sample, their
gradients summed, and ``update``), ``epoch_evaluation`` (the recorded
forward, then the host metric battery and bundle adjustment of
``eval/metrics.py``) and ``train`` (the epochs with their evaluations, the
best weights in multi-scene learning, dumps, checkpoints and the final
weights). Where the JAX package builds a new padded graph for every batch
and returns new parameters, the port trains the session's model in place
and keeps one graph per :class:`~gasfm_tpu_torch.data.scene.SceneData` while
the caller keeps the scene (:meth:`TrainingSession.scene_graph`): a fixed
scene (a single scene's epochs, the evaluation sets) replays its recordings
from its third call on; a scene used once (a sampled subscene, a scene with
outliers injected) runs eagerly, records nothing, and its graph goes when
the caller drops it. A step's scalars are copied to the host behind the
step and read after the next step has been dispatched (across epochs too: a
single scene's epoch is one step), so the host never waits for the step it
has just launched. In multi-scene learning the samples' host work (sampling,
augmentation, validity, outliers, the graph's host half) runs on a prefetch
thread; the upload runs on the caller's.
"""

from __future__ import annotations

import functools
import math
import os
import weakref
from time import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gasfm_tpu_torch.eval.metrics import (compute_core_errors, compute_errors,
                                          core_errors_device, get_dummy_errors,
                                          predictions_to_host, prepare_predictions)
from gasfm_tpu_torch.losses import DirectDepthLoss, ESFMLoss, get_loss_func
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
from gasfm_tpu_torch.train.state import (FLAGSHIP_OPTIM, build_optimizer, global_norm,
                                         optim_from_conf, restore_checkpoint, save_checkpoint,
                                         save_params)
from gasfm_tpu_torch.utils import paths
from gasfm_tpu_torch.utils.device import resolve_device
from gasfm_tpu_torch.utils.observability import (ProfilerWindow, dump_predictions, get_tb_writer,
                                                 tb_log_eval_step, tb_log_train_step)
from gasfm_tpu_torch.utils.phases import Phases
from gasfm_tpu_torch.utils.tables import Table


def _eager_on(stream: "torch.cuda.Stream", fn: Callable, *args):
    """``fn(*args)`` eagerly on ``stream``, ordered after the current
    stream's work and before its later work: a function's warm-up, on the
    stream its recording will use, so that every lazily built operand (the
    loss's ticket counter, Adam's state, the BLAS workspaces of this stream)
    exists before a recording."""
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        out = fn(*args)
    main.wait_stream(stream)
    return out


class _Program:
    """A function of the session recorded as one CUDA graph on ``args``
    (made at the function's second call on the same operands; the first ran
    :func:`_eager_on`); a call replays it and returns the recorded outputs
    (the graph reads the recorded operands where they lie). ``keep`` holds
    the tensors the recording reads (the scene), so that their addresses
    stay valid while the graph lives."""

    def __init__(self, fn: Callable, stream: "torch.cuda.Stream", args: tuple, keep=None):
        self.keep = keep
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = fn(*args)

    def __call__(self):
        self.graph.replay()
        return self.out


class _Calls:
    """What a session keeps for one set of operands (a scene graph, or its
    own update inputs): the kinds of call whose warm-up ran, and their
    recordings."""

    def __init__(self, ref: Optional["weakref.ref"] = None):
        self.ref = ref
        self.warm: set = set()
        self.programs: Dict[str, _Program] = {}


class _SceneCache:
    """A session's scene graphs and per-scene recordings, bounded by the
    scenes' lives. ``graphs`` maps a live :class:`SceneData` (by id) to its
    graph: a ``weakref.finalize`` on the SceneData drops the graph and every
    recording keyed on it when the caller drops the scene. ``calls`` maps a
    live scene graph (by id) to its :class:`_Calls`: a weak reference's
    callback drops the entry when the graph dies, so an id is never looked
    up after its object is gone (CPython reuses them). The callbacks hold
    the cache weakly: a dropped session leaves nothing behind."""

    def __init__(self):
        self.graphs: Dict[int, Any] = {}
        self.calls: Dict[int, _Calls] = {}

    def graph_of(self, data, device: torch.device):
        graph = self.graphs.get(id(data))
        if graph is None:
            graph = self.graphs[id(data)] = data.to_scene_graph(device=device)
            weakref.finalize(data, _SceneCache._drop_scene, weakref.ref(self), id(data),
                             id(graph))
        return graph

    def of(self, scene) -> _Calls:
        calls = self.calls.get(id(scene))
        if calls is None or calls.ref() is not scene:
            ref = weakref.ref(scene, functools.partial(_SceneCache._drop_graph,
                                                       weakref.ref(self), id(scene)))
            calls = self.calls[id(scene)] = _Calls(ref)
        return calls

    @staticmethod
    def _drop_scene(cache_ref, data_key: int, graph_key: int) -> None:
        cache = cache_ref()
        if cache is not None and cache.graphs.pop(data_key, None) is not None:
            cache.calls.pop(graph_key, None)

    @staticmethod
    def _drop_graph(cache_ref, graph_key: int, ref) -> None:
        cache = cache_ref()
        if cache is not None and graph_key in cache.calls and cache.calls[graph_key].ref is ref:
            del cache.calls[graph_key]


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
        self._cache = _SceneCache()
        self._own = _Calls()  # the update on the session's own input buffers
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

    def scene_graph(self, data):
        """The :class:`~gasfm_tpu_torch.graph.view_graph.SceneGraph` of a
        :class:`~gasfm_tpu_torch.data.scene.SceneData` on this session's
        device, built (uploaded from ``data.host_graph()``) at the first
        request and kept while the caller keeps ``data``: the same scene
        object gets the same graph, whose recordings replay. When the caller
        drops ``data`` the graph goes, with every recording that reads it."""
        return self._cache.graph_of(data, self.device)

    def recordings(self) -> List[Tuple[str, Any]]:
        """(kind, scene graph) of every recording the session holds, kind
        one of ``forward``, ``fused_step``, ``loss_and_grads``, ``update``;
        the scene None for the update on the session's own inputs."""
        out = [(kind, c.ref()) for c in list(self._cache.calls.values()) for kind in c.programs]
        return out + [(kind, None) for kind in self._own.programs]

    def close(self) -> None:
        """Release what the session holds besides its model: graphs,
        recordings, optimizer state, input buffers. The session cannot be
        used after."""
        self._cache = self._own = self._update_inputs = self.optimizer = None

    def weights(self) -> Dict[str, torch.Tensor]:
        """A copy of the model's ``state_dict`` on the CPU."""
        return {k: v.detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()}

    @torch.no_grad()
    def load_weights(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy ``state`` (a ``state_dict`` of this model, on any device) into
        the model's own tensors, so the recordings that read them stay
        valid."""
        own = self.model.state_dict()
        if set(own) != set(state):
            raise KeyError(f"the weights' keys are not the model's: "
                           f"{sorted(set(own) ^ set(state))[:5]}")
        for k, v in state.items():
            own[k].copy_(v)

    def _recorded(self, calls: _Calls, kind: str, fn: Callable, args: tuple, keep=None):
        """``fn(*args)`` for the operands of ``calls``: the first call of
        ``kind`` runs eagerly on the capture stream and leaves no recording;
        the second records it and replays; later ones replay."""
        prog = calls.programs.get(kind)
        if prog is None:
            if kind not in calls.warm:
                calls.warm.add(kind)
                return _eager_on(self._stream, fn, *args)
            prog = calls.programs[kind] = _Program(fn, self._stream, args, keep)
        return prog()

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
        pred = self._recorded(self._cache.of(scene), "forward", self._forward, (scene,), scene)
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
        loss, pred, grads = self._recorded(self._cache.of(scene), "loss_and_grads",
                                           self._loss_and_grads, (scene,), scene)
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
        they are a recorded ``loss_and_grads``' outputs (it goes with that
        scene), else the one that reads the session's own input buffers,
        ``grads`` copied in first (its eager warm-up reads them where they
        lie)."""
        for calls in list(self._cache.calls.values()):
            prog = calls.programs.get("loss_and_grads")
            if prog is not None and all(a is b for a, b in zip(prog.out[2], grads)):
                return self._recorded(calls, "update", self._update, (grads,), grads)
        if "update" in self._own.warm:
            if self._update_inputs is None:
                self._update_inputs = [torch.empty_like(p) for p in self.params]
            torch._foreach_copy_(self._update_inputs, list(grads))
            grads = self._update_inputs
        return self._recorded(self._own, "update", self._update, (grads,))

    def accumulate(self, grads_a: List[torch.Tensor], grads_b: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """The sum of two lists of gradients, in new tensors (the JAX
        package's ``accumulate``, train/loop.py:297): neither input is held,
        so a recorded ``loss_and_grads``' outputs may be overwritten by its
        next replay."""
        return list(torch._foreach_add(list(grads_a), list(grads_b)))

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
            out = self._recorded(self._cache.of(scene), "fused_step", self._fused_step, (scene,),
                                 scene)
            out = tuple(torch.stack(out).unbind())
        self.optimizer.advance_schedule()
        return out


# ---------------------------------------------------------------------------
# The drivers: one epoch of training, one evaluation pass, the controller
# ---------------------------------------------------------------------------

def _is_oom_error(e: BaseException) -> bool:
    """A device out-of-memory error (the JAX package's reads XLA's
    RESOURCE_EXHAUSTED; train/loop.py:59)."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _HostScalars:
    """A step's scalars (0-d tensors, or floats already on the host) on their
    way to the host: on the card they are copied into pinned memory behind
    the step, on the device's stream, and an event marks the copy, so
    :meth:`get` waits for that step only, not for the steps launched since
    (the JAX package's ``copy_to_host_async`` + a later fetch,
    train/loop.py:382-430)."""

    def __init__(self, values: Sequence[Union[torch.Tensor, float]]):
        self.values = list(values)
        tensors = [v for v in self.values if isinstance(v, torch.Tensor)]
        self.buf = self.event = None
        if tensors and tensors[0].device.type == "cuda":
            stacked = torch.stack([t.detach().float().reshape(()) for t in tensors])
            self.buf = torch.empty(len(tensors), dtype=torch.float32, pin_memory=True)
            self.buf.copy_(stacked, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> List[float]:
        if self.event is None:
            return [float(v) for v in self.values]
        self.event.synchronize()
        fetched = iter(self.buf.tolist())
        return [next(fetched) if isinstance(v, torch.Tensor) else float(v) for v in self.values]


def _prepare_batches(train_loader, outlier_injection_rate: Optional[float],
                     rng: Optional[np.random.Generator], epoch: int, depth: int):
    """The loader's batches, each as a list of (scene, the scene the model
    takes, or None for a skipped sample): the validity check, the outlier
    injection (a failed one skips the sample) and the host half of the
    model's scene's graph (``SceneData.host_graph``), on one prefetch thread
    with ``depth`` batches in flight (the JAX package's ``_prepare_batches``,
    train/loop.py:313; ``depth`` 0 runs them inline). numpy only: the
    upload is the caller's, on its own thread. The generator's draws stay
    in one thread, in the loader's order."""
    from gasfm_tpu_torch.data.dataset import prefetch_iter
    from gasfm_tpu_torch.data.outliers import inject_outliers

    def _source():
        for train_batch in train_loader:
            prepared = []
            for curr_data in train_batch:
                if not curr_data.is_valid_sample():
                    print(f"{epoch} {curr_data.scene_name} has a camera with not enough "
                          "points or a point with not enough cameras")
                    prepared.append((curr_data, None))
                    continue
                model_data = curr_data
                if outlier_injection_rate is not None:
                    model_data = inject_outliers(curr_data, outlier_injection_rate, rng=rng)
                    if model_data is None:
                        print(f"Failed outlier sampling for {curr_data.scene_name} - "
                              "skipping training sample.")
                        prepared.append((curr_data, None))
                        continue
                model_data.host_graph()
                prepared.append((curr_data, model_data))
            yield prepared

    if depth <= 0:
        yield from _source()
    else:
        yield from prefetch_iter(_source, depth)


def epoch_train(
    conf,
    session: TrainingSession,
    train_loader,
    n_updates: int,
    epoch: int,
    phase: Phases,
    tb_writer,
    outlier_injection_rate: Optional[float] = None,
    additional_identifiers: Optional[List[str]] = None,
    scene: Optional[str] = None,
    prev_n_batches: int = 0,
    tb_log_train_per_scene: Optional[bool] = True,
    rng: Optional[np.random.Generator] = None,
    carried: Optional[dict] = None,
    keep_last: bool = False,
):
    """One epoch over ``train_loader`` (the JAX package's
    train/loop.py:313-565; reference train.py:49-157), updating the
    session's model in place. The samples come through
    :func:`_prepare_batches`, on a prefetch thread in the ``TRAINING``
    phase (a single scene's epoch is one batch of the same scene: there it
    runs inline). A batch of one valid sample takes the fused step when the
    conf has both explicit heads, no backprojection metric and no outlier
    injection (the JAX package's ``device_metrics``); otherwise each valid
    sample takes ``loss_and_grads`` (``our_repro`` on the device with
    ``device_metrics``, else the host metrics the conf asks for, scored
    against the clean observations), their gradients summed
    (``accumulate``), then one ``update``. A batch without a valid sample
    steps only the schedule.

    A batch's scalars are read, and logged, once the next batch has been
    dispatched. A single scene's epoch is one batch, so the deferral also
    spans epochs: with ``keep_last`` the epoch's last batch is returned
    unread, and the next call, given it as ``carried``, logs it after its
    own first dispatch; the device then never waits for the host between
    epochs. A carried batch counts in no epoch's mean loss.

    Returns (n_updates, mean_loss, the losses read of this epoch's samples,
    n_batches, the unread last batch with ``keep_last`` else None)."""
    additional_identifiers = list(additional_identifiers or [])
    view_head = conf.get_bool("model.view_head.enabled")
    scenepoint_head = conf.get_bool("model.scenepoint_head.enabled")
    explicit = view_head and scenepoint_head
    calc_backproj = conf.get_bool("eval.calc_reprojerr_with_gtposes_for_depth_pred", default=False)
    device_metrics = explicit and not calc_backproj and outlier_injection_rate is None
    train_losses: List[float] = []
    loss_totals = {"sum": 0.0, "n": 0}

    def _flush(pnd):
        values = pnd["scalars"].get()
        n_loss, n_repro = pnd["n"], len(pnd["repro"])
        losses = values[:n_loss]
        repros = values[n_loss:n_loss + n_repro]
        grad_norm = values[n_loss + n_repro] if pnd["has_norm"] else None
        batch_loss = float(sum(losses))
        if not pnd.get("carried"):
            train_losses.extend(losses)
            loss_totals["sum"] += batch_loss
            loss_totals["n"] += n_loss
        nb = pnd["n_batch"]  # the reference's mean over the full batch
        batch_mean_repro = float(sum(repros)) / nb if (explicit and nb) else 0.0
        batch_mean_repro_backproj = (sum(pnd["backproj"]) / nb) if (calc_backproj and nb) else 0.0
        step_idx = pnd["step_idx"]
        curr_scene_name = pnd["scene_name"]
        if tb_writer is not None:
            log_scene = None if phase == Phases.TRAINING else curr_scene_name
            tb_log_train_step(tb_writer, step_idx, "loss", batch_loss, phase,
                              additional_identifiers, scene=log_scene)
            if explicit:
                tb_log_train_step(tb_writer, step_idx, "our_repro", batch_mean_repro, phase,
                                  additional_identifiers, scene=log_scene)
            if calc_backproj:
                tb_log_train_step(tb_writer, step_idx, "repro_backproj_rnd_gt_2view",
                                  batch_mean_repro_backproj, phase, additional_identifiers,
                                  scene=log_scene)
            if phase == Phases.TRAINING and tb_log_train_per_scene and curr_scene_name is not None:
                tb_log_train_step(tb_writer, step_idx, "loss", batch_loss, phase,
                                  additional_identifiers, scene=curr_scene_name)
            tb_log_train_step(tb_writer, step_idx, "learning_rate", pnd["lr"], phase,
                              additional_identifiers, scene=log_scene)
            if grad_norm is not None:
                tb_log_train_step(tb_writer, step_idx, "grad_norm", grad_norm, phase,
                                  additional_identifiers,
                                  scene=None if phase == Phases.TRAINING else curr_scene_name)

    pending = carried
    batch_idx = -1
    prepared_batches = _prepare_batches(train_loader, outlier_injection_rate, rng, epoch,
                                        depth=2 if phase == Phases.TRAINING else 0)
    for batch_idx, prepared_batch in enumerate(prepared_batches):
        # the upload, on this thread (a CUDA call from the loader's thread
        # could break a recording made here)
        valid = [(curr_data, session.scene_graph(model_data))
                 for curr_data, model_data in prepared_batch if model_data is not None]
        loss_parts: List[Any] = []
        repro_parts: List[Any] = []
        backproj_parts: List[float] = []
        grad_norm = None
        curr_scene_name = scene
        if not valid:
            # no valid sample: the reference still steps its scheduler
            # (train.py:152), not the optimizer
            session.advance_schedule()
        elif device_metrics and len(valid) == 1:
            curr_scene_name = valid[0][0].scene_name
            loss, repro, grad_norm = session.fused_step(valid[0][1])
            loss_parts.append(loss)
            repro_parts.append(repro)
        else:
            grads_sum = None
            for curr_data, scene_graph in valid:
                curr_scene_name = curr_data.scene_name
                loss, pred, grads = session.loss_and_grads(scene_graph)
                if device_metrics:
                    repro_parts.append(core_errors_device(pred, scene_graph)["our_repro"])
                elif explicit or calc_backproj:
                    core = compute_core_errors(
                        curr_data, predictions_to_host(pred, curr_data, scene_graph.graph), conf)
                    if explicit:
                        repro_parts.append(core["our_repro"])
                    if calc_backproj:
                        backproj_parts.append(core["repro_backproj_rnd_gt_2view"])
                loss_parts.append(loss)
                if grads_sum is None:
                    # of several samples, a copy: a recording's outputs are
                    # overwritten by its next replay
                    grads_sum = grads if len(valid) == 1 else [g.clone() for g in grads]
                else:
                    grads_sum = session.accumulate(grads_sum, grads)
            grad_norm = session.update(grads_sum)

        scalars = _HostScalars(loss_parts + repro_parts + ([] if grad_norm is None else [grad_norm]))
        if pending is not None:
            _flush(pending)
        pending = {
            "scalars": scalars,
            "n": len(loss_parts),
            "repro": repro_parts,
            "backproj": backproj_parts,
            "has_norm": grad_norm is not None,
            "n_batch": len(prepared_batch),
            "step_idx": prev_n_batches + batch_idx,
            "scene_name": curr_scene_name,
            "lr": session.lr_at(n_updates),
        }
        n_updates += 1  # the reference steps the scheduler every batch

    last = None
    if pending is not None:
        if keep_last:
            last = dict(pending, carried=True)
        else:
            _flush(pending)
    n_batches = batch_idx + 1
    mean_loss = loss_totals["sum"] / loss_totals["n"] if loss_totals["n"] else float("nan")
    return n_updates, mean_loss, train_losses, n_batches, last


def eval_errors_list2df(errors_list: List[Dict]) -> Table:
    """The rows of an evaluation, keyed by ``Scene``, with their ``Mean``
    row; printed rounded to 3 decimals (reference train.py:160-168)."""
    table = Table.from_records(errors_list, index="Scene").with_mean()
    print(table.round(3).to_string(), flush=True)
    return table


def aggregate_val_metric(validation_errors: Table, metric_column: str,
                         scene: Optional[str] = None):
    """The entry of ``metric_column`` at ``scene``'s row, the ``Mean`` row by
    default (reference train.py:262-269)."""
    assert isinstance(metric_column, str)
    return validation_errors.loc("Mean" if scene is None else scene, metric_column)


def epoch_evaluation(
    data_loader,
    session: TrainingSession,
    weights: Optional[Mapping[str, torch.Tensor]],
    conf,
    epoch: Optional[int],
    phase: Phases,
    outlier_injection_rate: Optional[float] = None,
    dump_and_plot_predictions: bool = False,
    additional_identifiers: Optional[List[str]] = None,
    bundle_adjustment: bool = True,
    log_memory_consumption: bool = False,
    crash_on_scene_exhausting_memory: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> Table:
    """Evaluate every scene of ``data_loader`` (the JAX package's
    train/loop.py:587-765; reference train.py:170-259): with
    ``outlier_injection_rate`` each scene injected with outliers from
    ``rng`` first (a new scene each time: its forward runs eagerly, and its
    graph goes with it) and the metrics scored against the clean scene; the
    session's forward (recorded on the card), timed on the host between two
    synchronisations (``Inference time``), then ``prepare_predictions``
    (with bundle adjustment if asked) and ``compute_errors`` on the host;
    with ``dump_and_plot_predictions`` the predictions' npz and, for a
    calibrated scene with explicit heads, the HTML plot. ``weights`` (a
    ``state_dict``) are copied into the session's model first; None keeps
    its current ones. A scene that runs the device out of memory gets a row
    of NaNs unless ``crash_on_scene_exhausting_memory``. Returns the rows
    with their ``Mean`` row."""
    from gasfm_tpu_torch.data.outliers import inject_outliers

    additional_identifiers = list(additional_identifiers or [])
    explicit = (conf.get_bool("model.view_head.enabled")
                and conf.get_bool("model.scenepoint_head.enabled"))
    if weights is not None:
        session.load_weights(weights)

    def _post(curr_data, scene_graph, pred, pred_time):
        pred_np = predictions_to_host(pred, curr_data, scene_graph.graph)
        outputs = prepare_predictions(curr_data, pred_np, conf, bundle_adjustment)
        errors = compute_errors(outputs, conf, bundle_adjustment)
        errors["Inference time"] = pred_time
        errors["Scene"] = curr_data.scene_name
        if epoch is None:
            errors.update(curr_data.get_data_statistics())
        if dump_and_plot_predictions:
            out_clean = {k: v for k, v in outputs.items() if not isinstance(v, dict)}
            dump_predictions(conf, out_clean, curr_data.scene_name, phase, epoch=epoch,
                             additional_identifiers=additional_identifiers)
            if conf.get_bool("dataset.calibrated") and explicit:
                from gasfm_tpu_torch.utils.plotting import plot_cameras_before_and_after_ba

                plot_cameras_before_and_after_ba(
                    outputs, errors, conf, phase, scene=curr_data.scene_name, epoch=epoch,
                    bundle_adjustment=bundle_adjustment,
                    additional_identifiers=additional_identifiers,
                )
        return errors

    errors_list = []
    for j, batch_data in enumerate(data_loader):
        if log_memory_consumption:
            print(f"Scene batch {j + 1}/{len(data_loader)}.")
        for curr_data in batch_data:
            try:
                model_data = curr_data
                if outlier_injection_rate is not None:
                    model_data = inject_outliers(curr_data, outlier_injection_rate, rng=rng)
                    assert model_data is not None
                scene_graph = session.scene_graph(model_data)
                _sync(session.device)
                begin = time()
                pred = session.forward(scene_graph)
                _sync(session.device)
                errors = _post(curr_data, scene_graph, pred, time() - begin)
            except Exception as e:  # noqa: BLE001 - the reference's OOM tolerance
                if not _is_oom_error(e) or crash_on_scene_exhausting_memory:
                    raise
                print(f"Ran out of memory when evaluating on {curr_data.scene_name}.")
                errors = get_dummy_errors(conf, bundle_adjustment)
                errors["Inference time"] = float("nan")
                errors["Scene"] = curr_data.scene_name
            errors_list.append(errors)
    return eval_errors_list2df(errors_list)


def get_dummy_train_stats() -> Table:
    """The train-stats row of a phase without validation (reference
    train.py:693-700)."""
    nan = float("nan")
    return Table.from_records([{
        "Scene": 0,
        "Convergence time": nan,
        "best_epoch": nan,
        "best_validation_metric": nan,
        "final_validation_metric": nan,
    }])


def curriculum_epochs(conf, phase: Phases, scene_data) -> int:
    """The epochs the single-scene view curriculum
    (``train.sequentially_increment_views``) adds before the conf's
    ``train.n_epochs``, 0 without it or in the ``TRAINING`` phase: one stage
    of ``train.increment_views_interval`` epochs per view added from 2 (the
    JAX package's train/loop.py:810-828). The session's schedule takes them
    as its ``milestone_shift``."""
    if phase == Phases.TRAINING or not conf.get_bool("train.sequentially_increment_views",
                                                      default=False):
        return 0
    return (scene_data.num_views - 1) * conf.get_int("train.increment_views_interval")


def train(
    conf,
    train_loader,
    session: TrainingSession,
    phase: Phases,
    train_loader_for_eval=None,
    val_loader=None,
    test_loader=None,
    additional_identifier: Optional[str] = None,
    rng: Optional[np.random.Generator] = None,
):
    """Train ``session``'s model in place for ``train.n_epochs`` epochs of
    ``train_loader`` (the JAX package's train/loop.py:768-1163; reference
    train.train, train.py:372-700).

    ``TRAINING`` (multi-scene learning: ``train_loader`` samples subscenes,
    ``val_loader`` and ``test_loader`` given): evaluations on the validation
    set (with ``train.outlier_injection_rate`` also an outlier-free pass),
    with ``eval.eval_on_train_set`` on ``train_loader_for_eval`` too, each
    logged to TensorBoard (per scene with ``train.tb_log_*_per_scene``);
    the best weights by ``train.validation_metric`` (``our_repro`` for the
    explicit heads, else the backprojection metric, which needs
    ``eval.calc_reprojerr_with_gtposes_for_depth_pred``) kept as a CPU copy,
    ``model_epoch*.npz`` at each new best and ``best_model.npz``.

    A single-scene phase (``OPTIMIZATION``, ``FINE_TUNE``,
    ``SHORT_OPTIMIZATION``; ``train_loader`` one scene): evaluations of
    ``train_loader_for_eval`` (the scene); with
    ``train.sequentially_increment_views`` the view curriculum first
    (:func:`curriculum_epochs`; the caller's session built with them as its
    ``milestone_shift``): each stage trains on ``get_subset`` of the scene,
    whose recordings go when the next stage replaces it.

    Both: an evaluation before the first epoch with ``eval.eval_init``
    (always before fine-tuning), after the first, every
    ``eval.eval_interval`` and the last (bundle adjustment at each unless
    ``ba.only_last_eval``); outlier injection in training and evaluation
    with ``train.outlier_injection_rate``; ``train.finetune_dump_*`` weight
    files and prediction dumps; ``checkpoint.*`` (save every ``interval``
    epochs, keep ``keep``, resume the newest); ``final_model.npz`` in the
    JAX package's npz layout. Returns ({"final_model": a CPU copy of the
    final ``state_dict``, and with a validation metric "best_model"}, the
    train-stats table)."""
    from gasfm_tpu_torch.data.dataset import SceneLoader, ScenesDataSet
    from gasfm_tpu_torch.data.sampling import get_subset
    from gasfm_tpu_torch.utils.paths import get_additional_identifiers_for_outlier_injection

    training = phase == Phases.TRAINING
    additional_identifiers = [] if additional_identifier is None else [additional_identifier]
    n_epochs = conf.get_int("train.n_epochs")
    outlier_injection_rate = conf.get_float("train.outlier_injection_rate", default=None)
    print_interval = conf.get_int("train.print_interval", default=None)
    eval_interval = conf.get_int("eval.eval_interval", default=500)
    finetune_dump_model_interval = conf.get_int("train.finetune_dump_model_interval", default=None)
    finetune_dump_and_plot_pred_interval = conf.get_int(
        "train.finetune_dump_and_plot_pred_interval", default=None)
    stdout_log_eval_memory = conf.get_bool("memory.stdout_log_eval_memory_consumption",
                                           default=False)
    explicit = (conf.get_bool("model.view_head.enabled")
                and conf.get_bool("model.scenepoint_head.enabled"))
    lr_warmup_n_steps = conf.get_int("train.lr_schedule.lr_warmup_n_steps", default=0)
    if rng is None:
        rng = np.random.default_rng(conf.get_int("random_seed", default=0))
    tb_log_train_per_scene = conf.get_bool("train.tb_log_train_per_scene", default=False)
    tb_log_val_per_scene = conf.get_bool("train.tb_log_val_per_scene", default=False)

    scene = None
    sequential = False
    if not training:
        assert phase in (Phases.FINE_TUNE, Phases.SHORT_OPTIMIZATION, Phases.OPTIMIZATION)
        if train_loader_for_eval is None:
            train_loader_for_eval = train_loader
        assert len(train_loader) == 1
        the_batch = next(iter(train_loader))
        assert len(the_batch) == 1
        scene = conf.get_string("dataset.scene")
        fullscene_data = the_batch[0]
        n_epochs_sequential = curriculum_epochs(conf, phase, fullscene_data)
        if n_epochs_sequential:
            sequential = True
            increment_views_interval = conf.get_int("train.increment_views_interval")
            total_n_views = fullscene_data.num_views
            curr_n_views = None
            n_epochs += n_epochs_sequential
        validation_metric = None
    else:
        if conf.get_bool("eval.eval_on_train_set", default=False):
            assert train_loader_for_eval is not None
        validation_metric = conf.get_string("train.validation_metric", default=None)
        if validation_metric is None:
            if explicit:
                validation_metric = "our_repro"
            elif conf.get_bool("model.depth_head.enabled"):
                validation_metric = "repro_backproj_rnd_gt_2view"
        if validation_metric == "repro_backproj_rnd_gt_2view" and not conf.get_bool(
                "eval.calc_reprojerr_with_gtposes_for_depth_pred", default=False):
            # fail fast: compute_errors writes the column only with the flag
            # on, so the first validation would die with a KeyError
            raise ValueError(
                "train.validation_metric 'repro_backproj_rnd_gt_2view' requires "
                "eval.calc_reprojerr_with_gtposes_for_depth_pred = true (or set "
                "train.validation_metric explicitly).")
    assert training == (val_loader is not None)
    # the test set is evaluated by the caller (reference train.py:372,429)
    assert training == (test_loader is not None)

    tb_writer = get_tb_writer(conf)
    run_ba = conf.get_bool("ba.run_ba", default=True)
    ba_during_training = run_ba and not conf.get_bool("ba.only_last_eval")
    outlier_ids = get_additional_identifiers_for_outlier_injection(outlier_injection_rate)

    def models_path(name: str) -> str:
        return os.path.join(paths.path_to_models_dir(
            conf, phase, additional_identifiers=additional_identifiers), name)

    def evaluate(loader, epoch, ph, oir, ids, dump_and_plot) -> Table:
        return epoch_evaluation(
            loader, session, None, conf, epoch, ph, outlier_injection_rate=oir,
            dump_and_plot_predictions=dump_and_plot, additional_identifiers=ids,
            bundle_adjustment=ba_during_training, log_memory_consumption=stdout_log_eval_memory,
            crash_on_scene_exhausting_memory=True, rng=rng)

    def log_eval(epoch, errors, ph, ids, per_scene_key=None, log_scene=None):
        tb_log_eval_step(conf, tb_writer, epoch, errors, phase=ph, additional_identifiers=ids,
                         scene=log_scene, include_post_ba_metrics=ba_during_training)
        if per_scene_key is not None:
            for sc in conf.get_list(per_scene_key, default=[]):
                tb_log_eval_step(conf, tb_writer, epoch, errors, phase=ph,
                                 additional_identifiers=ids, scene=sc,
                                 include_post_ba_metrics=ba_during_training)

    def run_evals(epoch: int, dump_and_plot: bool) -> Table:
        """The evaluations of an epoch (reference train.py:486-547, 587-631);
        returns the table the validation metric is read from."""
        ids, ids_out = additional_identifiers, additional_identifiers + outlier_ids
        if not training:
            errors = evaluate(train_loader_for_eval, epoch, phase, outlier_injection_rate,
                              ids_out, dump_and_plot)
            log_eval(epoch, errors, phase, ids_out, log_scene=scene)
            if outlier_injection_rate is not None:
                log_eval(epoch, evaluate(train_loader_for_eval, epoch, phase, None, ids,
                                         dump_and_plot), phase, ids, log_scene=scene)
            return errors
        val_per_scene = "dataset.validation_set" if tb_log_val_per_scene else None
        errors = evaluate(val_loader, epoch, Phases.VALIDATION, outlier_injection_rate, ids_out,
                          dump_and_plot)
        log_eval(epoch, errors, Phases.VALIDATION, ids_out, val_per_scene)
        if outlier_injection_rate is not None:  # the outlier-free pass (train.py:497-501)
            errors = evaluate(val_loader, epoch, Phases.VALIDATION, None, ids, dump_and_plot)
            log_eval(epoch, errors, Phases.VALIDATION, ids, val_per_scene)
        if conf.get_bool("eval.eval_on_train_set", default=False):  # train.py:503-516
            train_per_scene = "dataset.train_set" if tb_log_train_per_scene else None
            for oir, oids in ((outlier_injection_rate, ids_out),) + (
                    ((None, ids),) if outlier_injection_rate is not None else ()):
                log_eval(epoch, evaluate(train_loader_for_eval, epoch, Phases.TRAINING, oir,
                                         oids, dump_and_plot),
                         Phases.TRAINING, oids, train_per_scene)
        return errors

    best = {"metric": math.inf, "epoch": -1, "weights": None, "time": -1.0}
    final_validation_metric = float("nan")
    begin_time = time()

    def track_best(epoch: int, validation_errors: Table) -> float:
        metric = aggregate_val_metric(validation_errors, metric_column=validation_metric)
        if metric < best["metric"]:
            best.update(metric=metric, epoch=epoch, weights=session.weights())
            if epoch >= 0:
                best["time"] = time() - begin_time
                print(f"Updated best validation metric: {metric} time so far: {best['time']}")
            else:
                print(f"Updated best validation metric: {metric}")
        return metric

    # the initial evaluation (always before fine-tuning; reference train.py:486)
    if conf.get_bool("eval.eval_init", default=False) or phase == Phases.FINE_TUNE:
        validation_errors = run_evals(-1, finetune_dump_and_plot_pred_interval is not None)
        if validation_metric is not None:
            track_best(-1, validation_errors)
            if best["epoch"] == -1:
                save_params(models_path("best_model.npz"), best["weights"])
        if finetune_dump_model_interval is not None:
            save_params(models_path(f"model_epoch{0:06d}.npz"), session.model)

    # full train-state checkpoints with resume (the JAX package's addition;
    # the reference saves weights only)
    ckpt_enabled = conf.get_bool("checkpoint.enabled", default=False)
    ckpt_interval = conf.get_int("checkpoint.interval", default=1000)
    ckpt_keep = conf.get_int("checkpoint.keep", default=3)
    ckpt_resume = conf.get_bool("checkpoint.resume", default=False)
    start_epoch = 0
    n_updates = 0
    total_n_batches = 0
    n_epochs_post_warmup = None if lr_warmup_n_steps > 0 else 0
    ckpt_dir = models_path("train_state") if ckpt_enabled else None
    if ckpt_enabled and ckpt_resume:
        meta: Dict[str, int] = {}
        restored = restore_checkpoint(ckpt_dir, session, meta=meta)
        if restored is not None:
            start_epoch = restored
            n_updates = session.optimizer.schedule_count
            total_n_batches = meta["total_n_batches"]
            post = meta["n_epochs_post_warmup_plus_1"]  # 0 encodes None
            n_epochs_post_warmup = post - 1 if post > 0 else None
            print(f"[checkpoint] resumed at epoch {start_epoch} ({n_updates} updates)")

    carried = None  # the last epoch's step, its scalars not read yet
    curr_train_loader = train_loader
    profiler = ProfilerWindow(conf)
    for epoch in range(start_epoch, n_epochs):
        if sequential:
            prev_n_views = curr_n_views
            curr_n_views = (2 + n_epochs_post_warmup // increment_views_interval
                            if n_epochs_post_warmup is not None else 2)
            if curr_n_views >= total_n_views:
                curr_train_loader = train_loader
            elif curr_n_views != prev_n_views:
                print(f"Updating #views: {prev_n_views} -> {curr_n_views}")
                # the stage's subscene lives in its loader only: replaced,
                # it goes, with its graph and recordings
                curr_train_loader = SceneLoader(
                    ScenesDataSet([get_subset(fullscene_data, curr_n_views)], return_all=True),
                    batch_size=1, shuffle=False, prefetch=0)
        will_eval = (epoch + 1) % eval_interval == 0 or epoch == 0 or epoch == n_epochs - 1
        will_print = print_interval is not None and epoch % print_interval == 0
        will_save = ckpt_enabled and (epoch + 1) % ckpt_interval == 0
        profiler.maybe_start(epoch)
        n_updates, mean_loss, _, n_batches, carried = epoch_train(
            conf, session, curr_train_loader, n_updates, epoch, phase, tb_writer,
            outlier_injection_rate=outlier_injection_rate,
            additional_identifiers=additional_identifiers + outlier_ids, scene=scene,
            prev_n_batches=total_n_batches,
            tb_log_train_per_scene=tb_log_train_per_scene if training else None, rng=rng,
            carried=carried, keep_last=not (will_eval or will_print or will_save),
        )
        profiler.maybe_stop(epoch)
        total_n_batches += n_batches
        if n_epochs_post_warmup is not None:
            n_epochs_post_warmup += 1
        elif total_n_batches >= lr_warmup_n_steps:
            n_epochs_post_warmup = 0

        if will_print:
            print(f"{epoch} Train Loss: {mean_loss}")

        if will_save:
            save_checkpoint(ckpt_dir, session, epoch + 1, keep=ckpt_keep, meta={
                "total_n_batches": total_n_batches,
                "n_epochs_post_warmup_plus_1": (0 if n_epochs_post_warmup is None
                                                else n_epochs_post_warmup + 1)})

        if will_eval:
            dump_and_plot = (finetune_dump_and_plot_pred_interval is not None
                             and (epoch + 1) % finetune_dump_and_plot_pred_interval == 0)
            validation_errors = run_evals(epoch, dump_and_plot)
            if validation_metric is not None:
                metric = track_best(epoch, validation_errors)
                if epoch == n_epochs - 1:
                    final_validation_metric = metric
            if ((finetune_dump_model_interval is not None
                 and (epoch + 1) % finetune_dump_model_interval == 0)
                    or (validation_metric is not None and epoch == best["epoch"])):
                save_params(models_path(f"model_epoch{epoch + 1:06d}.npz"), session.model)

    profiler.close()
    save_params(models_path("final_model.npz"), session.model)
    trained = {"final_model": session.weights()}
    train_stats = get_dummy_train_stats()
    if validation_metric is not None:
        trained["best_model"] = (best["weights"] if best["weights"] is not None
                                 else trained["final_model"])
        save_params(models_path("best_model.npz"), trained["best_model"])
        # unindexed, as the JAX package's DataFrame (train/loop.py:1148-1153)
        train_stats = Table.from_records([{
            "": 0, "Convergence time": best["time"], "best_epoch": best["epoch"] + 1,
            "best_validation_metric": best["metric"],
            "final_validation_metric": final_validation_metric}], index="")
    tb_writer.flush()
    return trained, train_stats
