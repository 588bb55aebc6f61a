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

Under a mesh (``parallel.mesh_shape = [n_data, n_edge]``;
``gasfm_tpu_torch/parallel``) one session runs on each rank, eagerly, and
every call is collective: every rank makes it, on the same scenes. The
session holds the rank's edge shard of each scene (``scene_graph``); rank
0's weights are broadcast to every rank when the session is made. With
table sharding (``parallel.table_sharding``, null: on when ``n_edge > 1``)
its forwards and backwards run under the rank's ``TableShard`` too
(``ops/segment.py`` ``table_sharded``; the JAX package's
``_table_shard_ctx``), each scene's graph checked against the boundary
exchange's contract when it is made. ``fused_group_step(scenes)`` trains on a group of at
most ``n_data`` scenes (data slot d on scene d, a short group's empty slots
on its last scene with weight 0; the JAX package's ``make_sharded_fused_step``,
``parallel/edge_sharding.py:319``): each rank's loss, scaled by its slot's
weight, goes backward under the edge group's reductions (``ops/segment.py``
``edge_partitioned``), the gradients are summed over all ranks in one
all-reduce, and the same Adam step then runs on every rank, so the weights
stay bitwise equal. ``fused_step(scene)`` is the group of one;
``loss_and_grads`` runs one scene the same way and returns the summed
gradients (``make_sharded_grad_step``, :396), ``update`` is unchanged. The
predictions of ``forward`` (every slot on one scene) and ``forward_group``
(each slot on its scene, :517) come back whole on every rank: the camera
tables are, the point table under table sharding is put together by one
masked sum over the edge group (the JAX package's
``_combine_table_outputs``: per forward and per ``loss_and_grads``, never in
the fused step, whose ``our_repro`` reads only the points the rank's edges
touch), and the depth head's per-edge depths are put together over the edge
group. The drivers run on every rank; only rank 0 (``is_writer``) prints,
writes files, evaluates the metrics and runs BA.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import weakref
import zlib
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
from gasfm_tpu_torch.ops.segment import edge_partitioned, table_sharded
from gasfm_tpu_torch.train.state import (FLAGSHIP_OPTIM, build_optimizer,
                                         cast_params_for_training, global_norm, optim_from_conf,
                                         restore_checkpoint, save_checkpoint, save_params)
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

    def graph_of(self, data, device: torch.device, shard: Optional[Tuple[int, int]] = None,
                 check: Optional[Callable] = None):
        graph = self.graphs.get(id(data))
        if graph is None:
            if shard is None:
                graph = data.to_scene_graph(device=device)
            else:  # this rank's edge shard of the scene
                from gasfm_tpu_torch.graph.view_graph import shard_host_graph, upload

                host = data.host_graph()
                if check is not None:
                    check(host)
                graph = upload(shard_host_graph(host, *shard), device)
            self.graphs[id(data)] = graph
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
    keyword arguments, the flagship conf's by default; with ``param_dtype``
    "bf16" the model's weights become bf16 in place first, and the
    optimizer keeps their f32 master (the JAX package's
    ``cast_params_for_training`` at step 0, train/loop.py:867-873; its
    gradients are then bf16 too). ``capture``: record
    the training steps as CUDA graphs (see the module docstring); on by
    default for a CUDA session, and refused for a CPU one. ``mesh``: this
    rank's :class:`~gasfm_tpu_torch.parallel.Mesh` (see the module
    docstring); a mesh session runs eagerly, and refuses ``capture=True``
    (the gloo collectives cannot be recorded). ``table_sharding``: the
    conf's ``parallel.table_sharding`` (null: on when the mesh has more than
    one edge shard)."""

    def __init__(self, model: Union[GraphAttnSfMNet, SetOfSetNet],
                 loss_func: Union[ESFMLoss, DirectDepthLoss],
                 device: Optional[Union[str, torch.device]] = None,
                 optim: Optional[dict] = None, capture: Optional[bool] = None,
                 mesh=None, table_sharding: Optional[bool] = None):
        from gasfm_tpu_torch.parallel import table_sharding_on

        self.device = resolve_device(device)
        self.mesh = mesh
        self.table_sharding = mesh is not None and table_sharding_on(table_sharding, mesh.n_edge)
        if mesh is not None:
            if capture:
                raise ValueError("capture=True records CUDA graphs; a mesh session's gloo "
                                 "collectives cannot be recorded, it runs eagerly")
            if torch.device(mesh.device) != self.device:
                raise ValueError(f"the session's device {self.device} is not its rank's "
                                 f"{mesh.device}")
            capture = False
        if capture is None:
            capture = self.device.type == "cuda"
        elif capture and self.device.type != "cuda":
            raise ValueError(f"capture=True records CUDA graphs; this session runs on "
                             f"{self.device}")
        self.capture = capture
        optim = optim or FLAGSHIP_OPTIM
        self.model = cast_params_for_training(model.to(self.device), optim.get("param_dtype"))
        self.loss_func = loss_func
        if mesh is not None:  # rank 0's weights on every rank, before the optimizer
            # copies them (its f32 master under bf16 weights)
            mesh.broadcast(list(self.model.state_dict().values()))
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = build_optimizer(self.params, **optim)
        self._stream = torch.cuda.Stream(self.device) if capture else None
        self._cache = _SceneCache()
        self._own = _Calls()  # the update on the session's own input buffers
        self._update_inputs: Optional[List[torch.Tensor]] = None

    @classmethod
    def from_conf(cls, conf, model: Union[GraphAttnSfMNet, SetOfSetNet],
                  milestone_shift: int = 0, device: Optional[Union[str, torch.device]] = None,
                  capture: Optional[bool] = None, mesh=None) -> "TrainingSession":
        """The session of a conf: ``get_loss_func(conf)`` and the optimizer
        of ``optim_from_conf(conf, milestone_shift)``. A ``parallel.mesh_shape``
        of more than one position makes a mesh session on ``mesh``, this
        rank's :class:`~gasfm_tpu_torch.parallel.Mesh` of that shape (the
        ranks come from ``parallel.run_ranks``, or from the CLI, which
        launches them, one launcher per host under ``parallel.distributed``);
        without ``mesh`` it raises ``ValueError``; it shards the point table
        as ``parallel.table_sharding`` says."""
        from gasfm_tpu_torch.parallel import mesh_shape_from_conf

        shape = mesh_shape_from_conf(conf)
        have = None if mesh is None else (mesh.n_data, mesh.n_edge)
        if shape != have:
            raise ValueError(f"the conf's mesh {shape} is not the session's {have}: a mesh "
                             f"conf runs on the ranks of parallel.run_ranks (or the CLI)")
        return cls(model, get_loss_func(conf), device=device,
                   optim=optim_from_conf(conf, milestone_shift), capture=capture, mesh=mesh,
                   table_sharding=conf.get_bool("parallel.table_sharding", default=None))

    def forward_bytes(self, scene) -> int:
        """An upper bound of the device memory that the evaluation forward
        of a scene graph of this session (on a mesh, of the rank's shard)
        allocates beyond what is allocated before it
        (:func:`forward_bytes_bound`)."""
        return forward_bytes_bound(self.model, scene.graph)

    def reserve_forward(self, scene) -> None:
        """Allocate :meth:`forward_bytes` on the session's device and free it
        back to the caching allocator, where the forward finds it: raises
        the device's out-of-memory error when the forward would not fit."""
        block = torch.empty(self.forward_bytes(scene), dtype=torch.uint8, device=self.device)
        del block

    @property
    def is_writer(self) -> bool:
        """Whether this session prints and writes: always, but on a mesh
        only rank 0's."""
        return self.mesh is None or self.mesh.is_writer

    def scene_graph(self, data):
        """The :class:`~gasfm_tpu_torch.graph.view_graph.SceneGraph` of a
        :class:`~gasfm_tpu_torch.data.scene.SceneData` on this session's
        device, built (uploaded from ``data.host_graph()``) at the first
        request and kept while the caller keeps ``data``: the same scene
        object gets the same graph, whose recordings replay. When the caller
        drops ``data`` the graph goes, with every recording that reads it.
        On a mesh, the rank's edge shard of the scene; with table sharding
        the scene is first checked against the boundary exchange's contract
        (``parallel.check_table_shard_contract``: raises ``ValueError``)."""
        shard = check = None
        if self.mesh is not None:
            shard = (self.mesh.edge_shard, self.mesh.n_edge)
        if self.table_sharding:
            from gasfm_tpu_torch.parallel import check_table_shard_contract

            def check(host):
                check_table_shard_contract(host.pt_ptr, self.mesh.n_edge)
        return self._cache.graph_of(data, self.device, shard, check)

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
        its outputs. On a mesh every slot runs ``scene`` and the predictions
        come back whole on every rank."""
        if self.mesh is not None:
            return self._mesh_forward(scene, plain)
        if plain or not self.capture:
            return self._forward(scene, plain)
        pred = self._recorded(self._cache.of(scene), "forward", self._forward, (scene,), scene)
        return {k: v.clone() for k, v in pred.items()}

    def _as_graph(self, scene):
        """A scene graph of this session: ``scene`` itself, or the graph of a
        :class:`~gasfm_tpu_torch.data.scene.SceneData` (:meth:`scene_graph`)."""
        return scene if hasattr(scene, "graph") else self.scene_graph(scene)

    @contextlib.contextmanager
    def _sharded(self, graph):
        """The scope of a mesh session's forward and backward on the rank's
        shard ``graph``: the edge group's reductions, and with table
        sharding the graph's ``TableShard``."""
        shard = graph.table_shard if self.table_sharding else None
        with edge_partitioned(self.mesh.edge_scope), table_sharded(shard):
            yield

    def _whole(self, pred: Dict[str, torch.Tensor], graph) -> Dict[str, torch.Tensor]:
        """A rank's predictions made whole: under table sharding the point
        table's owned columns summed over the edge group
        (``parallel.edge_sharding.sum_owned_points``); the depth head's
        per-edge depths of the edge shard put into the scene's edge order
        and summed over the edge group (each range filled by one rank); the
        camera tables are whole already."""
        pred = {k: v.detach() for k, v in pred.items()}
        if "pts3D" in pred and self.table_sharding:
            from gasfm_tpu_torch.parallel.edge_sharding import sum_owned_points

            pred["pts3D"] = sum_owned_points(pred["pts3D"], graph.table_shard,
                                             self.mesh.edge_group)
        if "depths" in pred and self.mesh.n_edge > 1:
            d = pred["depths"]
            full = d.new_zeros((graph.scene_edges,))
            full[graph.edge_offset:graph.edge_offset + d.shape[0]] = d
            pred["depths"] = self.mesh.sum_over_edges(full)
        return pred

    @torch.no_grad()
    def _mesh_forward(self, scene, plain: bool = False) -> Dict[str, torch.Tensor]:
        scene = self._as_graph(scene)
        with self._sharded(scene.graph):
            pred = self.model(scene.graph, plain=plain)
        return self._whole(pred, scene.graph)

    @torch.no_grad()
    def forward_group(self, scenes: Sequence, plain: bool = False
                      ) -> List[Dict[str, torch.Tensor]]:
        """The predictions of each of at most ``n_data`` scenes (scene graphs
        of this session, or ``SceneData``), each data slot running its own
        (the JAX package's grouped forward, ``edge_sharding.py:517``): per
        scene, whole on every rank, shared over the data group; a rank makes
        the graph of its own slot's scene only. Without a mesh, one
        ``forward`` per scene."""
        if self.mesh is None:
            return [self.forward(self._as_graph(s), plain) for s in scenes]
        from gasfm_tpu_torch.parallel import pad_scene_group

        slots, _ = pad_scene_group(list(scenes), self.mesh.n_data)
        own = self.mesh.data_slot
        mine = self._mesh_forward(slots[own], plain)
        if self.mesh.n_data == 1:
            return [mine]
        preds = []
        for i, sc in enumerate(slots[:len(scenes)]):  # scene i from slot i's ranks
            pred = {k: (mine[k] if i == own else torch.zeros(shape, device=self.device))
                    for k, shape in self._pred_shapes(sc).items()}
            preds.append({k: self.mesh.sum_over_data(v) for k, v in pred.items()})
        return preds

    def _pred_shapes(self, scene) -> Dict[str, tuple]:
        """The shapes of a scene's whole predictions, from its graph or, for
        a ``SceneData``, without making one."""
        if hasattr(scene, "graph"):
            m, n, E = scene.graph.num_cams, scene.graph.num_pts, scene.graph.scene_edges
        else:
            m, n, E = scene.num_views, scene.num_points, int(scene.valid_pts.sum())
        if self.model.depth_head_enabled:
            return {"depths": (E,)}
        return {"Ps_norm": (m, 3, 4), "pts3D": (4, n)}

    @torch.no_grad()
    def loss(self, pred: Dict[str, torch.Tensor], scene, plain: bool = False) -> torch.Tensor:
        """The loss of predictions on a scene graph of this session; on a
        mesh, of whole predictions (``forward``'s), the scene's."""
        if self.mesh is None:
            return self.loss_func(pred, scene, plain=plain)
        g = scene.graph
        if "depths" in pred and pred["depths"].shape[0] != g.num_edges:  # the shard's edges
            pred = dict(pred, depths=pred["depths"][g.edge_offset:g.edge_offset + g.num_edges])
        with edge_partitioned(self.mesh.edge_scope):
            return self.loss_func(pred, scene, plain=plain)

    def _loss_and_grads(self, scene, plain: bool = False, weight: Optional[float] = None):
        with torch.enable_grad():
            pred = self.model(scene.graph, plain=plain)
            loss = self.loss_func(pred, scene, plain=plain)
            if weight is not None:  # a mesh slot's weight
                loss = loss * weight
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
        overwrites (``update`` reads them there). On a mesh the scene is a
        group of one (slot 0; the other slots run it with weight 0): the
        loss is the scene's, the predictions whole, the gradients summed
        over all ranks, the same on every rank."""
        if self.mesh is not None:
            return self.group_loss_and_grads([scene], plain)
        if plain or not self.capture:
            return self._loss_and_grads(scene, plain)
        loss, pred, grads = self._recorded(self._cache.of(scene), "loss_and_grads",
                                           self._loss_and_grads, (scene,), scene)
        return loss.clone(), {k: v.clone() for k, v in pred.items()}, grads

    def _slot(self, scenes: Sequence):
        """This rank's (scene graph, weight) of a group of at most ``n_data``
        scenes (``parallel.pad_scene_group``); a group needs a mesh."""
        from gasfm_tpu_torch.parallel import pad_scene_group

        if self.mesh is None:
            raise ValueError("a group of scenes is a mesh session's: make the session with "
                             "its rank's mesh")
        slots, weights = pad_scene_group(list(scenes), self.mesh.n_data)
        return self._as_graph(slots[self.mesh.data_slot]), weights[self.mesh.data_slot]

    def group_loss_and_grads(self, scenes: Sequence, plain: bool = False
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
        """A mesh session's group of at most ``n_data`` scenes (scene graphs of
        this session, or ``SceneData``) as :meth:`fused_group_step` takes it:
        (the sum of the scenes' losses, the predictions of this rank's
        slot's scene, whole, the gradients of the sum, the same on every
        rank)."""
        scene, weight = self._slot(scenes)
        loss, pred, grads = self._mesh_loss_and_grads(scene, weight, plain)
        return self.mesh.sum_over_data(loss), self._whole(pred, scene.graph), grads

    def _mesh_loss_and_grads(self, scene, weight: float, plain: bool = False):
        """This rank's (loss x weight, predictions, gradients summed over all
        ranks): the forward and backward of its edge shard under the edge
        group's reductions, the loss scaled by the slot's weight before the
        backward (the JAX package's ``loss_func(pred, scene) * w``)."""
        with self._sharded(scene.graph):
            loss, pred, grads = self._loss_and_grads(scene, plain, weight=float(weight))
        self.mesh.sum_over_world(grads)
        return loss, pred, grads

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
        """The sum of two lists of gradients, in new tensors and in their own
        dtype, bf16 under bf16 weights (the JAX package's ``accumulate``,
        train/loop.py:297, a ``jnp.add`` per leaf): neither input is held,
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
        scenepoint heads. On a mesh, the group of one
        (:meth:`fused_group_step`)."""
        if self.mesh is not None:
            loss, repro, _, grad_norm = self.fused_group_step([scene], plain)
            return loss, repro, grad_norm
        self._check_explicit("fused_step")
        self.optimizer.set_lr()
        if plain or not self.capture:
            out = self._fused_step(scene, plain)
        else:
            out = self._recorded(self._cache.of(scene), "fused_step", self._fused_step, (scene,),
                                 scene)
            out = tuple(torch.stack(out).unbind())
        self.optimizer.advance_schedule()
        return out

    @torch.no_grad()
    def our_repro(self, pred: Dict[str, torch.Tensor], scene) -> torch.Tensor:
        """``core_errors_device``'s ``our_repro`` of whole predictions on a
        scene graph of this session (on a mesh, over the scene's edges)."""
        with edge_partitioned(None if self.mesh is None else self.mesh.edge_scope):
            return core_errors_device(pred, scene)["our_repro"]

    def _check_explicit(self, what: str) -> None:
        if self.model.depth_head_enabled:
            raise ValueError(f"{what} takes our_repro of the view and scenepoint heads' "
                             "predictions; a depth-head model trains through loss_and_grads "
                             "and update")

    def fused_group_step(self, scenes: Sequence, plain: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One training step on a group of at most ``n_data`` scenes (scene
        graphs of this session, or ``SceneData``; the JAX package's
        ``fused_group_step`` and ``make_sharded_fused_step``): data slot d
        trains on scene d, the slots past the group on its last scene with
        weight 0 (``parallel.pad_scene_group``). Returns (the sum of the
        scenes' losses, the sum of their ``our_repro``, the number of
        scenes, the global gradient norm), 0-d tensors, the same on every
        rank. Any group of at most ``n_data`` scenes takes one step, whatever
        their sizes."""
        self._check_explicit("fused_group_step")
        scene, weight = self._slot(scenes)
        self.optimizer.set_lr()
        loss, pred, grads = self._mesh_loss_and_grads(scene, weight, plain)
        grad_norm = self._update(grads)
        with torch.no_grad(), self._sharded(scene.graph):
            repro = core_errors_device(pred, scene, plain=plain)["our_repro"] * weight
        sums = self.mesh.sum_over_data(torch.stack([loss, repro, torch.full_like(loss, weight)]))
        self.optimizer.advance_schedule()
        return sums[0], sums[1], sums[2], grad_norm


# ---------------------------------------------------------------------------
# The drivers: one epoch of training, one evaluation pass, the controller
# ---------------------------------------------------------------------------

# Rows of the widest activation that a no-grad forward holds at once, per
# edge of the scene (or the rank's edge shard) by path, and per node. The
# merged path's layer step holds the previous stream, its residual and the
# init skip, then writes the new stream, its normalized copy and both
# aggregations' source rows: 7, and 1 for an operand the kernel's
# validation copies. The unfused path's composites (gathers of the node
# rows per edge, logits, the concatenated update input) and DPESFM's
# set-of-sets layers (the block's input, the edge linear, the combine, the
# mean-centered and rectified copies) stay within the doubled 16 and the 8.
# A node holds its previous and new features, their aggregation and query
# rows, the finish MLP's LayerNorm and hidden rows and the update's table
# rows, not all as wide as the widest: 8.
FORWARD_EDGE_ROWS = {"merged": 8, "unfused": 16, "dpesfm": 8}
FORWARD_NODE_ROWS = 8


def forward_bytes_bound(model: Union[GraphAttnSfMNet, SetOfSetNet], graph) -> int:
    """An upper bound of the float32 activations that ``model``'s no-grad
    forward of ``graph`` holds at once: ``FORWARD_EDGE_ROWS`` of the path's
    rows of the widest per-edge activation per edge, ``FORWARD_NODE_ROWS``
    of the widest per-point, per-view and global one per node
    (``model.activation_widths``). On a mesh ``graph`` is the rank's
    shard, whose edges are its own and whose tables are whole."""
    w_edge, w_point, w_view, w_global = model.activation_widths
    path = ("dpesfm" if isinstance(model, SetOfSetNet) else
            "merged" if model.merged_path(graph) else "unfused")
    rows = (FORWARD_EDGE_ROWS[path] * graph.num_edges * w_edge
            + FORWARD_NODE_ROWS * (graph.num_pts * w_point + graph.num_cams * w_view + w_global))
    return 4 * rows


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
                     rng: Optional[np.random.Generator], epoch: int, depth: int,
                     group_slot: Optional[Tuple[int, int]] = None):
    """The loader's batches, each as a list of (scene, the scene the model
    takes, or None for a skipped sample): the validity check, the outlier
    injection (a failed one skips the sample) and the host half of the
    model's scene's graph (``SceneData.host_graph``), on one prefetch thread
    with ``depth`` batches in flight (the JAX package's ``_prepare_batches``,
    train/loop.py:313; ``depth`` 0 runs them inline). numpy only: the
    upload is the caller's, on its own thread. The generator's draws stay
    in one thread, in the loader's order. With ``group_slot`` (a mesh rank's
    data slot and the number of slots), a batch of at most that many valid
    samples is a group of which the rank takes one slot
    (``pad_scene_group``): only that sample's graph is made."""
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
                prepared.append((curr_data, model_data))
            models = [md for _, md in prepared if md is not None]
            if group_slot is not None and 0 < len(models) <= group_slot[1]:
                models = [models[min(group_slot[0], len(models) - 1)]]
            for model_data in models:
                model_data.host_graph()
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
    injection (the JAX package's ``device_metrics``); on a mesh a batch of
    at most ``n_data`` valid samples takes one ``fused_group_step`` (each
    data slot one sample; its loss and ``our_repro`` the group's sums), each
    rank making only its slot's graph (the JAX package's group branch,
    train/loop.py:446-475, less its condition that the samples share one
    capacity: the port has no capacity buckets, and where the JAX package
    falls back to the per-sample path for samples of differing capacities
    the group step sums the same gradients, so the values agree within
    rounding); otherwise each valid
    sample takes ``loss_and_grads`` (``our_repro`` on the device with
    ``device_metrics``, else the host metrics the conf asks for, scored
    against the clean observations), their gradients summed
    (``accumulate``), then one ``update`` (on a mesh each sample a group of
    one, the JAX package's per-sample fallback, :495-520). A batch without
    a valid sample steps only the schedule. Every rank of a mesh draws the
    same batches (the loader's per-item seeds from the same generator); in
    the ``TRAINING`` phase each epoch ends with one small all-reduce that
    checks that every rank's batches held the same scenes.

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
            loss_totals["n"] += pnd.get("n_samples", n_loss)  # a group's loss is its sum
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

    mesh = session.mesh
    group_max = 1 if mesh is None else mesh.n_data
    pending = carried
    batch_idx = -1
    drawn = 0  # a digest of the scenes the epoch's batches held
    prepared_batches = _prepare_batches(
        train_loader, outlier_injection_rate, rng, epoch,
        depth=2 if phase == Phases.TRAINING else 0,
        group_slot=(mesh.data_slot, mesh.n_data) if mesh is not None and device_metrics else None)
    for batch_idx, prepared_batch in enumerate(prepared_batches):
        for curr_data, _ in prepared_batch:
            drawn = zlib.crc32(f"{curr_data.scene_name}/{curr_data.num_views};".encode(), drawn)
        valid = [(curr_data, model_data)
                 for curr_data, model_data in prepared_batch if model_data is not None]
        loss_parts: List[Any] = []
        repro_parts: List[Any] = []
        backproj_parts: List[float] = []
        grad_norm = None
        n_samples = None
        curr_scene_name = scene
        if not valid:
            # no valid sample: the reference still steps its scheduler
            # (train.py:152), not the optimizer
            session.advance_schedule()
        elif device_metrics and len(valid) <= group_max:
            curr_scene_name = valid[-1][0].scene_name
            if mesh is None:
                # the upload, on this thread (a CUDA call from the loader's
                # thread could break a recording made here)
                loss, repro, grad_norm = session.fused_step(session.scene_graph(valid[0][1]))
            else:  # a group: the rank makes its slot's graph only
                loss, repro, _, grad_norm = session.fused_group_step([md for _, md in valid])
                n_samples = len(valid)
            loss_parts.append(loss)
            repro_parts.append(repro)
        else:
            grads_sum = None
            for curr_data, model_data in valid:
                scene_graph = session.scene_graph(model_data)
                curr_scene_name = curr_data.scene_name
                loss, pred, grads = session.loss_and_grads(scene_graph)
                if device_metrics:
                    repro_parts.append(session.our_repro(pred, scene_graph))
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
        if n_samples is not None:
            pending["n_samples"] = n_samples
        n_updates += 1  # the reference steps the scheduler every batch

    if mesh is not None and phase == Phases.TRAINING:
        mesh.assert_same(drawn, f"the scenes of epoch {epoch}'s batches")
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
    with their ``Mean`` row. The scenes go through ``forward_group`` in
    groups of one, or on a mesh of ``n_data``, each data slot on its own
    scene (the JAX package's grouped evaluation, train/loop.py:648-720): a
    group is made when its last scene is drawn, a rank makes its own slot's
    graph only, before the clock starts, and ``Inference time`` is the
    group's time over its scenes. On a mesh every rank runs the forwards
    (they are collective) and only rank 0 the rest; the others return
    None. There a scene whose preparation runs a rank out of memory gets
    its row of NaNs on every rank. Unless ``crash_on_scene_exhausting_memory``,
    each rank also reserves, before the group's forward, an upper bound of
    its slot's forward (``TrainingSession.reserve_forward``), and a group
    that would not fit on some rank gets its rows of NaNs on every rank (the
    JAX package's dummy rows of a grouped forward that ran out of memory,
    train/loop.py:697-716): one all-reduce per group agrees on both. A
    forward that still runs out of memory after its reservation raises: the
    other ranks are inside its all-reduces."""
    from gasfm_tpu_torch.data.outliers import inject_outliers

    additional_identifiers = list(additional_identifiers or [])
    explicit = (conf.get_bool("model.view_head.enabled")
                and conf.get_bool("model.scenepoint_head.enabled"))
    if weights is not None:
        session.load_weights(weights)

    def _post(curr_data, graph, pred, pred_time):
        pred_np = predictions_to_host(pred, curr_data, graph)
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

    def _dummy(curr_data):
        errors = get_dummy_errors(conf, bundle_adjustment)
        errors["Inference time"] = float("nan")
        errors["Scene"] = curr_data.scene_name
        return errors

    def _tolerate(e: BaseException, curr_data) -> None:
        if not _is_oom_error(e) or crash_on_scene_exhausting_memory:
            raise e
        print(f"Ran out of memory when evaluating on {curr_data.scene_name}.")

    def _model_data(curr_data):
        if outlier_injection_rate is None:
            return curr_data
        injected = inject_outliers(curr_data, outlier_injection_rate, rng=rng)
        assert injected is not None
        return injected

    mesh = session.mesh
    n_slots, own = (1, 0) if mesh is None else (mesh.n_data, mesh.data_slot)

    def _rows(group):  # [(scene, the scene the model takes)] -> their rows
        # the rank's own slot's graph, made before the clock starts (a short
        # group's padding slots repeat its last scene), and on a mesh the
        # reservation of its forward; the ranks agree through one all-reduce
        # on the scenes that failed here, which get their dummy rows while
        # the others go on as a smaller group, and on a forward that would
        # not fit, whose group gets its dummy rows
        mine = min(own, len(group) - 1)
        scenes, failed, unfit = [md for _, md in group], [False] * len(group), False
        try:
            scenes[mine] = session.scene_graph(scenes[mine])
        except Exception as e:  # noqa: BLE001 - the reference's OOM tolerance
            _tolerate(e, group[mine][0])
            failed[mine] = True
        if mesh is not None:
            if not crash_on_scene_exhausting_memory and not failed[mine]:
                try:
                    session.reserve_forward(scenes[mine])
                except torch.cuda.OutOfMemoryError:
                    unfit = True
            *failed, unfit = mesh.any_over_world(failed + [unfit])
        if any(failed):
            rest = iter(_rows([g for g, f in zip(group, failed) if not f]) if not all(failed)
                        else ())
            return [_dummy(c) if f else next(rest) for (c, _), f in zip(group, failed)]
        if unfit:
            if session.is_writer:
                for curr_data, _ in group:
                    print(f"Ran out of memory when evaluating on {curr_data.scene_name}.")
            return [_dummy(c) for c, _ in group]
        try:
            _sync(session.device)
            begin = time()
            preds = session.forward_group(scenes)
            _sync(session.device)
        except Exception as e:  # noqa: BLE001 - the reference's OOM tolerance
            if mesh is not None:  # collective: the other ranks are inside its all-reduces
                raise
            _tolerate(e, group[0][0])
            return [_dummy(group[0][0])]
        pred_time = (time() - begin) / len(group)
        if not session.is_writer:
            return [None] * len(group)
        rows = []
        try:
            for (curr_data, model_data), scene, pred in zip(group, scenes, preds):
                graph = (scene.graph if hasattr(scene, "graph") else
                         model_data.host_graph() if "depths" in pred else None)
                rows.append(_post(curr_data, graph, pred, pred_time))
        except Exception as e:  # noqa: BLE001 - the reference's OOM tolerance
            _tolerate(e, group[len(rows)][0])
            rows += [_dummy(curr_data) for curr_data, _ in group[len(rows):]]
        return rows

    errors_list, group = [], []
    for j, batch_data in enumerate(data_loader):
        if log_memory_consumption:
            print(f"Scene batch {j + 1}/{len(data_loader)}.")
        for curr_data in batch_data:
            try:
                group.append((curr_data, _model_data(curr_data)))
            except Exception as e:  # noqa: BLE001 - the reference's OOM tolerance
                _tolerate(e, curr_data)
                errors_list.append(_dummy(curr_data))
                continue
            if len(group) == n_slots:
                errors_list += _rows(group)
                group = []
    if group:
        errors_list += _rows(group)
    return eval_errors_list2df(errors_list) if session.is_writer else None


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

    # on a mesh only rank 0 logs and writes files (every rank trains)
    writer = session.is_writer
    tb_writer = get_tb_writer(conf) if writer else None

    def save(name: str, what) -> None:
        if writer:
            save_params(models_path(name), what)
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
        if not writer:
            return
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

    def track_best(epoch: int, validation_errors: Optional[Table]) -> float:
        # on a mesh rank 0 alone has the table: every rank takes its metric,
        # and keeps its own copy of the weights, bitwise rank 0's
        metric = (aggregate_val_metric(validation_errors, metric_column=validation_metric)
                  if writer else float("nan"))
        if session.mesh is not None:
            metric = session.mesh.from_writer(metric)
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
                save("best_model.npz", best["weights"])
        if finetune_dump_model_interval is not None:
            save(f"model_epoch{0:06d}.npz", session.model)

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

        if will_save and writer:
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
                save(f"model_epoch{epoch + 1:06d}.npz", session.model)

    profiler.close()
    save("final_model.npz", session.model)
    trained = {"final_model": session.weights()}
    train_stats = get_dummy_train_stats()
    if validation_metric is not None:
        trained["best_model"] = (best["weights"] if best["weights"] is not None
                                 else trained["final_model"])
        save("best_model.npz", trained["best_model"])
        # unindexed, as the JAX package's DataFrame (train/loop.py:1148-1153)
        train_stats = Table.from_records([{
            "": 0, "Convergence time": best["time"], "best_epoch": best["epoch"] + 1,
            "best_validation_metric": best["metric"],
            "final_validation_metric": final_validation_metric}], index="")
    if writer:
        tb_writer.flush()
    return trained, train_stats
