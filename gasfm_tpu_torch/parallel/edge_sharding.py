"""The (data, edge) mesh on torch.distributed: scene data parallelism, edge
partitioning, and table sharding.

Counterpart of the JAX package's parallel/edge_sharding.py: a mesh of
``n_data x n_edge`` positions, one process (rank) each. Rank ``r`` takes position
``(r // n_edge, r % n_edge)``, the layout of ``make_mesh``'s
``reshape(n_data, n_edge)`` (``edge_sharding.py:163``):

- data slot ``r // n_edge``: the scene of a group of at most ``n_data``
  scenes that the rank trains on (a short group repeats its last scene in
  slots of weight 0, :func:`pad_scene_group`);
- edge shard ``r % n_edge``: the contiguous range of the scene's
  point-major edges that the rank holds
  (``graph.view_graph.shard_host_graph``).

With ``parallel.table_sharding = false`` every table stays whole on every
rank (replicated tables). Table sharding, the JAX default on an edge axis
(null: on when ``n_edge > 1``, :func:`table_sharding_on`; the JAX package's
``_table_shard_ctx``, :286-299), keeps the camera and global tables whole
but shards the point table: a rank's point aggregations are exact on the
points its edges touch, the shards exchange only their boundary points'
rows (``ops/attn_combine.py``), the point->global pool reduces each rank's
owned points, and the point table that leaves the model (``pts3D``) is put
together by one masked sum over the edge group (:func:`sum_owned_points`,
the JAX package's ``_combine_table_outputs``, :302-316). The exchange needs
every point's edges on at most two neighbouring shards
(:func:`check_table_shard_contract`).

Three process groups: the edge group (the ranks of one data slot: the
reductions over a scene's edges, ``ops/segment.py`` ``edge_partitioned``),
the data group (the ranks of one edge shard: the sums of the loss and the
metrics over the slots) and the world (the gradient sum, one all-reduce of
one flat buffer per dtype, and the start-up broadcast of rank 0's weights).
Every collective is an ``all_reduce`` or a ``broadcast``, which gloo runs on
CPU and CUDA tensors alike (through host memory for CUDA): the ranks may
share one card, where NCCL refuses two ranks on one device.

Multi-host ``parallel.distributed`` (:func:`distributed_from_conf`, the
counterpart of the JAX package's ``initialize_distributed``, :212): one
launcher per host, each with its ``process_id``, launches ``n_data * n_edge
/ num_processes`` local ranks; the global rank is ``process_id x local +
local rank``, the JAX package's process-major device order, so the layout
above, the groups and the writer (global rank 0) keep their meaning. The
ranks of every launcher meet on a TCP store at ``coordinator_address``,
which process 0's launcher hosts (``launch.run_ranks``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gasfm_tpu_torch.ops.segment import flat_collective


@dataclasses.dataclass
class Mesh:
    """This rank's place in an ``n_data x n_edge`` mesh, its device and its
    process groups (:func:`make_mesh`)."""

    n_data: int
    n_edge: int
    rank: int
    device: torch.device
    edge_group: object
    data_group: object

    @property
    def size(self) -> int:
        return self.n_data * self.n_edge

    @property
    def data_slot(self) -> int:
        return self.rank // self.n_edge

    @property
    def edge_shard(self) -> int:
        return self.rank % self.n_edge

    @property
    def edge_scope(self):
        """The group that the reductions over a scene's edges finish over
        (``ops/segment.py`` ``edge_partitioned``): the edge group, or None
        when each rank holds whole scenes."""
        return self.edge_group if self.n_edge > 1 else None

    @property
    def is_writer(self) -> bool:
        """Rank 0 prints, writes the experiment's files and runs BA."""
        return self.rank == 0

    def broadcast(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values of ``tensors`` into every rank's, in place: one
        broadcast per dtype of one flat buffer."""
        for group in _by_dtype(tensors):
            _copy_back(flat_collective(group, None, src=0), group)

    def sum_over_world(self, tensors: Sequence[torch.Tensor]) -> None:
        """Every rank's ``tensors`` summed over all ranks, in place: one
        all-reduce per dtype of one flat buffer (the gradient sum)."""
        for group in _by_dtype(tensors):
            _copy_back(flat_collective(group, None), group)

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data group (the ranks of this edge shard):
        the slots' sums of the loss and the metrics."""
        return flat_collective([x], self.data_group)[0] if self.n_data > 1 else x.detach().clone()

    def sum_over_edges(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the edge group (a zero-filled per-edge buffer
        whose range this rank filled: the scene's whole output)."""
        return flat_collective([x], self.edge_group)[0] if self.n_edge > 1 else x.detach().clone()

    def from_writer(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (a host metric that only rank 0
        computes, such as the validation metric)."""
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        return float(flat_collective([t], None, src=0)[0])

    def any_over_world(self, flags: Sequence[bool]) -> List[bool]:
        """Each of ``flags`` true on any rank, on every rank: one all-reduce
        MAX."""
        import torch.distributed as dist

        t = torch.tensor([int(f) for f in flags], dtype=torch.int64)
        return [bool(v) for v in flat_collective([t], None, dist.ReduceOp.MAX)[0].tolist()]

    def assert_same(self, digest: int, what: str) -> None:
        """Raise on every rank unless every rank's ``digest`` (an integer
        below 2**62) is the same: one all-reduce MAX of (digest, -digest)."""
        import torch.distributed as dist

        t = torch.tensor([digest, -digest], dtype=torch.int64)
        hi, neg_lo = flat_collective([t], None, dist.ReduceOp.MAX)[0].tolist()
        if hi != -neg_lo:
            raise RuntimeError(f"the ranks of the mesh disagree on {what}")


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def _copy_back(values: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor]) -> None:
    with torch.no_grad():
        torch._foreach_copy_(list(tensors), list(values))


def make_mesh(n_data: int, n_edge: int, device: torch.device) -> Mesh:
    """The mesh of this rank in the initialized default process group of
    ``n_data * n_edge`` ranks: its position and its edge and data groups
    (every rank makes every group, in the same order, as
    ``torch.distributed.new_group`` asks)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if world != n_data * n_edge:
        raise ValueError(f"a [{n_data}, {n_edge}] mesh needs {n_data * n_edge} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    edge_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_edge + e for e in range(n_edge)])
        if rank // n_edge == d:
            edge_group = g
    for e in range(n_edge):
        g = dist.new_group([d * n_edge + e for d in range(n_data)])
        if rank % n_edge == e:
            data_group = g
    return Mesh(n_data=n_data, n_edge=n_edge, rank=rank, device=torch.device(device),
                edge_group=edge_group, data_group=data_group)


def mesh_shape_from_conf(conf) -> Optional[Tuple[int, int]]:
    """``parallel.mesh_shape = [n_data, n_edge]`` (the JAX package's
    ``mesh_from_conf``, ``edge_sharding.py:251``): None when unset or of one
    position. Whether the mesh shards its point table is
    ``parallel.table_sharding`` (:func:`table_sharding_on`); whether its
    ranks span hosts, ``parallel.distributed`` (:func:`distributed_from_conf`)."""
    shape = conf.get_list("parallel.mesh_shape", default=None)
    if shape is None:
        return None
    if len(shape) != 2:
        raise ValueError(f"parallel.mesh_shape must be [data, edge], got {shape}")
    n_data, n_edge = int(shape[0]), int(shape[1])
    if n_data < 1 or n_edge < 1:
        raise ValueError(f"parallel.mesh_shape = {shape}: both sizes must be >= 1")
    if n_data * n_edge <= 1:
        return None
    return n_data, n_edge


@dataclasses.dataclass(frozen=True)
class Distributed:
    """One host's place in a multi-host mesh (``parallel.distributed``):
    the TCP store's ``host`` and ``port`` (process 0's launcher hosts it),
    the number of launcher processes and this one's id."""

    host: str
    port: int
    num_processes: int
    process_id: int

    def local_ranks(self, world: int) -> range:
        """The global ranks of this process's launcher in a mesh of
        ``world`` ranks: ``process_id x local`` onwards, ``local = world /
        num_processes``."""
        local = world // self.num_processes
        return range(self.process_id * local, (self.process_id + 1) * local)


def distributed_from_conf(conf) -> Optional[Distributed]:
    """``parallel.distributed.{enabled, coordinator_address ("host:port"),
    num_processes, process_id}``: None unless enabled, else this process's
    :class:`Distributed` (the port's counterpart of the JAX package's
    ``initialize_distributed``, ``edge_sharding.py:212``, which starts the
    JAX runtime with them). Where the JAX package detects a missing key
    from a TPU pod's or a cluster's metadata, which has no counterpart
    here, a missing key raises ``ValueError`` naming it; so does a mesh
    (:func:`mesh_shape_from_conf`) of one position, or of a number of ranks
    that ``num_processes`` does not divide (each process launches as many
    ranks)."""
    if not conf.get_bool("parallel.distributed.enabled", default=False):
        return None
    values = {k: conf.get(f"parallel.distributed.{k}", default=None)
              for k in ("coordinator_address", "num_processes", "process_id")}
    for k, v in values.items():
        if v is None:
            raise ValueError(f"parallel.distributed.enabled: parallel.distributed.{k} is not "
                             f"set (the port does not detect it from a cluster's metadata)")
    host, _, port = str(values["coordinator_address"]).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"parallel.distributed.coordinator_address must be \"host:port\", got "
                         f"{values['coordinator_address']!r}")
    n_proc, pid = int(values["num_processes"]), int(values["process_id"])
    if n_proc < 1 or not 0 <= pid < n_proc:
        raise ValueError(f"parallel.distributed: process_id {pid} of num_processes {n_proc}")
    shape = mesh_shape_from_conf(conf)
    world = 1 if shape is None else shape[0] * shape[1]
    if shape is None or world % n_proc:
        raise ValueError(f"parallel.distributed.num_processes = {n_proc} must divide the "
                         f"ranks of parallel.mesh_shape ({world}), a mesh of more than one "
                         f"position: each process launches as many ranks")
    return Distributed(host=host, port=int(port), num_processes=n_proc, process_id=pid)


def table_sharding_on(setting: Optional[bool], n_edge: int) -> bool:
    """Whether a mesh of ``n_edge`` edge shards shards the point table under
    ``parallel.table_sharding = setting``: null means on when ``n_edge > 1``
    (the JAX package's default, ``_table_shard_ctx``); with one edge shard
    there is nothing to shard."""
    return n_edge > 1 and setting is not False


def check_table_shard_contract(pt_ptr: np.ndarray, n_edge: int) -> None:
    """The boundary exchange's contract on a whole scene (point CSR offsets
    ``pt_ptr``, on the host; the JAX package's
    ``check_table_shard_contract``, :111-160, per window there, per point
    here): every edge shard gets an edge, and no point's edges touch more
    than two shards, since the exchange reaches the neighbours only. Raises
    ``ValueError`` otherwise."""
    from gasfm_tpu_torch.graph.view_graph import point_spans

    if n_edge <= 1:
        return
    E = int(pt_ptr[-1])
    per = -(-E // n_edge) if E else 0
    if E == 0 or (n_edge - 1) * per >= E:
        raise ValueError(f"table sharding span<=2 contract: a scene of {E} edges leaves an edge "
                         f"shard of {n_edge} without an edge; use fewer edge shards or a larger "
                         f"scene")
    spans = point_spans(pt_ptr, n_edge)
    if spans.max(initial=0) > 2:
        p = int(np.argmax(spans))
        raise ValueError(f"table sharding span<=2 contract violated: point {p}'s "
                         f"{int(pt_ptr[p + 1] - pt_ptr[p])} edges touch {int(spans[p])} of "
                         f"{n_edge} edge shards ({per} edges each); the boundary exchange only "
                         f"reaches neighbour shards. Use fewer edge shards or a larger scene")


def sum_owned_points(pts3D: torch.Tensor, shard, group) -> torch.Tensor:
    """A table-sharded rank's (4, n) point predictions made whole: its owned
    columns kept, the others zero, summed over the edge ``group`` (each
    column owned by one rank)."""
    own = torch.zeros_like(pts3D)
    own[:, shard.own_lo:shard.own_hi] = pts3D[:, shard.own_lo:shard.own_hi]
    return flat_collective([own], group)[0]


def pad_scene_group(scenes: Sequence, n_data: int) -> Tuple[list, List[float]]:
    """At most ``n_data`` scenes as ``n_data`` slots: a short group repeats
    its last scene in slots of weight 0 (``edge_sharding.py:268``), whose
    loss, metrics and gradients count for nothing. Returns (slots,
    weights)."""
    if not 1 <= len(scenes) <= n_data:
        raise ValueError(f"a group of {len(scenes)} scenes for {n_data} data slots")
    slots = list(scenes) + [scenes[-1]] * (n_data - len(scenes))
    return slots, [1.0] * len(scenes) + [0.0] * (n_data - len(scenes))
