"""The (data, edge) mesh on torch.distributed: scene data parallelism and
edge partitioning over replicated tables.

Counterpart of the JAX package's parallel/edge_sharding.py, steps 1-2 of
its layout (``parallel.table_sharding = false``): a mesh of ``n_data x
n_edge`` positions, one process (rank) each. Rank ``r`` takes position
``(r // n_edge, r % n_edge)``, the layout of ``make_mesh``'s
``reshape(n_data, n_edge)`` (``edge_sharding.py:163``):

- data slot ``r // n_edge``: the scene of a group of at most ``n_data``
  scenes that the rank trains on (a short group repeats its last scene in
  slots of weight 0, :func:`pad_scene_group`);
- edge shard ``r % n_edge``: the contiguous range of the scene's
  point-major edges that the rank holds
  (``graph.view_graph.shard_host_graph``); every table stays whole on every
  rank.

Three process groups: the edge group (the ranks of one data slot: the
reductions over a scene's edges, ``ops/segment.py`` ``edge_partitioned``),
the data group (the ranks of one edge shard: the sums of the loss and the
metrics over the slots) and the world (the gradient sum, one all-reduce of
one flat buffer per dtype, and the start-up broadcast of rank 0's weights).
Every collective is an ``all_reduce`` or a ``broadcast``, which gloo runs on
CPU and CUDA tensors alike (through host memory for CUDA): the ranks may
share one card, where NCCL refuses two ranks on one device.

What the JAX package runs and the port does not yet raises
``NotImplementedError`` naming the slice that lifts it
(:func:`mesh_shape_from_conf`): table sharding (an ``n_edge > 1`` mesh with
``parallel.table_sharding`` null or true, the JAX default there), and
multi-host ``parallel.distributed``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from gasfm_tpu_torch.ops.segment import flat_collective

TABLE_SHARDING_SLICE = ("table sharding (slice 8, step 3: the owned-point mask and the "
                        "neighbour exchange of boundary windows) is not ported yet")


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
    position. Raises ``NotImplementedError`` for what the port does not run
    yet: ``parallel.distributed.enabled`` (multi-host) and, with ``n_edge >
    1``, ``parallel.table_sharding`` null or true (the JAX package's default
    there turns table sharding on, ``train/loop.py:100-105``; replicated
    tables would be another layout than the conf asks for)."""
    if conf.get_bool("parallel.distributed.enabled", default=False):
        raise NotImplementedError(
            "parallel.distributed.enabled: multi-host execution (one process group across "
            "hosts, slice 8 after table sharding) is not ported yet")
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
    if n_edge > 1 and conf.get_bool("parallel.table_sharding", default=None) is not False:
        raise NotImplementedError(
            f"parallel.mesh_shape = {shape} with parallel.table_sharding null or true: "
            f"{TABLE_SHARDING_SLICE}; set parallel.table_sharding = false for replicated "
            f"tables")
    return n_data, n_edge


def pad_scene_group(scenes: Sequence, n_data: int) -> Tuple[list, List[float]]:
    """At most ``n_data`` scenes as ``n_data`` slots: a short group repeats
    its last scene in slots of weight 0 (``edge_sharding.py:268``), whose
    loss, metrics and gradients count for nothing. Returns (slots,
    weights)."""
    if not 1 <= len(scenes) <= n_data:
        raise ValueError(f"a group of {len(scenes)} scenes for {n_data} data slots")
    slots = list(scenes) + [scenes[-1]] * (n_data - len(scenes))
    return slots, [1.0] * len(scenes) + [0.0] * (n_data - len(scenes))
