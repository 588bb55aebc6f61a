"""Edge-centric view graph in compressed-sparse-row form.

Counterpart of the JAX package's graph/view_graph.py (``ViewGraph``,
``build_view_graph``), without that layout's TPU devices: no per-window
padding to a chunk multiple, no bucketed capacities, no point-window ids and
no lane packing. Those existed for the TPU's windowed one-hot matmuls and
XLA's fixed shapes; here every array holds real rows only.

Layout:
- The E valid observations are sorted by (point, camera), exactly as
  ``np.lexsort((rows, cols))`` orders them in the JAX package's
  ``build_view_graph``, so the edges of one point are contiguous:
  ``pt_ptr`` (n+1) are their CSR offsets.
- ``cam_perm`` (E) lists the edges camera by camera (stable, so point order
  within a camera), with CSR offsets ``cam_ptr`` (m+1). The camera side of
  every segment reduction walks ``cam_perm[cam_ptr[c]:cam_ptr[c+1]]``.
- ``uv`` holds the normalized (N-applied) observations.

All of it is built once per scene on the host with numpy, in two halves:
:func:`build_host_scene_graph` (numpy only, no device: the CSR, the camera
permutation and both sides' splits by length, so a loader's thread can make
it) and :func:`upload` (the arrays to the device, through pinned memory and
asynchronous copies on the card). A graph's splits are read on the host,
so a step on a new scene makes no device-to-host copy.

An edge mesh's rank holds one shard of a scene (:func:`shard_host_graph`,
the counterpart of the JAX package's ``_EDGE_FIELDS`` /
``scene_graph_specs``, ``gasfm_tpu/parallel/edge_sharding.py:47-49, :194``):
a contiguous range of the point-major edges, with CSR offsets over all the
scene's points and cameras and every split recomputed for its own edges,
while the tables (``Ns``, ``Ps_gt``), the validity masks and each segment's
count (``pt_count`` / ``cam_count``) stay the whole scene's. Each shard
also knows, on the host, its place in the scene's point table
(:class:`TableShard`, the counterpart of the JAX package's
``compute_owned_points``, ``gasfm_tpu/parallel/edge_sharding.py:82-108``,
which finds it inside the trace with a ``ppermute`` of window ids): its
first and last touched point, whether a neighbour shard shares each, and
the range of points it owns. Table sharding reads it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import numpy as np
import torch

from gasfm_tpu_torch.geometry.np_geo import get_M_valid_points, normalize_M
from gasfm_tpu_torch.utils.constants import MIN_N_POINTS_PER_VIEW, MIN_N_VIEWS_PER_POINT
from gasfm_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TableShard:
    """An edge shard's place in its scene's point table (host ints).

    The shard's point-major edges touch the contiguous points ``[first,
    last]``; only ``first`` can also have edges on the shard to the left
    (``shared_left``) and only ``last`` on the shard to the right
    (``shared_right``). Point p belongs to the shard whose edge range holds
    ``pt_ptr[p]``, so every point has exactly one owner, a point without
    edges too (the last shard owns position E): the shard owns
    ``[own_lo, own_hi)``. The boundary exchange holds only while no point's
    edges touch more than two shards (``check_table_shard_contract``)."""

    shard: int
    n_shards: int
    first: int
    last: int
    shared_left: bool
    shared_right: bool
    own_lo: int
    own_hi: int


def point_spans(pt_ptr: np.ndarray, n_shards: int) -> np.ndarray:
    """(n,) the number of edge shards (:func:`edge_shard_range`) that each
    point's edges touch, 0 for a point without edges."""
    ptr = np.asarray(pt_ptr, dtype=np.int64)
    per = max(-(-int(ptr[-1]) // n_shards), 1)
    deg = ptr[1:] - ptr[:-1]
    return np.where(deg > 0, (ptr[1:] - 1) // per - ptr[:-1] // per + 1, 0)


def table_shard(pt_ptr: np.ndarray, pt_idx: np.ndarray, shard: int, n_shards: int) -> TableShard:
    """The :class:`TableShard` of edge shard ``shard`` of ``n_shards`` of a
    whole scene with point CSR offsets ``pt_ptr`` and edge points ``pt_idx``
    (numpy, on the host: no collective)."""
    E = int(pt_ptr[-1])
    lo, hi = edge_shard_range(E, shard, n_shards)
    starts = np.asarray(pt_ptr[:-1], dtype=np.int64)
    n = starts.shape[0]
    own_lo = int(np.searchsorted(starts, lo, side="left"))
    own_hi = n if shard == n_shards - 1 else int(np.searchsorted(starts, hi, side="left"))
    first, last = int(pt_idx[lo]), int(pt_idx[hi - 1])
    return TableShard(shard=shard, n_shards=n_shards, first=first, last=last,
                      shared_left=bool(lo > 0 and pt_idx[lo - 1] == first),
                      shared_right=bool(hi < E and pt_idx[hi] == last),
                      own_lo=own_lo, own_hi=own_hi)


@dataclasses.dataclass(frozen=True)
class ViewGraph:
    """Bipartite camera x point graph over the valid observations."""

    uv: torch.Tensor  # (E, 2) float32 normalized observations
    cam_idx: torch.Tensor  # (E,) int32 camera of each edge
    pt_idx: torch.Tensor  # (E,) int32 point of each edge (non-decreasing)
    pt_ptr: torch.Tensor  # (n+1,) int32 point CSR offsets into the edges
    cam_perm: torch.Tensor  # (E,) int32 edges in camera-major order
    cam_ptr: torch.Tensor  # (m+1,) int32 camera CSR offsets into cam_perm
    cam_valid: torch.Tensor  # (m,) bool — >= MIN_N_POINTS_PER_VIEW observations
    pt_valid: torch.Tensor  # (n,) bool — >= MIN_N_VIEWS_PER_POINT observations
    # an edge shard's (shard_host_graph), else the defaults: the whole
    # scene's number of edges, the scene's index of the shard's first edge,
    # the scene's (cam_idx, pt_idx), numpy on the host, and the shard's
    # place in the point table
    scene_num_edges: Optional[int] = None
    edge_offset: int = 0
    scene_ids: Optional[tuple] = dataclasses.field(default=None, compare=False)
    table_shard: Optional[TableShard] = None

    @property
    def num_cams(self) -> int:
        return self.cam_valid.shape[0]

    @property
    def num_pts(self) -> int:
        return self.pt_valid.shape[0]

    @property
    def num_edges(self) -> int:
        return self.cam_idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.uv.device

    @property
    def scene_edges(self) -> int:
        """The whole scene's edges: ``num_edges``, or on an edge shard the
        scene's (the mean over the edges divides by it)."""
        return self.num_edges if self.scene_num_edges is None else self.scene_num_edges

    def scene_edge_ids(self):
        """(camera, point) of each of the whole scene's edges, numpy int32
        on the host: this graph's, or on an edge shard the scene's."""
        if self.scene_ids is None:
            return self.cam_idx.cpu().numpy(), self.pt_idx.cpu().numpy()
        return self.scene_ids

    @functools.cached_property
    def pt_count(self) -> torch.Tensor:
        """(n,) float32 edges per point, at least 1 (an empty segment's sum
        is 0 and stays 0), from the CSR offsets; computed once (an edge
        shard's are the scene's, set when it is uploaded)."""
        return (self.pt_ptr[1:] - self.pt_ptr[:-1]).clamp_min(1).to(torch.float32)

    @functools.cached_property
    def cam_count(self) -> torch.Tensor:
        """(m,) float32 edges per camera, at least 1, from the CSR offsets;
        computed once."""
        return (self.cam_ptr[1:] - self.cam_ptr[:-1]).clamp_min(1).to(torch.float32)

    def pt_chunks(self, rows: int, long_above: Optional[int] = None) -> "SegmentChunks":
        """The points split by length at ``rows`` edges (:func:`split_segments`;
        those of more than ``long_above`` edges, ``rows`` by default, are
        long), built on the host once per graph and arguments: the point-side
        kernels take it on every call."""
        return self._chunks("pt", self.pt_ptr, rows, long_above)

    def cam_chunks(self, rows: int, long_above: Optional[int] = None) -> "SegmentChunks":
        """The cameras split likewise over ``cam_ptr``: a chunk's
        ``chunk_begin`` indexes ``cam_perm``. Built once per graph and
        arguments for the dual attention and the segment sum."""
        return self._chunks("cam", self.cam_ptr, rows, long_above)

    def _chunks(self, side: str, ptr: torch.Tensor, rows: int,
                long_above: Optional[int]) -> "SegmentChunks":
        cache = self.__dict__.setdefault(f"_{side}_chunks", {})
        key = (rows, rows if long_above is None else long_above)
        if key not in cache:
            # an uploaded graph keeps its offsets on the host too (no copy
            # back from the device); a graph made from tensors reads them
            host = self.__dict__.get("_host_ptr", {}).get(side)
            cache[key] = split_segments(ptr.cpu().numpy() if host is None else host, rows,
                                        self.device, key[1])
        return cache[key]


@dataclasses.dataclass(frozen=True)
class SegmentChunks:
    """Segments of a CSR split by length. A segment of at most
    ``long_above`` edges (an argument of :func:`split_segments`, ``rows`` by
    default; empty ones too) is short and stands alone; a longer one is long
    and is cut into chunks of ``rows`` edges, the last one ragged.

    ``long_seg`` (n_long,) lists the long segments in order, ``long_ptr``
    (n_long + 1,) their CSR offsets into the chunks; chunk k belongs to
    segment ``chunk_seg[k]`` and starts at edge ``chunk_begin[k]``.
    ``table`` holds the four, int32, on the graph's device, laid out
    [chunk_seg | chunk_begin | long_seg | long_ptr] for the kernels."""

    rows: int
    long_seg: np.ndarray
    long_ptr: np.ndarray
    chunk_seg: np.ndarray
    chunk_begin: np.ndarray
    table: torch.Tensor

    @property
    def n_long(self) -> int:
        return self.long_seg.shape[0]

    @property
    def n_chunks(self) -> int:
        return self.chunk_seg.shape[0]


def split_segments(ptr: np.ndarray, rows: int, device=None,
                   long_above: Optional[int] = None) -> SegmentChunks:
    """Split the segments of the CSR offsets ``ptr`` (S + 1,): those of more
    than ``long_above`` edges (default ``rows``) are long and cut into
    chunks of ``rows`` edges (see :class:`SegmentChunks`)."""
    parts = _split_parts(ptr, rows, long_above)
    table = torch.as_tensor(np.concatenate(list(parts.values())), device=device)
    return SegmentChunks(rows=rows, table=table, **parts)


def _split_parts(ptr: np.ndarray, rows: int, long_above: Optional[int] = None) -> dict:
    """The four int32 arrays of :class:`SegmentChunks`, in its table's order."""
    long_above = rows if long_above is None else long_above
    ptr = np.asarray(ptr, dtype=np.int64)
    deg = ptr[1:] - ptr[:-1]
    long_seg = np.flatnonzero(deg > long_above)
    per = -(-deg[long_seg] // rows)
    long_ptr = np.zeros(long_seg.shape[0] + 1, dtype=np.int64)
    np.cumsum(per, out=long_ptr[1:])
    chunk_seg = np.repeat(long_seg, per)
    within = np.arange(chunk_seg.shape[0]) - np.repeat(long_ptr[:-1], per)
    chunk_begin = ptr[chunk_seg] + rows * within
    parts = dict(chunk_seg=chunk_seg, chunk_begin=chunk_begin, long_seg=long_seg,
                 long_ptr=long_ptr)
    return {k: v.astype(np.int32) for k, v in parts.items()}


@dataclasses.dataclass(frozen=True)
class SceneGraph:
    """A graph plus the per-scene camera-side arrays the model & loss need."""

    graph: ViewGraph
    Ns: torch.Tensor  # (m, 3, 3) normalization matrices (inv(K) if calibrated)
    Ns_inv: torch.Tensor  # (m, 3, 3) their inverses (K if calibrated)
    Ps_gt: torch.Tensor  # (m, 3, 4) GT cameras
    gt_depths: Optional[torch.Tensor] = None  # (E,) float32 GT depth per edge, or None


def host_split_keys():
    """The (rows, long_above) splits the kernels take, per side: the dual
    core's and the attention's (``SPLIT_ROWS``, ``ATTEND_CHUNK``), the
    segment walk's (``SUM_PART_ROWS`` over ``SUM_ROWS``) and the loss's
    point side (over ``LONG_POINT``). A host graph holds them all."""
    from gasfm_tpu_torch.ops.kernels.fused_attn import ATTEND_CHUNK
    from gasfm_tpu_torch.ops.kernels.fused_dual_attn import SPLIT_ROWS
    from gasfm_tpu_torch.ops.kernels.fused_loss import LONG_POINT
    from gasfm_tpu_torch.ops.kernels.segment_kernels import SUM_PART_ROWS, SUM_ROWS

    both = {(SPLIT_ROWS, SPLIT_ROWS), (SUM_PART_ROWS, SUM_ROWS)}
    return {"pt": sorted(both | {(ATTEND_CHUNK, ATTEND_CHUNK), (SUM_PART_ROWS, LONG_POINT)}),
            "cam": sorted(both)}


@dataclasses.dataclass(frozen=True)
class HostSceneGraph:
    """The host half of a :class:`SceneGraph`: the same arrays in numpy
    (int32 indices, float32 values, bool masks), and each side's splits
    (:func:`host_split_keys`) as :class:`SegmentChunks`' four arrays. Built
    without a device; :func:`upload` makes the graph."""

    uv: np.ndarray
    cam_idx: np.ndarray
    pt_idx: np.ndarray
    pt_ptr: np.ndarray
    cam_perm: np.ndarray
    cam_ptr: np.ndarray
    cam_valid: np.ndarray
    pt_valid: np.ndarray
    Ns: np.ndarray
    Ns_inv: np.ndarray
    Ps_gt: np.ndarray
    gt_depths: Optional[np.ndarray]
    splits: dict  # {(side, rows, long_above): {name: int32 array}}
    # an edge shard's (shard_host_graph): the scene's float32 counts per
    # point and camera, its number of edges, the shard's first edge, the
    # scene's (cam_idx, pt_idx) and the shard's place in the point table
    pt_count: Optional[np.ndarray] = None
    cam_count: Optional[np.ndarray] = None
    scene_edges: Optional[int] = None
    edge_offset: int = 0
    scene_ids: Optional[tuple] = None
    table_shard: Optional[TableShard] = None

    def scene_edge_ids(self):
        """(camera, point) of each of the whole scene's edges, as
        :meth:`ViewGraph.scene_edge_ids` gives them."""
        return (self.cam_idx, self.pt_idx) if self.scene_ids is None else self.scene_ids


def _splits(pt_ptr: np.ndarray, cam_ptr: np.ndarray) -> dict:
    return {(side, rows_, above): _split_parts(ptr, rows_, above)
            for side, ptr in (("pt", pt_ptr), ("cam", cam_ptr))
            for rows_, above in host_split_keys()[side]}


def _counts(ptr: np.ndarray) -> np.ndarray:
    return np.maximum(np.diff(ptr.astype(np.int64)), 1).astype(np.float32)


def edge_shard_range(num_edges: int, shard: int, n_shards: int):
    """[lo, hi) of edge shard ``shard`` of ``n_shards``: the contiguous range
    starting at ``shard * ceil(E / n_shards)``. Raises ``ValueError`` when
    the shard would get no edge."""
    per = -(-num_edges // n_shards)
    lo, hi = shard * per, min(num_edges, (shard + 1) * per)
    if not 0 <= shard < n_shards or lo >= hi:
        raise ValueError(f"edge shard {shard} of {n_shards} gets no edge of a scene of "
                         f"{num_edges} edges: use fewer edge shards or a larger scene")
    return lo, hi


def shard_host_graph(host: HostSceneGraph, shard: int, n_shards: int) -> HostSceneGraph:
    """Edge shard ``shard`` of ``n_shards`` of a whole scene's host graph
    (:func:`edge_shard_range`): its edges' rows, point CSR offsets over all
    n points, the camera permutation and offsets of its edges over all m
    cameras, its splits, its :class:`TableShard`; the scene's tables,
    validity masks and counts. One shard of one is the scene itself."""
    if host.scene_edges is not None:
        raise ValueError("shard_host_graph takes a whole scene's graph, not a shard")
    if n_shards == 1:
        return host
    E = host.cam_idx.shape[0]
    lo, hi = edge_shard_range(E, shard, n_shards)
    i32 = np.int32
    pt_ptr = (np.clip(host.pt_ptr.astype(np.int64), lo, hi) - lo).astype(i32)
    cam_idx = host.cam_idx[lo:hi]
    perm = host.cam_perm.astype(np.int64)
    cam_perm = (perm[(perm >= lo) & (perm < hi)] - lo).astype(i32)
    cam_ptr = np.zeros(host.cam_ptr.shape[0], dtype=np.int64)
    np.cumsum(np.bincount(cam_idx, minlength=cam_ptr.shape[0] - 1), out=cam_ptr[1:])
    return dataclasses.replace(
        host, uv=host.uv[lo:hi], cam_idx=cam_idx, pt_idx=host.pt_idx[lo:hi], pt_ptr=pt_ptr,
        cam_perm=cam_perm, cam_ptr=cam_ptr.astype(i32),
        gt_depths=None if host.gt_depths is None else host.gt_depths[lo:hi],
        splits=_splits(pt_ptr, cam_ptr), pt_count=_counts(host.pt_ptr),
        cam_count=_counts(host.cam_ptr), scene_edges=E, edge_offset=lo,
        scene_ids=(host.cam_idx, host.pt_idx),
        table_shard=table_shard(host.pt_ptr, host.pt_idx, shard, n_shards))


def build_host_scene_graph(M: np.ndarray, Ns: np.ndarray, Ps_gt: np.ndarray,
                           gt_depths_dense: Optional[np.ndarray] = None) -> HostSceneGraph:
    """The host half of :func:`build_scene_graph`, numpy only, from a (2m, n)
    measurement matrix, with the validity semantics of the JAX package's
    ``build_view_graph`` (reference M2sparse + masks)."""
    M = np.asarray(M, dtype=np.float32)
    m = M.shape[0] // 2
    n = M.shape[1]
    Ns = np.asarray(Ns, dtype=np.float32)
    valid = get_M_valid_points(M)  # (m, n)
    norm_M = normalize_M(M, Ns, valid)  # (m, n, 2)

    rows, cols = np.nonzero(valid)
    order = np.lexsort((rows, cols))  # by (point, camera)
    rows, cols = rows[order], cols[order]
    uv = norm_M[rows, cols].astype(np.float32)

    pt_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols, minlength=n), out=pt_ptr[1:])
    cam_perm = np.argsort(rows, kind="stable")
    cam_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=cam_ptr[1:])
    splits = _splits(pt_ptr, cam_ptr)
    gt_depths = None
    if gt_depths_dense is not None:
        gt_depths = np.asarray(gt_depths_dense, dtype=np.float32)[rows, cols]
    i32 = np.int32
    return HostSceneGraph(
        uv=uv, cam_idx=rows.astype(i32), pt_idx=cols.astype(i32), pt_ptr=pt_ptr.astype(i32),
        cam_perm=cam_perm.astype(i32), cam_ptr=cam_ptr.astype(i32),
        cam_valid=valid.sum(axis=1) >= MIN_N_POINTS_PER_VIEW,
        pt_valid=valid.sum(axis=0) >= MIN_N_VIEWS_PER_POINT,
        Ns=Ns, Ns_inv=np.linalg.inv(Ns.astype(np.float64)).astype(np.float32),
        Ps_gt=np.asarray(Ps_gt, dtype=np.float32), gt_depths=gt_depths, splits=splits)


def upload(host: HostSceneGraph, device: Optional[Union[str, torch.device]] = None) -> "SceneGraph":
    """The :class:`SceneGraph` of ``host`` on ``device``: on the card each
    array goes through pinned memory by an asynchronous copy on the current
    stream (no synchronisation); the graph keeps the splits, built, and its
    CSR offsets on the host for any other split."""
    device = resolve_device(device)

    def t(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else a

    graph = ViewGraph(uv=t(host.uv), cam_idx=t(host.cam_idx), pt_idx=t(host.pt_idx),
                      pt_ptr=t(host.pt_ptr), cam_perm=t(host.cam_perm), cam_ptr=t(host.cam_ptr),
                      cam_valid=t(host.cam_valid), pt_valid=t(host.pt_valid),
                      scene_num_edges=host.scene_edges, edge_offset=host.edge_offset,
                      scene_ids=host.scene_ids, table_shard=host.table_shard)
    graph.__dict__["_host_ptr"] = {"pt": host.pt_ptr, "cam": host.cam_ptr}
    if host.scene_edges is not None:  # an edge shard: the scene's counts, not its CSR's
        graph.__dict__.update(pt_count=t(host.pt_count), cam_count=t(host.cam_count))
    for (side, rows, above), parts in host.splits.items():
        table = t(np.concatenate(list(parts.values())))
        graph.__dict__.setdefault(f"_{side}_chunks", {})[(rows, above)] = SegmentChunks(
            rows=rows, table=table, **parts)
    return SceneGraph(graph=graph, Ns=t(host.Ns), Ns_inv=t(host.Ns_inv), Ps_gt=t(host.Ps_gt),
                      gt_depths=None if host.gt_depths is None else t(host.gt_depths))


def build_view_graph(
    M: np.ndarray,
    Ns: np.ndarray,
    device: Optional[Union[str, torch.device]] = None,
) -> ViewGraph:
    """The :class:`ViewGraph` of a (2m, n) measurement matrix on ``device``
    (:func:`build_host_scene_graph`, :func:`upload`)."""
    m = np.asarray(M).shape[0] // 2
    return build_scene_graph(M, Ns, np.zeros((m, 3, 4), np.float32), device=device).graph


def build_scene_graph(
    M: np.ndarray,
    Ns: np.ndarray,
    Ps_gt: np.ndarray,
    device: Optional[Union[str, torch.device]] = None,
    gt_depths_dense: Optional[np.ndarray] = None,
) -> SceneGraph:
    """The graph and the camera-side arrays; with ``gt_depths_dense`` (m, n)
    also each edge's GT depth ``depths[cam, pt]``, in the graph's edge order
    (as the JAX package's build_scene_graph picks them, view_graph.py:379-395;
    the port's graph holds valid edges only)."""
    return upload(build_host_scene_graph(M, Ns, Ps_gt, gt_depths_dense), device)
