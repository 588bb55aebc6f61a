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

    @functools.cached_property
    def pt_count(self) -> torch.Tensor:
        """(n,) float32 edges per point, at least 1 (an empty segment's sum
        is 0 and stays 0), from the CSR offsets; computed once."""
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
    splits = {(side, rows_, above): _split_parts(ptr, rows_, above)
              for side, ptr in (("pt", pt_ptr), ("cam", cam_ptr))
              for rows_, above in host_split_keys()[side]}
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
                      cam_valid=t(host.cam_valid), pt_valid=t(host.pt_valid))
    graph.__dict__["_host_ptr"] = {"pt": host.pt_ptr, "cam": host.cam_ptr}
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
