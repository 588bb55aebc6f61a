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

All of it is built once per scene on the host with numpy.
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
            cache[key] = split_segments(ptr.cpu().numpy(), rows, self.device, key[1])
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
    table = torch.as_tensor(np.concatenate(list(parts.values())).astype(np.int32), device=device)
    return SegmentChunks(rows=rows, table=table,
                         **{k: v.astype(np.int32) for k, v in parts.items()})


@dataclasses.dataclass(frozen=True)
class SceneGraph:
    """A graph plus the per-scene camera-side arrays the model & loss need."""

    graph: ViewGraph
    Ns: torch.Tensor  # (m, 3, 3) normalization matrices (inv(K) if calibrated)
    Ns_inv: torch.Tensor  # (m, 3, 3) their inverses (K if calibrated)
    Ps_gt: torch.Tensor  # (m, 3, 4) GT cameras
    gt_depths: Optional[torch.Tensor] = None  # (E,) float32 GT depth per edge, or None


def build_view_graph(
    M: np.ndarray,
    Ns: np.ndarray,
    device: Optional[Union[str, torch.device]] = None,
) -> ViewGraph:
    """Host-side construction from a (2m, n) measurement matrix, with the
    validity semantics of the JAX package's ``build_view_graph``
    (reference M2sparse + masks)."""
    device = resolve_device(device)
    M = np.asarray(M, dtype=np.float32)
    m = M.shape[0] // 2
    n = M.shape[1]
    valid = get_M_valid_points(M)  # (m, n)
    norm_M = normalize_M(M, np.asarray(Ns, dtype=np.float32), valid)  # (m, n, 2)

    rows, cols = np.nonzero(valid)
    order = np.lexsort((rows, cols))  # by (point, camera)
    rows, cols = rows[order], cols[order]
    uv = norm_M[rows, cols].astype(np.float32)

    pt_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols, minlength=n), out=pt_ptr[1:])
    cam_perm = np.argsort(rows, kind="stable")
    cam_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=cam_ptr[1:])

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return ViewGraph(
        uv=t(uv, torch.float32),
        cam_idx=t(rows, torch.int32),
        pt_idx=t(cols, torch.int32),
        pt_ptr=t(pt_ptr, torch.int32),
        cam_perm=t(cam_perm, torch.int32),
        cam_ptr=t(cam_ptr, torch.int32),
        cam_valid=t(valid.sum(axis=1) >= MIN_N_POINTS_PER_VIEW, torch.bool),
        pt_valid=t(valid.sum(axis=0) >= MIN_N_VIEWS_PER_POINT, torch.bool),
    )


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
    device = resolve_device(device)
    graph = build_view_graph(M, Ns, device=device)
    gt_depths = None
    if gt_depths_dense is not None:
        picked = np.asarray(gt_depths_dense, dtype=np.float32)[
            graph.cam_idx.cpu().numpy(), graph.pt_idx.cpu().numpy()]
        gt_depths = torch.as_tensor(picked, device=device)
    return SceneGraph(
        graph=graph,
        Ns=torch.as_tensor(np.asarray(Ns, dtype=np.float32), device=device),
        Ns_inv=torch.as_tensor(
            np.linalg.inv(np.asarray(Ns, dtype=np.float64)).astype(np.float32), device=device),
        Ps_gt=torch.as_tensor(np.asarray(Ps_gt, dtype=np.float32), device=device),
        gt_depths=gt_depths,
    )
