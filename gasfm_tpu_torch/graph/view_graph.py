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


@dataclasses.dataclass(frozen=True)
class SceneGraph:
    """A graph plus the per-scene camera-side arrays the model & loss need."""

    graph: ViewGraph
    Ns: torch.Tensor  # (m, 3, 3) normalization matrices (inv(K) if calibrated)
    Ps_gt: torch.Tensor  # (m, 3, 4) GT cameras


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
) -> SceneGraph:
    device = resolve_device(device)
    graph = build_view_graph(M, Ns, device=device)
    return SceneGraph(
        graph=graph,
        Ns=torch.as_tensor(np.asarray(Ns, dtype=np.float32), device=device),
        Ps_gt=torch.as_tensor(np.asarray(Ps_gt, dtype=np.float32), device=device),
    )
