"""The scene's edge graph, derived from the (2m, n) measurement matrix.

An observation (camera i, point j) is an edge when it is nonzero and its
point is seen by at least two cameras. Edges are ordered by point, then
camera. ``uv`` holds the normalized observations ``(Ns[i] @ [x; 1])[:2]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MIN_VIEWS_PER_POINT = 2
MIN_POINTS_PER_VIEW = 8


@dataclass
class Graph:
    uv: torch.Tensor  # (E, 2) normalized observations
    cam: torch.Tensor  # (E,) int64 camera of each edge
    pt: torch.Tensor  # (E,) int64 point of each edge
    cam_count: torch.Tensor  # (m,) edges per camera
    pt_count: torch.Tensor  # (n,) edges per point
    cam_valid: torch.Tensor  # (m,) bool
    pt_valid: torch.Tensor  # (n,) bool
    Ns_inv: torch.Tensor  # (m, 3, 3)
    num_cams: int
    num_pts: int

    @property
    def num_edges(self) -> int:
        return int(self.cam.shape[0])

    def to(self, dtype) -> "Graph":
        """The graph with its real-valued tensors in ``dtype``."""
        real = {k: getattr(self, k).to(dtype) for k in ("uv", "cam_count", "pt_count", "Ns_inv")}
        return Graph(**{**self.__dict__, **real})


def build_graph(M: np.ndarray, Ns: np.ndarray, device) -> Graph:
    M = np.asarray(M, dtype=np.float32)
    Ns = np.asarray(Ns, dtype=np.float32)
    m, n = M.shape[0] // 2, M.shape[1]
    xy = M.reshape(m, 2, n)
    valid = (np.abs(xy).sum(axis=1) != 0)
    valid[:, valid.sum(axis=0) < MIN_VIEWS_PER_POINT] = False
    cams, pts = np.nonzero(valid)
    order = np.lexsort((cams, pts))
    cams, pts = cams[order], pts[order]
    obs = np.stack([xy[cams, 0, pts], xy[cams, 1, pts], np.ones(len(cams), np.float32)], axis=1)
    uv = np.einsum("eij,ej->ei", Ns[cams], obs)[:, :2]
    per_cam = valid.sum(axis=1)
    per_pt = valid.sum(axis=0)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return Graph(
        uv=t(uv, torch.float32), cam=t(cams, torch.int64), pt=t(pts, torch.int64),
        cam_count=t(per_cam, torch.float32), pt_count=t(per_pt, torch.float32),
        cam_valid=t(per_cam >= MIN_POINTS_PER_VIEW), pt_valid=t(per_pt >= MIN_VIEWS_PER_POINT),
        Ns_inv=t(np.linalg.inv(Ns.astype(np.float64)).astype(np.float32)),
        num_cams=m, num_pts=n)
