"""Host-side (NumPy) measurement-matrix helpers.

A copy of the parts of the JAX package's geometry/np_geo.py that the graph
construction, the synthetic scene generator, the GT-depth triangulation and
the scene loaders need.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gasfm_tpu_torch.utils.constants import MIN_N_VIEWS_PER_POINT


def M_to_xs(M: np.ndarray) -> np.ndarray:
    """(2m, n) stacked measurement matrix -> (m, n, 2) point array."""
    m2, n = M.shape
    return M.reshape(m2 // 2, 2, n).transpose(0, 2, 1)


def batch_pflat(x: np.ndarray) -> np.ndarray:
    """(m, 3, n): divide by the third coordinate."""
    return x / x[:, 2:3, :]


def get_M_valid_points(M: np.ndarray) -> np.ndarray:
    """(2m, n) or (m, n, 2) -> (m, n) validity mask.

    An observation is valid iff it is nonzero AND its track is visible in at
    least MIN_N_VIEWS_PER_POINT views (whole columns are invalidated
    otherwise).
    """
    if M.ndim == 2:
        M = M_to_xs(M)
    valid = np.abs(M).sum(axis=2) != 0
    valid[:, valid.sum(axis=0) < MIN_N_VIEWS_PER_POINT] = False
    return valid


def normalize_points_cams(Ps: np.ndarray, xs: np.ndarray,
                          Ns: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize cameras and 2D points with per-view matrices N (zero
    homogeneous coordinates taken as 1 before the division)."""
    m, n, d = xs.shape
    xs3 = np.concatenate([xs, np.ones((m, n, 1))], axis=2) if d == 2 else xs
    norm_P = Ns @ Ps
    pts = (Ns @ xs3.transpose(0, 2, 1)).transpose(0, 2, 1)  # (m, n, 3)
    w = pts[:, :, -1]
    w = np.where(w == 0, 1.0, w)
    pts = pts / w[:, :, None]
    return norm_P, pts[:, :, :2]


def normalize_M(M: np.ndarray, Ns: np.ndarray, valid_points: Optional[np.ndarray] = None) -> np.ndarray:
    """(2m, n), (m, 3, 3) -> (m, n, 2) normalized points, zeros at invalid."""
    if valid_points is None:
        valid_points = get_M_valid_points(M)
    m = M.shape[0] // 2
    n = M.shape[1]
    pts = np.concatenate([M.reshape(m, 2, n), np.ones((m, 1, n), dtype=M.dtype)], axis=1)
    norm = (Ns @ pts).transpose(0, 2, 1)[:, :, :2]
    norm[~valid_points, :] = 0
    return norm


def batch_get_normalization_matrices(xs: np.ndarray) -> np.ndarray:
    """Per-view zero-mean/unit-std normalization matrices (the mean and std
    run over all n columns, including the (0, 0) placeholders of unobserved
    points, as in the reference)."""
    m = xs.shape[0]
    Ns = np.zeros((m, 3, 3))
    for i in range(m):
        pts = xs[i].T
        mean = pts[:2].mean(axis=1)
        std = pts[:2].std(axis=1)
        s = 1.0 / np.where(std == 0, 1.0, std)
        N = np.eye(3)
        N[0, 0], N[1, 1] = s[0], s[1]
        N[:2, 2] = -s * mean
        Ns[i] = N
    return Ns
