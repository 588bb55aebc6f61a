"""Host-side (NumPy) measurement-matrix helpers.

A copy of the parts of the JAX package's geometry/np_geo.py that the graph
construction and the synthetic scene generator need.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gasfm_tpu_torch.utils.constants import MIN_N_VIEWS_PER_POINT


def M_to_xs(M: np.ndarray) -> np.ndarray:
    """(2m, n) stacked measurement matrix -> (m, n, 2) point array."""
    m2, n = M.shape
    return M.reshape(m2 // 2, 2, n).transpose(0, 2, 1)


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
