"""Multi-view DLT triangulation on the host (numpy).

A copy of the JAX package's geometry/triangulation.py (reference
code/utils/geo_utils.py:611-671), which builds the GT depth targets: points
are bucketed by the number of cameras that observe them and each bucket is
solved with one batched SVD.

The linear system per point (full DLT, the reference default
``simplified_dlt=False``): unknowns are [X(4), lambda_1..lambda_k]; for the
j-th observing camera P_j and observation x_ij,

    rows 3j..3j+2:  [ P_j | 0 .. -x_ij,-1 .. 0 ]  (column 4+j)

The point is the first 4 components of the right singular vector of the
smallest singular value, pflat-normalized.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gasfm_tpu_torch.geometry.np_geo import M_to_xs, get_M_valid_points, normalize_points_cams


def dlt_triangulation(Ps: np.ndarray, xs: np.ndarray, visible_points: np.ndarray,
                      simplified_dlt: bool = False) -> np.ndarray:
    """Triangulate all points: (n, 4), NaN rows for points seen by fewer
    than two cameras."""
    m, n, _ = xs.shape
    X = np.full((n, 4), np.nan)
    counts = visible_points.sum(axis=0)  # cameras per point
    Ps = np.asarray(Ps, dtype=np.float64)
    xs = np.asarray(xs, dtype=np.float64)

    for k in np.unique(counts):
        if k < 2:
            continue
        point_ids = np.nonzero(counts == k)[0]
        B = len(point_ids)
        # (B, k) camera indices per point, in ascending camera order
        cams = np.nonzero(visible_points[:, point_ids].T)[1].reshape(B, k)
        x_sel = xs[cams, point_ids[:, None], :2]  # (B, k, 2)
        P_sel = Ps[cams]  # (B, k, 3, 4)
        if simplified_dlt:
            # (B, 2k, 4): x * P3 - P1 ; y * P3 - P2
            A = np.empty((B, 2 * k, 4))
            A[:, 0::2, :] = x_sel[:, :, 0:1] * P_sel[:, :, 2, :] - P_sel[:, :, 0, :]
            A[:, 1::2, :] = x_sel[:, :, 1:2] * P_sel[:, :, 2, :] - P_sel[:, :, 1, :]
        else:
            A = np.zeros((B, 3 * k, k + 4))
            j = np.arange(k)
            A[:, :, :4] = P_sel.reshape(B, 3 * k, 4)  # P blocks: rows 3j..3j+2
            A[:, 3 * j, 4 + j] = -x_sel[:, :, 0]  # -x_ij, -1 in column 4+j
            A[:, 3 * j + 1, 4 + j] = -x_sel[:, :, 1]
            A[:, 3 * j + 2, 4 + j] = -1.0
        v = np.linalg.svd(A, full_matrices=False)[2][:, -1, :4]
        w = v[:, 3:4]
        X[point_ids] = v / np.where(w == 0, 1.0, w)
    return X


def n_view_triangulation(Ps: np.ndarray, M: np.ndarray, Ns: Optional[np.ndarray] = None,
                         simplified_dlt: bool = False) -> np.ndarray:
    """Triangulate from a (2m, n) measurement matrix: (4, n)."""
    xs = M_to_xs(np.asarray(M))
    visible = get_M_valid_points(xs)
    Ps = np.asarray(Ps)
    if Ns is not None:
        Ps, xs = normalize_points_cams(Ps.copy(), xs, np.asarray(Ns))
    return dlt_triangulation(Ps, xs, visible, simplified_dlt=simplified_dlt).T
