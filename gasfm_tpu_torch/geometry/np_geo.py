"""Host-side (NumPy) projective geometry: measurement-matrix reshapes and
validity, normalization, camera decomposition, reprojection errors and the
track-wise cyclic shuffle of the depth backprojection metric.

A copy of the JAX package's geometry/np_geo.py (reference
code/utils/geo_utils.py, general_utils.py:169-246), which the graph
construction, the synthetic generator, the triangulation, the metrics and
bundle adjustment use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gasfm_tpu_torch.utils.constants import MIN_N_VIEWS_PER_POINT


def M_to_xs(M: np.ndarray) -> np.ndarray:
    """(2m, n) stacked measurement matrix -> (m, n, 2) point array."""
    m2, n = M.shape
    return M.reshape(m2 // 2, 2, n).transpose(0, 2, 1)


def xs_to_M(xs: np.ndarray) -> np.ndarray:
    m, n, _ = xs.shape
    return xs.transpose(0, 2, 1).reshape(2 * m, n)


def batch_pflat(x: np.ndarray) -> np.ndarray:
    """(m, 3, n): divide by the third coordinate."""
    return x / x[:, 2:3, :]


def pflat(x: np.ndarray) -> np.ndarray:
    """Normalize homogeneous columns: x / x[-1]. Parity: geo_utils.py:332."""
    return x / x[-1:, :]


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


def xs_valid_points(xs: np.ndarray) -> np.ndarray:
    """Parity: reference code/utils/geo_utils.py:674-680 (delegates to the
    M-valid-points semantics including the column invalidation)."""
    return get_M_valid_points(xs)


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


def invert_euclidean_trafo(Rs: np.ndarray, ts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Parity: reference code/utils/geo_utils.py:129-146."""
    Rs_inv = np.transpose(Rs, (0, 2, 1))
    ts_inv = (-Rs_inv @ ts.reshape(-1, 3, 1)).squeeze(-1)
    return Rs_inv, ts_inv


def decompose_camera_matrix(
    Ps: np.ndarray, Ks: Optional[np.ndarray] = None, inverse_direction_camera2global: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """P = K [R | t] -> (R^T, camera centers -R^T t) by default.

    Parity: reference code/utils/geo_utils.py:149-171.
    """
    Rt = np.linalg.inv(Ks) @ Ps if Ks is not None else Ps
    Rs = Rt[:, 0:3, 0:3]
    ts = Rt[:, 0:3, 3]
    if inverse_direction_camera2global:
        Rs, ts = invert_euclidean_trafo(Rs, ts)
    return Rs, ts


def get_camera_matrix(R: np.ndarray, t: np.ndarray, K: np.ndarray) -> np.ndarray:
    """R is cam->world rotation, t the camera center: P = K R^T [I | -t].

    Parity: reference code/utils/geo_utils.py:294-305.
    """
    return K @ R.T @ np.concatenate([np.eye(3), -t.reshape(3, 1)], axis=1)


def batch_get_camera_matrix_from_rtk(Rs: np.ndarray, ts: np.ndarray, Ks: np.ndarray) -> np.ndarray:
    """Vectorized version of reference geo_utils.py:307-315."""
    m = Rs.shape[0]
    RsT = np.transpose(Rs, (0, 2, 1))
    t_col = (-RsT @ ts.reshape(m, 3, 1))
    return Ks @ np.concatenate([RsT, t_col], axis=2)


def reprojection_error_with_points(
    Ps: np.ndarray, Xs: np.ndarray, xs: np.ndarray, visible_points: Optional[np.ndarray] = None
) -> np.ndarray:
    """Per-observation reprojection error matrix (m, n) with NaN at invisible.

    Parity: reference code/utils/geo_utils.py:371-391.
    """
    m, n, _ = xs.shape
    _, D = Xs.shape
    X4 = np.concatenate([Xs, np.ones((n, 1))], axis=1) if D == 3 else Xs
    if visible_points is None:
        visible_points = xs_valid_points(xs)
    proj = (Ps @ X4.T).swapaxes(1, 2)  # (m, n, 3)
    w = proj[:, :, -1]
    safe_w = np.where(visible_points, w, 1.0)
    safe_w = np.where(safe_w == 0, 1.0, safe_w)
    proj2 = proj[:, :, :2] / safe_w[:, :, None]
    errors = np.linalg.norm(xs[:, :, :2] - proj2, axis=2)
    errors = np.where(visible_points, errors, np.nan)
    return errors


def calc_global_reprojection_error(Ps: np.ndarray, M: np.ndarray, Ns: np.ndarray) -> np.ndarray:
    """Parity: reference code/utils/geo_utils.py:361-368."""
    from gasfm_tpu_torch.geometry.triangulation import n_view_triangulation

    valid_pts = get_M_valid_points(M)
    X = n_view_triangulation(Ps, M, Ns)
    projected = batch_pflat(Ps @ X)[:, 0:2, :]
    image_points = M.reshape(len(Ps), 2, M.shape[-1])
    reproj = np.linalg.norm(image_points - projected, axis=1)
    return np.where(valid_pts, reproj, np.nan)


def get_positive_projected_pts_mask(pts2D: np.ndarray, infinity_pts_margin: float) -> np.ndarray:
    """Parity: reference code/utils/geo_utils.py:721-722."""
    return pts2D[:, 2, :] >= infinity_pts_margin


def get_projected_pts_mask(pts2D: np.ndarray, infinity_pts_margin: float) -> np.ndarray:
    """Parity: reference code/utils/geo_utils.py:725-726."""
    return np.abs(pts2D[:, 2, :]) >= infinity_pts_margin


def shuffle_coo_along_axis_preserving_pattern(
    values: np.ndarray, indices: np.ndarray, shuffle_axis: int = 0, rng: Optional[np.random.Generator] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Random per-partition cyclic derangement of a COO matrix along one axis.

    Used to reproject each backprojected point into a *different* random view
    of its track. Parity: reference code/utils/general_utils.py:169-246.
    """
    if rng is None:
        rng = np.random.default_rng()
    assert indices.shape[0] == 2
    nse = indices.shape[1]
    sort_axis = 1 - shuffle_axis

    _, counts = np.unique(indices[sort_axis], return_counts=True)
    assert np.all(counts > 1), "every partition must have >= 2 members"

    order = np.argsort(indices[sort_axis], kind="stable")
    indices = indices[:, order]
    values = values[order, ...]

    shuffle_idx = rng.permutation(nse)
    indices = indices[:, shuffle_idx]
    values = values[shuffle_idx, ...]

    order = np.argsort(indices[sort_axis], kind="stable")
    indices = indices[:, order]
    values = values[order, ...]

    shifted = np.roll(indices, 1, axis=1)
    start_mask = indices[sort_axis] != shifted[sort_axis]
    start_idx = np.nonzero(start_mask)[0]
    prev_end_idx = np.mod(start_idx - 1, nse)
    end_idx = np.roll(prev_end_idx, -1)

    new_indices = np.empty_like(indices)
    new_indices[:, ~start_mask] = shifted[:, ~start_mask]
    new_indices[:, start_idx] = indices[:, end_idx]
    assert np.all(new_indices[sort_axis] == indices[sort_axis])
    return values, new_indices


def reprojection_error_backproj_random_view_pairs(
    Ks: np.ndarray,
    Ps: np.ndarray,
    depths: np.ndarray,
    xs: np.ndarray,
    visible_points: Optional[np.ndarray] = None,
    calc_reproj_depths: bool = False,
    rng: Optional[np.random.Generator] = None,
):
    """Two-view reprojection error of backprojected predicted depths.

    Parity: reference code/utils/geo_utils.py:393-464.
    """
    m, n, d = xs.shape
    if visible_points is None:
        visible_points = xs_valid_points(xs)

    Rs_inv, ts_inv = decompose_camera_matrix(Ps, Ks, inverse_direction_camera2global=True)

    xs_hom = np.concatenate([xs, np.ones((m, n, 1))], axis=2)
    x_norm_hom = (np.linalg.inv(Ks) @ xs_hom.swapaxes(1, 2)).swapaxes(1, 2)
    x_norm = x_norm_hom[:, :, :-1] / x_norm_hom[:, :, [-1]]

    X4_local = np.ones((m, n, 3))
    X4_local[:, :, :2] = x_norm
    X4_local *= depths[:, :, None]
    X4_global = ((Rs_inv @ X4_local.swapaxes(1, 2)) + ts_inv[:, :, None]).swapaxes(1, 2)

    idx = np.array(np.nonzero(visible_points))
    vals = X4_global[idx[0], idx[1], :]
    vals, idx = shuffle_coo_along_axis_preserving_pattern(vals, idx, shuffle_axis=0, rng=rng)
    X4_global[idx[0], idx[1], :] = vals

    X4_hom = np.concatenate([X4_global, np.ones((m, n, 1))], axis=2)
    projected = Ps @ X4_hom.swapaxes(1, 2)  # (m, 3, n)
    if calc_reproj_depths:
        reproj_depths = (np.linalg.inv(Ks) @ projected)[:, 2, :]
    projected = projected.swapaxes(1, 2)
    w = projected[:, :, -1]
    safe_w = np.where(visible_points & (w != 0), w, 1.0)
    proj2 = projected[:, :, :2] / safe_w[:, :, None]
    errors = np.linalg.norm(xs[:, :, :2] - proj2, axis=2)
    errors = np.where(visible_points, errors, np.nan)
    if calc_reproj_depths:
        return errors, reproj_depths
    return errors
