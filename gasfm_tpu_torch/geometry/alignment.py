"""Similarity alignment of predicted to ground-truth cameras.

A copy of the JAX package's geometry/alignment.py (reference
code/utils/geo_utils.py:54-126). The rotation is identical
(SVD of the summed relative rotations with a determinant fix-up). The
scale+translation step minimizes the same objective — the *sum of Euclidean
norms* of camera-center residuals — but with a Weiszfeld/IRLS solver instead
of the reference's cvxpy convex program (an IRLS solve of this tiny problem
needs no solver package). Failure
modes mirror the reference: on SVD or solver failure the predictions are
returned unchanged with an identity alignment.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _solve_weighted_scale_translation(P: np.ndarray, G: np.ndarray, w: np.ndarray) -> Tuple[float, np.ndarray]:
    """argmin_{c,t} sum_i w_i || G_i - c P_i - t ||^2 in closed form."""
    wsum = w.sum()
    Pm = (w[:, None] * P).sum(axis=0) / wsum
    Gm = (w[:, None] * G).sum(axis=0) / wsum
    Pc = P - Pm
    Gc = G - Gm
    denom = (w[:, None] * Pc * Pc).sum()
    if denom <= 0:
        return 1.0, Gm - Pm
    c = (w[:, None] * Pc * Gc).sum() / denom
    t = Gm - c * Pm
    return float(c), t


def solve_sum_of_norms_scale_translation(
    P: np.ndarray, G: np.ndarray, n_iters: int = 200, tol: float = 1e-12
) -> Tuple[float, np.ndarray]:
    """Minimize sum_i ||G_i - (c P_i + t)|| over scale c and translation t.

    Weiszfeld-style IRLS; the objective is convex, so this converges to the
    global optimum the reference's cvxpy program finds.
    """
    n = P.shape[0]
    w = np.ones(n)
    c, t = _solve_weighted_scale_translation(P, G, w)
    prev_obj = np.inf
    for _ in range(n_iters):
        r = G - (c * P + t)
        norms = np.linalg.norm(r, axis=1)
        obj = norms.sum()
        if abs(prev_obj - obj) <= tol * max(1.0, obj):
            break
        prev_obj = obj
        w = 1.0 / np.maximum(norms, 1e-9)
        c, t = _solve_weighted_scale_translation(P, G, w)
    return c, t


def align_cameras(
    pred_Rs: np.ndarray,
    gt_Rs: np.ndarray,
    pred_ts: np.ndarray,
    gt_ts: np.ndarray,
    return_alignment: bool = False,
):
    """Align predicted poses to GT by a similarity transform.

    NOTE (as in the reference): the "t" arrays are camera *centers*.
    Returns (Rs_fixed, ts_fixed[, similarity_mat 4x4]).
    """
    pred_Rs = np.asarray(pred_Rs, dtype=np.float64)
    gt_Rs = np.asarray(gt_Rs, dtype=np.float64)
    pred_ts = np.asarray(pred_ts, dtype=np.float64)
    gt_ts = np.asarray(gt_ts, dtype=np.float64)

    pred_Rs_orig = pred_Rs.copy()
    pred_ts_orig = pred_ts.copy()

    Q = np.sum(gt_Rs @ np.transpose(pred_Rs, (0, 2, 1)), axis=0)
    try:
        Uq, _, Vqh = np.linalg.svd(Q)
    except np.linalg.LinAlgError as e:  # pragma: no cover - degenerate input
        print("[WARNING] Camera alignment failed at SVD. Returning predictions as-is.")
        print(repr(e))
        if return_alignment:
            return pred_Rs_orig, pred_ts_orig, np.eye(4)
        return pred_Rs_orig, pred_ts_orig

    sv = np.ones(3)
    sv[-1] = np.linalg.det(Uq @ Vqh)
    R_opt = Uq @ np.diag(sv) @ Vqh

    R_fixed = R_opt.reshape(1, 3, 3) @ pred_Rs
    pred_ts_rot = pred_ts @ R_opt.T

    try:
        c_opt, t_opt = solve_sum_of_norms_scale_translation(pred_ts_rot, gt_ts)
        if not np.isfinite(c_opt) or not np.all(np.isfinite(t_opt)):
            raise FloatingPointError("non-finite alignment solution")
    except (FloatingPointError, np.linalg.LinAlgError) as e:
        print("[WARNING] Camera alignment failed at optimization. Returning predictions as-is.")
        print(repr(e))
        if return_alignment:
            return pred_Rs_orig, pred_ts_orig, np.eye(4)
        return pred_Rs_orig, pred_ts_orig

    t_fixed = c_opt * pred_ts_rot + t_opt.reshape(1, 3)

    if return_alignment:
        similarity_mat = np.eye(4)
        similarity_mat[0:3, 0:3] = c_opt * R_opt
        similarity_mat[0:3, 3] = t_opt
        return R_fixed, t_fixed, similarity_mat
    return R_fixed, t_fixed


def tranlsation_rotation_errors(R_fixed, t_fixed, gt_Rs, gt_ts):
    """Parity: reference code/utils/geo_utils.py:47-50 (incl. the typo'd name,
    kept for API familiarity; see also translation_rotation_errors)."""
    from gasfm_tpu_torch.geometry.rotations import compare_rotations_np

    R_error = compare_rotations_np(np.asarray(R_fixed), np.asarray(gt_Rs))
    t_error = np.linalg.norm(np.asarray(t_fixed) - np.asarray(gt_ts), axis=-1)
    return R_error, t_error


translation_rotation_errors = tranlsation_rotation_errors
