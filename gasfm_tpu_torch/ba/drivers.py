"""Bundle adjustment drivers.

A copy of the JAX package's ba/drivers.py (reference
code/utils/ba_functions.py:6-136: euc_ba / proj_ba,
optional DLT (re)triangulation, solve, optional repeat with a second DLT +
solve, reprojection errors before/middle/after, convergence flags; and the
solver invocation semantics of ceres_utils.run_*_python_ceres
(Huber(0.1), <= 100 iters, ftol 1e-4).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from gasfm_tpu_torch.ba.native_lib import get_lib
from gasfm_tpu_torch.ba.packing import order_cam_param_for_c, reorder_from_c_to_py
from gasfm_tpu_torch.geometry.np_geo import (
    batch_get_camera_matrix_from_rtk,
    batch_get_normalization_matrices,
    normalize_points_cams,
    reprojection_error_with_points,
    xs_valid_points,
)
from gasfm_tpu_torch.geometry.triangulation import dlt_triangulation

_DEFAULTS = {"huber_delta": 0.1, "max_iterations": 100, "function_tolerance": 1e-4, "num_threads": 0}


def _solver_opts(conf) -> Dict:
    if conf is None:
        return dict(_DEFAULTS)
    return {
        "huber_delta": conf.get_float("ba.huber_delta", default=_DEFAULTS["huber_delta"]),
        "max_iterations": conf.get_int("ba.max_iterations", default=_DEFAULTS["max_iterations"]),
        "function_tolerance": conf.get_float(
            "ba.function_tolerance", default=_DEFAULTS["function_tolerance"]
        ),
        "num_threads": conf.get_int("ba.num_threads", default=_DEFAULTS["num_threads"]),
    }


def _as_c(arr, dtype):
    a = np.ascontiguousarray(arr, dtype=dtype)
    ptr_type = ctypes.POINTER(ctypes.c_double if dtype == np.float64 else ctypes.c_int)
    return a, a.ctypes.data_as(ptr_type)


def run_euclidean_ba(Xs, visible_xs, Rs, ts, Ks, point_indices, print_out=True, opts=None):
    """Native equivalent of ceres_utils.run_euclidean_python_ceres
    (ceres_utils.py:127-196). Returns (new_Rs, new_ts, new_Ps, new_Xs, converged)."""
    opts = opts or dict(_DEFAULTS)
    if Xs.shape[-1] == 4:
        Xs = Xs[:, :3]
    n_cams = len(Rs)
    n_pts = Xs.shape[0]
    n_obs = visible_xs.shape[0]

    packed = order_cam_param_for_c(Rs, ts, Ks)
    packed_a, packed_p = _as_c(packed, np.float64)
    Xs_a, Xs_p = _as_c(Xs, np.float64)
    xs_a, xs_p = _as_c(visible_xs, np.float64)
    cam_a, cam_p = _as_c(point_indices[0], np.int32)
    pt_a, pt_p = _as_c(point_indices[1], np.int32)

    cam_deltas = np.zeros((n_cams, 6))
    pt_deltas = np.zeros((n_pts, 3))
    stats = np.zeros(3)
    cd_a, cd_p = _as_c(cam_deltas, np.float64)
    pd_a, pd_p = _as_c(pt_deltas, np.float64)
    st_a, st_p = _as_c(stats, np.float64)

    lib = get_lib()
    converged = lib.gasfm_ba_euclidean(
        n_cams, n_pts, n_obs, packed_p, Xs_p, xs_p, cam_p, pt_p, cd_p, pd_p,
        opts["huber_delta"], opts["max_iterations"], opts["function_tolerance"],
        opts["num_threads"], 1 if print_out else 0, st_p,
    )
    if print_out:
        print(
            f"[BA euclidean] cost {st_a[0]:.6e} -> {st_a[1]:.6e} in {int(st_a[2])} iters, "
            f"converged={bool(converged)}"
        )
    # Unconditional like the reference (ceres_utils.py:187-189 prints these
    # regardless of print_out): an all-zero delta usually means a degenerate
    # problem worth surfacing even in quiet mode.
    if not cd_a.any():
        print("Warning no change to Ps")
    if not pd_a.any():
        print("Warning no change to Xs")

    new_packed = packed.copy()
    new_packed[:, :6] += cd_a
    new_Rs, new_ts, new_Ps = reorder_from_c_to_py(new_packed, Ks)
    new_Xs = Xs + pd_a
    return new_Rs, new_ts, new_Ps, new_Xs, bool(converged)


def run_projective_ba(Ps, Xs, visible_xs, point_indices, print_out=True, opts=None):
    """Native equivalent of ceres_utils.run_projective_python_ceres
    (ceres_utils.py:199-262). Returns (new_Ps, new_Xs, converged)."""
    opts = opts or dict(_DEFAULTS)
    if Xs.shape[-1] == 4:
        Xs = Xs[:, :3]
    m = Ps.shape[0]
    n = Xs.shape[0]
    v = point_indices.shape[1]

    # Column-major 12-vectors per camera (parity: ceres_utils.py:107,218).
    Ps_cm = np.stack([P.flatten(order="F") for P in Ps])
    packed_a, packed_p = _as_c(Ps_cm, np.float64)
    Xs_a, Xs_p = _as_c(Xs, np.float64)
    xs_a, xs_p = _as_c(visible_xs, np.float64)
    cam_a, cam_p = _as_c(point_indices[0], np.int32)
    pt_a, pt_p = _as_c(point_indices[1], np.int32)

    cam_deltas = np.zeros((m, 12))
    pt_deltas = np.zeros((n, 3))
    stats = np.zeros(3)
    cd_a, cd_p = _as_c(cam_deltas, np.float64)
    pd_a, pd_p = _as_c(pt_deltas, np.float64)
    st_a, st_p = _as_c(stats, np.float64)

    lib = get_lib()
    converged = lib.gasfm_ba_projective(
        m, n, v, packed_p, Xs_p, xs_p, cam_p, pt_p, cd_p, pd_p,
        opts["huber_delta"], opts["max_iterations"], opts["function_tolerance"],
        opts["num_threads"], 1 if print_out else 0, st_p,
    )
    if print_out:
        print(
            f"[BA projective] cost {st_a[0]:.6e} -> {st_a[1]:.6e} in {int(st_a[2])} iters, "
            f"converged={bool(converged)}"
        )

    new_Ps = Ps + np.stack([d.reshape(3, 4, order="F") for d in cd_a])
    new_Xs = Xs + pd_a
    return new_Ps, new_Xs, bool(converged)


def euc_ba(
    xs,
    Rs,
    ts,
    Ks,
    Xs_our=None,
    Ps=None,
    Ns=None,
    repeat=True,
    triangulation=False,
    return_repro=True,
    print_out=True,
    conf=None,
) -> Dict:
    """Parity: reference ba_functions.euc_ba (ba_functions.py:6-72)."""
    opts = _solver_opts(conf)
    results: Dict = {}

    visible = xs_valid_points(xs)
    point_indices = np.stack(np.where(visible)).astype(np.int32)
    visible_xs = xs[visible]

    if Ps is None:
        Ps = batch_get_camera_matrix_from_rtk(Rs, ts, Ks)

    if triangulation:
        if Ns is None:
            Ns = np.linalg.inv(Ks)
        norm_P, norm_x = normalize_points_cams(Ps.copy(), xs, Ns)
        Xs = dlt_triangulation(norm_P, norm_x, visible)[:, :3]
    else:
        Xs = Xs_our

    if return_repro:
        results["repro_before"] = float(
            np.nanmean(reprojection_error_with_points(Ps, Xs, xs, visible))
        )

    new_Rs, new_ts, new_Ps, new_Xs, converged = run_euclidean_ba(
        Xs, visible_xs, Rs, ts, Ks, point_indices, print_out=print_out, opts=opts
    )
    results["converged1"] = converged

    if repeat:
        if return_repro:
            results["repro_middle"] = float(
                np.nanmean(reprojection_error_with_points(new_Ps, new_Xs, xs, visible))
            )
        if Ns is None:
            # Same fallback as the triangulation branch above (the reference
            # omits it here and would crash on euc_ba's plainest signature,
            # ba_functions.py:50; proj_ba has it in both branches).
            Ns = np.linalg.inv(Ks)
        prev_Xs = new_Xs
        norm_P, norm_x = normalize_points_cams(new_Ps.copy(), xs, Ns)
        new_Xs = dlt_triangulation(norm_P, norm_x, visible)[:, :3]
        # NaN-guard: points that fail re-triangulation keep their previous
        # (first-round-refined) coordinates instead of poisoning the second
        # solve. (The reference has no guard and lets NaNs flow.)
        bad = ~np.isfinite(new_Xs).all(axis=1)
        if bad.any():
            new_Xs[bad] = prev_Xs[bad, :3]
        if return_repro:
            results["repro_middle_triangulated"] = float(
                np.nanmean(reprojection_error_with_points(new_Ps, new_Xs, xs, visible))
            )
        new_Rs, new_ts, new_Ps, new_Xs, converged = run_euclidean_ba(
            new_Xs, visible_xs, new_Rs, new_ts, Ks, point_indices, print_out=print_out, opts=opts
        )
        results["converged2"] = converged

    if return_repro:
        results["repro_after"] = float(
            np.nanmean(reprojection_error_with_points(new_Ps, new_Xs, xs, visible))
        )

    new_Xs = np.concatenate([new_Xs, np.ones((new_Xs.shape[0], 1))], axis=1)
    results.update(Rs=new_Rs, ts=new_ts, Ps=new_Ps, Xs=new_Xs)
    return results


def proj_ba(
    Ps,
    xs,
    Xs_our=None,
    Ns=None,
    repeat=True,
    triangulation=False,
    return_repro=True,
    normalize_in_tri=True,
    print_out=True,
    conf=None,
) -> Dict:
    """Parity: reference ba_functions.proj_ba (ba_functions.py:75-136)."""
    opts = _solver_opts(conf)
    results: Dict = {}

    visible = xs_valid_points(xs)
    point_indices = np.stack(np.where(visible)).astype(np.int32)
    visible_xs = xs[visible]

    if triangulation:
        if normalize_in_tri:
            if Ns is None:
                Ns = batch_get_normalization_matrices(xs)
            norm_P, norm_x = normalize_points_cams(Ps.copy(), xs, Ns)
            Xs = dlt_triangulation(norm_P, norm_x, visible)[:, :3]
        else:
            Xs = dlt_triangulation(Ps, xs, visible)[:, :3]
    else:
        Xs = Xs_our

    if return_repro:
        results["repro_before"] = float(
            np.nanmean(reprojection_error_with_points(Ps, Xs, xs, visible))
        )

    new_Ps, new_Xs, converged = run_projective_ba(
        Ps, Xs, visible_xs, point_indices, print_out=print_out, opts=opts
    )
    results["converged1"] = converged

    if repeat:
        if return_repro:
            results["repro_middle"] = float(
                np.nanmean(reprojection_error_with_points(new_Ps, new_Xs, xs, visible))
            )
        if normalize_in_tri:
            if Ns is None:
                Ns = batch_get_normalization_matrices(xs)
            norm_P, norm_x = normalize_points_cams(new_Ps.copy(), xs, Ns)
            new_Xs = dlt_triangulation(norm_P, norm_x, visible)[:, :3]
        else:
            new_Xs = dlt_triangulation(new_Ps, xs, visible)[:, :3]
        bad = ~np.isfinite(new_Xs).all(axis=1)
        if bad.any():
            new_Xs[bad] = 0.0
        if return_repro:
            results["repro_middle_triangulated"] = float(
                np.nanmean(reprojection_error_with_points(new_Ps, new_Xs, xs, visible))
            )
        new_Ps, new_Xs, converged = run_projective_ba(
            new_Ps, new_Xs, visible_xs, point_indices, print_out=print_out, opts=opts
        )
        results["converged2"] = converged

    if return_repro:
        results["repro_after"] = float(
            np.nanmean(reprojection_error_with_points(new_Ps, new_Xs, xs, visible))
        )

    new_Xs = np.concatenate([new_Xs, np.ones((new_Xs.shape[0], 1))], axis=1)
    results.update(Ps=new_Ps, Xs=new_Xs)
    return results
