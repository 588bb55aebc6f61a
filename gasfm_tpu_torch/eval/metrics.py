"""Evaluation: the on-device training metric, the host metric battery and
bundle adjustment.

Counterpart of the JAX package's eval/metrics.py (reference
code/evaluation.py). ``core_errors_device`` (:407-452) is the training
step's ``our_repro``, whose per-edge gathers of the camera and point rows go
through the row-gather kernel (``ops/kernels/segment_kernels.py``): three
launches per call. The rest runs on the host in float64 NumPy, a copy of
the JAX package's: ``compute_core_errors`` (:64), ``prepare_predictions``
(:99: denormalize, triangulate, align, optional bundle adjustment),
``compute_errors`` (:236) and ``get_dummy_errors`` (:352).
:func:`predictions_to_host` takes the place of the JAX package's
``unpad_predictions`` (:33), which crops the TPU's padding: the port's graph
holds the valid edges only, so the dense depths are scattered through its
``cam_idx`` / ``pt_idx``.
"""

from __future__ import annotations

from time import time
from typing import Any, Dict

import numpy as np
import torch

from gasfm_tpu_torch.data.scene import SceneData
from gasfm_tpu_torch.geometry.alignment import align_cameras, translation_rotation_errors
from gasfm_tpu_torch.geometry.np_geo import (
    M_to_xs,
    decompose_camera_matrix,
    get_positive_projected_pts_mask,
    pflat,
    reprojection_error_backproj_random_view_pairs,
    reprojection_error_with_points,
    xs_valid_points,
)
from gasfm_tpu_torch.geometry.triangulation import n_view_triangulation


def predictions_to_host(pred: Dict[str, torch.Tensor], data: SceneData,
                        graph) -> Dict[str, np.ndarray]:
    """A forward's predictions on the host in float64: ``Ps_norm`` (m, 3, 4)
    and ``pts3D`` (4, n); with the depth head ``depths_edges`` (E,), in the
    graph's edge order, and ``depths_dense`` (m, n), zero where no edge is.
    ``graph`` is the :class:`~gasfm_tpu_torch.graph.view_graph.ViewGraph`
    the forward ran on (on a mesh, the rank's shard: its whole scene's edge
    order, that of the depths made whole)."""
    out = {}
    if "Ps_norm" in pred:
        out["Ps_norm"] = pred["Ps_norm"].detach().cpu().numpy().astype(np.float64)
    if "pts3D" in pred:
        out["pts3D"] = pred["pts3D"].detach().cpu().numpy().astype(np.float64)
    if "depths" in pred:
        depths = pred["depths"].detach().cpu().numpy().astype(np.float64)
        dense = np.zeros((data.num_views, data.num_points), dtype=np.float64)
        dense[graph.scene_edge_ids()] = depths
        out["depths_dense"] = dense
        out["depths_edges"] = depths
    return out


def _heads_enabled(conf):
    depth = conf.get_bool("model.depth_head.enabled", default=False)
    view = conf.get_bool("model.view_head.enabled", default=False)
    scenepoint = conf.get_bool("model.scenepoint_head.enabled", default=False)
    return depth, view, scenepoint


def compute_core_errors(data: SceneData, pred_np: Dict[str, np.ndarray], conf) -> Dict[str, float]:
    """Cheap per-step errors (``our_repro`` / depth-backproj repro).

    Parity: reference evaluation.py:8-74.
    """
    core: Dict[str, float] = {}
    depth_head, view_head, scenepoint_head = _heads_enabled(conf)
    explicit = view_head and scenepoint_head
    calc_backproj = conf.get_bool("eval.calc_reprojerr_with_gtposes_for_depth_pred", default=False)

    Ns_inv = np.transpose(data.Ns_invT, (0, 2, 1)).astype(np.float64)
    xs = M_to_xs(data.M.astype(np.float64))

    if explicit:
        Ps = Ns_inv @ pred_np["Ps_norm"]
        pts3D = pflat(pred_np["pts3D"])
        core["our_repro"] = float(np.nanmean(reprojection_error_with_points(Ps, pts3D.T, xs)))

    if calc_backproj:
        assert conf.get_bool("dataset.calibrated")
        assert depth_head, "backproj repro requires the depth head (parity)"
        dense = pred_np["depths_dense"]
        vals = pred_np["depths_edges"]
        s_pred = float(np.mean(vals))
        vis = xs_valid_points(xs)
        gt_vals = data.depths[vis]
        s_gt = float(np.mean(gt_vals))
        errors = reprojection_error_backproj_random_view_pairs(
            Ns_inv, data.y.astype(np.float64), dense / s_pred * s_gt, xs
        )
        core["repro_backproj_rnd_gt_2view"] = float(np.nanmean(errors))

    return core


def prepare_predictions(
    data: SceneData, pred_np: Dict[str, np.ndarray], conf, bundle_adjustment: bool
) -> Dict[str, Any]:
    """Parity: reference evaluation.py:76-225."""
    outputs: Dict[str, Any] = {"scene_name": data.scene_name}
    depth_head, view_head, scenepoint_head = _heads_enabled(conf)
    explicit = view_head and scenepoint_head
    calibrated = conf.get_bool("dataset.calibrated")
    calc_backproj = conf.get_bool("eval.calc_reprojerr_with_gtposes_for_depth_pred", default=False)

    Ns = data.Ns.astype(np.float64)
    Ns_inv = np.transpose(data.Ns_invT, (0, 2, 1)).astype(np.float64)
    M = data.M.astype(np.float64)
    xs = M_to_xs(M)
    outputs["xs"] = xs
    if calibrated:
        outputs["Ks"] = Ns_inv

    if calc_backproj:
        assert calibrated and depth_head
        outputs["Ps_gt"] = data.y.astype(np.float64)
        vals = pred_np["depths_edges"]
        vis = xs_valid_points(xs)
        outputs["s_pred"] = float(np.mean(vals))
        outputs["s_gt"] = float(np.mean(data.depths[vis]))
        outputs["depths_pred_dense"] = pred_np["depths_dense"]
        outputs["depths_gt_dense"] = data.depths.astype(np.float64)

    if not explicit:
        return outputs

    Ps_norm = pred_np["Ps_norm"]
    Ps = Ns_inv @ Ps_norm
    pts3D_pred = pflat(pred_np["pts3D"])

    try:
        pts3D_triangulated = n_view_triangulation(Ps, M=M, Ns=Ns)
    except np.linalg.LinAlgError:
        pts3D_triangulated = None

    outputs["Ps"] = Ps
    outputs["Ps_norm"] = Ps_norm
    outputs["pts3D_pred"] = pts3D_pred
    outputs["pts3D_triangulated"] = pts3D_triangulated

    if calibrated:
        Rs_gt, ts_gt = decompose_camera_matrix(data.y.astype(np.float64), Ns_inv)
        Rs_pred, ts_pred = decompose_camera_matrix(Ps_norm)
        outputs.update(
            Rs_gt=Rs_gt, ts_gt=ts_gt, Rs=Rs_pred, ts=ts_pred,
            cam_centers=ts_pred, cam_centers_gt=ts_gt,
        )

        Rs_fixed, ts_fixed, similarity_mat = align_cameras(
            Rs_pred, Rs_gt, ts_pred, ts_gt, return_alignment=True
        )
        outputs["Rs_fixed"] = Rs_fixed
        outputs["ts_fixed"] = ts_fixed
        outputs["pts3D_pred_fixed"] = similarity_mat @ pts3D_pred
        outputs["pts3D_triangulated_fixed"] = (
            None if pts3D_triangulated is None else similarity_mat @ pts3D_triangulated
        )

        if bundle_adjustment:
            from gasfm_tpu_torch.ba import euc_ba

            repeat = conf.get_bool("ba.repeat")
            triangulation = conf.get_bool("ba.triangulation")
            print_out = conf.get_bool("ba.print_out", default=True)
            begin = time()
            ba_res = euc_ba(
                xs,
                Rs=Rs_pred,
                ts=ts_pred,
                Ks=np.linalg.inv(Ns),
                Xs_our=pts3D_pred.T,
                Ps=None,
                Ns=Ns,
                repeat=repeat,
                triangulation=triangulation,
                return_repro=True,
                print_out=print_out,
                conf=conf,
            )
            outputs["ba_time"] = time() - begin
            outputs["Rs_ba"] = ba_res["Rs"]
            outputs["ts_ba"] = ba_res["ts"]
            outputs["Xs_ba"] = ba_res["Xs"].T
            outputs["Ps_ba"] = ba_res["Ps"]
            outputs["ba_converged1"] = ba_res["converged1"]
            if repeat:
                outputs["repro_ba_before"] = ba_res["repro_before"]
                outputs["repro_ba_middle"] = ba_res["repro_middle"]
                outputs["repro_ba_middle_triangulated"] = ba_res["repro_middle_triangulated"]
                outputs["repro_ba_after"] = ba_res["repro_after"]
                outputs["ba_converged2"] = ba_res["converged2"]

            R_ba_fixed, t_ba_fixed, similarity_mat = align_cameras(
                ba_res["Rs"], Rs_gt, ba_res["ts"], ts_gt, return_alignment=True
            )
            outputs["Rs_ba_fixed"] = R_ba_fixed
            outputs["ts_ba_fixed"] = t_ba_fixed
            outputs["Xs_ba_fixed"] = similarity_mat @ outputs["Xs_ba"]
    else:
        if bundle_adjustment:
            from gasfm_tpu_torch.ba import proj_ba

            repeat = conf.get_bool("ba.repeat")
            triangulation = conf.get_bool("ba.triangulation")
            print_out = conf.get_bool("ba.print_out", default=True)
            begin = time()
            ba_res = proj_ba(
                Ps=Ps,
                xs=xs,
                Xs_our=pts3D_pred.T,
                Ns=Ns,
                repeat=repeat,
                triangulation=triangulation,
                return_repro=True,
                normalize_in_tri=True,
                print_out=print_out,
                conf=conf,
            )
            outputs["ba_time"] = time() - begin
            outputs["Xs_ba"] = ba_res["Xs"].T
            outputs["Ps_ba"] = ba_res["Ps"]
            outputs["ba_converged1"] = ba_res["converged1"]
            if repeat:
                outputs["repro_ba_before"] = ba_res["repro_before"]
                outputs["repro_ba_middle"] = ba_res["repro_middle"]
                outputs["repro_ba_middle_triangulated"] = ba_res["repro_middle_triangulated"]
                outputs["repro_ba_after"] = ba_res["repro_after"]
                outputs["ba_converged2"] = ba_res["converged2"]

    return outputs


def compute_errors(outputs: Dict[str, Any], conf, bundle_adjustment: bool) -> Dict[str, float]:
    """Parity: reference evaluation.py:228-365."""
    errors: Dict[str, float] = {}
    depth_head, view_head, scenepoint_head = _heads_enabled(conf)
    explicit = view_head and scenepoint_head
    calibrated = conf.get_bool("dataset.calibrated")
    calc_backproj = conf.get_bool("eval.calc_reprojerr_with_gtposes_for_depth_pred", default=False)

    xs = outputs["xs"]
    visible = xs_valid_points(xs)

    # Gate on key presence, not depth_head alone: prepare_predictions stores
    # the dense depths only under calc_reprojerr_with_gtposes_for_depth_pred
    # (as the reference does, evaluation.py:99-126) — the reference's own
    # compute_errors gates on depth_head_enabled alone (evaluation.py:241)
    # and would KeyError for a depth-head config without that flag; here the
    # depth-stat block is simply skipped instead of crashing the eval pass.
    if depth_head and "depths_pred_dense" in outputs:
        dp = outputs["depths_pred_dense"] / outputs["s_pred"]
        dg = outputs["depths_gt_dense"] / outputs["s_gt"]
        errors["depth_pred_norm_mean"] = float(dp[visible].mean())
        for q, x in zip([10, 25, 50, 75, 90], np.quantile(dp[visible], [0.1, 0.25, 0.5, 0.75, 0.9])):
            errors[f"depth_pred_norm_q{q:02d}"] = float(x)
        errors["depth_pred_norm_min"] = float(dp[visible].min())
        errors["depth_pred_norm_max"] = float(dp[visible].max())
        errors["depth_gt_norm_mean"] = float(dg[visible].mean())
        for q, x in zip([10, 25, 50, 75, 90], np.quantile(dg[visible], [0.1, 0.25, 0.5, 0.75, 0.9])):
            errors[f"depth_gt_norm_q{q:02d}"] = float(x)
        errors["depth_gt_norm_min"] = float(dg[visible].min())
        errors["depth_gt_norm_max"] = float(dg[visible].max())
        errors["depth_pred_err_mean"] = float(np.mean(np.abs(dp[visible] - dg[visible])))

    if calc_backproj:
        assert depth_head
        dp = outputs["depths_pred_dense"] / outputs["s_pred"]
        reproj_errors, reproj_depths = reprojection_error_backproj_random_view_pairs(
            outputs["Ks"], outputs["Ps_gt"], dp * outputs["s_gt"], xs, calc_reproj_depths=True
        )
        reproj_depths = reproj_depths / outputs["s_gt"]
        errors["repro_backproj_rnd_gt_2view"] = float(np.nanmean(reproj_errors))
        errors["repro_backproj_depth_norm_mean_rnd_gt_2view"] = float(reproj_depths[visible].mean())
        errors["repro_backproj_depth_norm_min_rnd_gt_2view"] = float(reproj_depths[visible].min())
        errors["repro_backproj_depth_norm_max_rnd_gt_2view"] = float(reproj_depths[visible].max())
        for q, x in zip(
            [10, 25, 50, 75, 90], np.quantile(reproj_depths[visible], [0.1, 0.25, 0.5, 0.75, 0.9])
        ):
            errors[f"repro_backproj_depth_norm_q{q:02d}_rnd_gt_2view"] = float(x)

    if not explicit:
        return errors

    Ps = outputs["Ps"]
    pts3D_pred = outputs["pts3D_pred"]
    pts3D_triangulated = outputs["pts3D_triangulated"]

    errors["our_repro"] = float(np.nanmean(reprojection_error_with_points(Ps, pts3D_pred.T, xs)))
    errors["triangulated_repro"] = (
        float("nan")
        if pts3D_triangulated is None
        else float(np.nanmean(reprojection_error_with_points(Ps, pts3D_triangulated.T, xs)))
    )
    if calibrated:
        Rs_error, ts_error = translation_rotation_errors(
            outputs["Rs_fixed"], outputs["ts_fixed"], outputs["Rs_gt"], outputs["ts_gt"]
        )
        errors["t_err_mean"] = float(np.mean(ts_error))
        errors["t_err_med"] = float(np.median(ts_error))
        errors["R_err_mean"] = float(np.mean(Rs_error))
        errors["R_err_med"] = float(np.median(Rs_error))
        cc, ccg = outputs["cam_centers"], outputs["cam_centers_gt"]
        # Parity quirk, reproduced verbatim: the reference subtracts the
        # SCALAR mean over all 3m coordinates (np.mean with keepdims but no
        # axis, evaluation.py:324-325), not the per-axis centroid — the
        # "std" therefore measures spread around (mu, mu, mu). Kept so the
        # metric columns diff cleanly against reference tables.
        errors["cam_centers_std"] = float(np.mean(np.linalg.norm(cc - np.mean(cc, keepdims=True), axis=1)))
        errors["cam_centers_gt_std"] = float(
            np.mean(np.linalg.norm(ccg - np.mean(ccg, keepdims=True), axis=1))
        )

    if bundle_adjustment:
        errors["repro_ba"] = float(
            np.nanmean(reprojection_error_with_points(outputs["Ps_ba"], outputs["Xs_ba"].T, xs))
        )
        errors["ba_time"] = float(outputs["ba_time"])
        errors["ba_converged1"] = 1 if outputs["ba_converged1"] else 0
        if conf.get_bool("ba.repeat"):
            errors["repro_ba_before"] = float(outputs["repro_ba_before"])
            errors["repro_ba_middle"] = float(outputs["repro_ba_middle"])
            errors["repro_ba_middle_triangulated"] = float(outputs["repro_ba_middle_triangulated"])
            errors["repro_ba_after"] = float(outputs["repro_ba_after"])
            errors["ba_converged2"] = 1 if outputs["ba_converged2"] else 0
        if calibrated:
            Rs_ba_error, ts_ba_error = translation_rotation_errors(
                outputs["Rs_ba_fixed"], outputs["ts_ba_fixed"], outputs["Rs_gt"], outputs["ts_gt"]
            )
            errors["t_err_ba_mean"] = float(np.mean(ts_ba_error))
            errors["t_err_ba_med"] = float(np.median(ts_ba_error))
            errors["R_err_ba_mean"] = float(np.mean(Rs_ba_error))
            errors["R_err_ba_med"] = float(np.median(Rs_ba_error))

    pts2D_pred = Ps @ pts3D_pred
    pos_mask = get_positive_projected_pts_mask(pts2D_pred, conf.get_float("loss.infinity_pts_margin"))
    vis_neg = np.logical_and(~pos_mask, visible)
    n_views = np.any(visible, axis=1).sum()
    n_pts = np.any(visible, axis=1).sum()  # parity: reference repeats axis=1 (evaluation.py:356-357)
    errors["fraction_views_neg_depth_for_any_point"] = float(np.any(vis_neg, axis=1).sum() / n_views)
    errors["fraction_points_neg_depth_in_any_view"] = float(np.any(vis_neg, axis=0).sum() / n_pts)
    errors["total_fraction_points_neg_depth"] = float(vis_neg.sum() / visible.sum())
    errors["point_depth_mean"] = float(pts2D_pred[:, 2, :][visible].mean())
    errors["point_depth_min"] = float(pts2D_pred[:, 2, :][visible].min())
    errors["point_depth_max"] = float(pts2D_pred[:, 2, :][visible].max())

    return errors


def get_dummy_errors(conf, bundle_adjustment: bool) -> Dict[str, float]:
    """NaN schema for OOM-skipped scenes. Parity: evaluation.py:368-432."""
    nan = float("nan")
    errors: Dict[str, float] = {}
    depth_head, view_head, scenepoint_head = _heads_enabled(conf)
    explicit = view_head and scenepoint_head
    calibrated = conf.get_bool("dataset.calibrated")
    calc_backproj = conf.get_bool("eval.calc_reprojerr_with_gtposes_for_depth_pred", default=False)

    if calc_backproj:
        errors["repro_backproj_rnd_gt_2view"] = nan
        errors["repro_backproj_depth_norm_mean_rnd_gt_2view"] = nan
        errors["repro_backproj_depth_norm_min_rnd_gt_2view"] = nan
        errors["repro_backproj_depth_norm_max_rnd_gt_2view"] = nan
        for q in [10, 25, 50, 75, 90]:
            errors[f"repro_backproj_depth_norm_q{q:02d}_rnd_gt_2view"] = nan
    if depth_head:
        for prefix in ("depth_pred_norm", "depth_gt_norm"):
            errors[f"{prefix}_mean"] = nan
            errors[f"{prefix}_min"] = nan
            errors[f"{prefix}_max"] = nan
            for q in [10, 25, 50, 75, 90]:
                errors[f"{prefix}_q{q:02d}"] = nan
        errors["depth_pred_err_mean"] = nan
    if not explicit:
        return errors

    errors["our_repro"] = nan
    errors["triangulated_repro"] = nan
    if calibrated:
        errors.update(t_err_mean=nan, t_err_med=nan, R_err_mean=nan, R_err_med=nan)
    if bundle_adjustment:
        errors["repro_ba"] = nan
        errors["ba_converged1"] = nan
        if conf.get_bool("ba.repeat"):
            errors.update(
                repro_ba_before=nan,
                repro_ba_middle=nan,
                repro_ba_middle_triangulated=nan,
                repro_ba_after=nan,
                ba_converged2=nan,
            )
        if calibrated:
            errors.update(t_err_ba_mean=nan, t_err_ba_med=nan, R_err_ba_mean=nan, R_err_ba_med=nan)
    errors.update(
        fraction_views_neg_depth_for_any_point=nan,
        fraction_points_neg_depth_in_any_view=nan,
        total_fraction_points_neg_depth=nan,
        point_depth_mean=nan,
        point_depth_min=nan,
        point_depth_max=nan,
    )
    return errors


def core_errors_device(pred: Dict[str, torch.Tensor], scene,
                       plain: bool = False) -> Dict[str, torch.Tensor]:
    """``our_repro``: the mean pixel reprojection error of the predicted
    cameras and points against the observed 2D points, as a 0-d tensor on
    the scene's device (no host synchronisation). Pixel cameras are
    ``Ns_inv @ Ps_norm``; observations are recovered from the normalized ones
    as pflat(Ns_inv [uv; 1]). Edges whose error is not finite or whose
    depth or homogeneous weight is 0 are left out (np.nanmean semantics of
    the reference's evaluation.py:8-74). ``plain=True`` gathers with the
    kernel's plain version whatever the device. Under an edge mesh the
    scene's: the sum and the count go through ``all_sum`` (the JAX
    package's eval/metrics.py:447-452)."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as k
    from gasfm_tpu_torch.ops.segment import all_sum

    gather = k.gather_rows_plain if plain else k.gather_rows
    g = scene.graph
    m, E = g.num_cams, g.num_edges
    Ps = torch.einsum("mij,mjk->mik", scene.Ns_inv, pred["Ps_norm"])  # (m, 3, 4)
    P_e = gather(Ps.reshape(m, 12), g, "camera").reshape(E, 3, 4)
    X_e = gather(pred["pts3D"].T, g, "point")  # (E, 4)
    proj = torch.einsum("eij,ej->ei", P_e, X_e)  # (E, 3)
    z = proj[:, 2]
    uv_proj = proj[:, :2] / torch.where(z == 0, torch.ones_like(z), z)[:, None]
    uv1 = torch.cat([g.uv, torch.ones_like(g.uv[:, :1])], dim=1)
    N_e = gather(scene.Ns_inv.reshape(m, 9), g, "camera").reshape(E, 3, 3)
    pixh = torch.einsum("eij,ej->ei", N_e, uv1)
    w = pixh[:, 2]
    pix = pixh[:, :2] / torch.where(w == 0, torch.ones_like(w), w)[:, None]
    err = torch.sqrt(((uv_proj - pix) ** 2).sum(1))
    valid = torch.isfinite(err) & (z != 0) & (w != 0)
    # the scene's sum and count under an edge mesh (one all_sum of both)
    sums = all_sum(torch.stack([torch.where(valid, err, torch.zeros_like(err)).sum(),
                                valid.sum().to(err.dtype)]))
    return {"our_repro": sums[0] / sums[1].clamp_min(1)}
