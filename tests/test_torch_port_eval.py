"""The port's evaluation battery and bundle adjustment against the JAX
package's, on the CPU, float64 numpy in and out.

Inputs: the synthetic scene of ``confs/synth/optim_synth_*.conf`` (10 views,
100 points), Euclidean and projective, built by both packages' generators
from the same seed, and predictions made from its GT cameras and GT points
perturbed from a seeded generator (rotations by ~3°, centers and points by
~0.05 of the scene, projective cameras by ~1% of their entries), so that the
alignment, the triangulation and bundle adjustment have work to do.

- Every numpy helper the metrics and BA use (``geometry/rotations.py``,
  ``np_geo.py``, ``alignment.py``, ``triangulation.py``, ``ba/packing.py``)
  on the same inputs: the same values within 1e-9 relative (the same float64
  code on both sides, so in practice bitwise). The backprojection metric's
  shuffle takes a random generator: both get one of the same seed.
- ``compute_core_errors``, ``prepare_predictions``, ``compute_errors`` and
  ``get_dummy_errors`` for the explicit-head confs (Euclidean and
  projective, bundle adjustment on and off, ``ba.num_threads = 1`` so the
  solver sums in one order) and the depth conf: the same keys, values
  within 1e-9 relative, except ``ba_time`` (a wall time). The depth conf's
  backprojection metric draws from an unseeded generator in both packages
  (``np_geo.py`` :238-239, :272): through ``compute_core_errors`` and
  ``compute_errors`` only its keys and finiteness are checked.
- ``euc_ba`` / ``proj_ba`` directly, with repeat and triangulation on and
  off and ``Ns`` omitted (``euc_ba`` then takes inv(K)): the same dicts.
"""

import numpy as np
import pytest

from gasfm_tpu.config import load_config as jax_load_config
from gasfm_tpu.data.scene import SceneData as JaxSceneData
import gasfm_tpu.ba as jax_ba
import gasfm_tpu.ba.packing as jax_packing
import gasfm_tpu.eval.metrics as jax_metrics
import gasfm_tpu.geometry.alignment as jax_alignment
import gasfm_tpu.geometry.np_geo as jax_geo
import gasfm_tpu.geometry.rotations as jax_rot
import gasfm_tpu.geometry.triangulation as jax_tri

from gasfm_tpu_torch.config import load_config
from gasfm_tpu_torch.data.scene import SceneData
from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
import gasfm_tpu_torch.ba as ba
import gasfm_tpu_torch.ba.packing as packing
import gasfm_tpu_torch.eval.metrics as metrics
import gasfm_tpu_torch.geometry.alignment as alignment
import gasfm_tpu_torch.geometry.np_geo as geo
import gasfm_tpu_torch.geometry.rotations as rot
import gasfm_tpu_torch.geometry.triangulation as tri

RTOL = 1e-9
CONFS = {"euc": "synth/optim_synth_gasfm.conf", "proj": "synth/optim_synth_proj_gasfm.conf",
         "depth": "synth/optim_synth_depth_gasfm.conf"}
TIMES = ("ba_time",)


def assert_same(got, want, path="", skip=()):
    """Equal structure; arrays and numbers within RTOL relative (NaN where
    NaN); ``skip``: keys whose values are wall times (their presence is
    still checked)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got),
                                                                       sorted(want))
        for k in want:
            if k not in skip:
                assert_same(got[k], want[k], f"{path}.{k}", skip)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", skip)
        return
    if want is None or isinstance(want, (str, bool)):
        assert got == want, (path, got, want)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, equal_nan=True, err_msg=path)


def confs(kind, **overrides):
    params = [f"{k}={v}" for k, v in {"ba.num_threads": 1, "ba.print_out": "false",
                                      **overrides}.items()]
    return load_config(CONFS[kind], external_params=params), jax_load_config(
        CONFS[kind], external_params=params)


def small_rotations(rng, m, deg):
    aa = rng.normal(size=(m, 3))
    aa *= np.deg2rad(deg) / np.linalg.norm(aa, axis=1, keepdims=True)
    return rot.axis_angle_to_matrix_np(aa)


def scene_and_predictions(kind, seed=0):
    """(port SceneData, JAX SceneData, predictions) for a conf's scene."""
    calibrated = kind != "proj"
    data = generate_synthetic_scene(n_views=10, n_points=100, visibility=0.8, seed=0,
                                    calibrated=calibrated, scene_name="synth0",
                                    store_depth_targets=kind == "depth")
    jdata = JaxSceneData(data.M, data.Ns, data.y, "synth0", calibrated=calibrated,
                         store_depth_targets=kind == "depth", depths=data.depths)
    rng = np.random.default_rng(seed)
    Ns, Ps = data.Ns.astype(np.float64), data.y.astype(np.float64)
    m, n = data.num_views, data.num_points
    X = tri.n_view_triangulation(Ps, data.M.astype(np.float64), Ns)  # (4, n), w = 1
    scale = np.abs(X[:3]).max()
    pts3D = X.copy()
    pts3D[:3] += rng.normal(0, 0.05 * scale, (3, n))
    pts3D *= rng.uniform(0.5, 2.0, n)  # homogeneous weights that pflat removes
    Ps_norm = Ns @ Ps
    if calibrated:
        R = small_rotations(rng, m, 3.0) @ Ps_norm[:, :, :3]
        t = Ps_norm[:, :, 3] + rng.normal(0, 0.05 * scale, (m, 3))
        Ps_norm = np.concatenate([R, t[:, :, None]], axis=2)
    else:
        Ps_norm = Ps_norm * (1 + rng.normal(0, 0.01, Ps_norm.shape))
    pred = {"Ps_norm": Ps_norm, "pts3D": pts3D}
    if kind == "depth":
        vis = data.valid_pts
        dense = np.where(vis, data.depths * rng.uniform(0.9, 1.1, (m, n)), 0.0)
        pred = {"depths_dense": dense, "depths_edges": dense[np.nonzero(vis)]}
    return data, jdata, pred


# -- the numpy helpers -------------------------------------------------------


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(1)
    aa = rng.normal(size=(64, 3)) * rng.uniform(0, np.pi, (64, 1))
    aa[0] = 0.0
    aa[1] = [np.pi, 0, 0]
    R = rot.axis_angle_to_matrix_np(aa)
    assert_same(R, jax_rot.axis_angle_to_matrix_np(aa))
    assert_same(rot.matrix_to_axis_angle_np(R), jax_rot.matrix_to_axis_angle_np(R))
    assert_same(rot._matrix_to_quaternion_np(R), jax_rot._matrix_to_quaternion_np(R))
    R2 = rot.axis_angle_to_matrix_np(rng.normal(size=(64, 3)))
    assert_same(rot.compare_rotations_np(R, R2), jax_rot.compare_rotations_np(R, R2))


@pytest.mark.parametrize("kind", ["euc", "proj"])
def test_np_geo_helpers_match_jax(kind):
    data, _, pred = scene_and_predictions(kind)
    M = data.M.astype(np.float64)
    Ns = data.Ns.astype(np.float64)
    Ks = np.linalg.inv(Ns)
    xs = geo.M_to_xs(M)
    Ps = Ks @ pred["Ps_norm"]
    X = geo.pflat(pred["pts3D"])
    for name, args in [
        ("xs_to_M", (xs,)), ("xs_valid_points", (xs,)), ("pflat", (pred["pts3D"],)),
        ("invert_euclidean_trafo", (pred["Ps_norm"][:, :, :3], pred["Ps_norm"][:, :, 3])),
        ("decompose_camera_matrix", (Ps, Ks)), ("decompose_camera_matrix", (pred["Ps_norm"],)),
        ("get_camera_matrix", (pred["Ps_norm"][0, :, :3], pred["Ps_norm"][0, :, 3], Ks[0])),
        ("batch_get_camera_matrix_from_rtk",
         (pred["Ps_norm"][:, :, :3], pred["Ps_norm"][:, :, 3], Ks)),
        ("reprojection_error_with_points", (Ps, X.T, xs)),
        ("reprojection_error_with_points", (Ps, X[:3].T, xs, geo.xs_valid_points(xs))),
        ("calc_global_reprojection_error", (Ps, M, Ns)),
        ("get_positive_projected_pts_mask", (Ps @ X, 1e-4)),
        ("get_projected_pts_mask", (Ps @ X, 1e-4)),
        ("batch_get_normalization_matrices", (xs,)),
        ("normalize_points_cams", (Ps, xs, Ns)),
    ]:
        assert_same(getattr(geo, name)(*args), getattr(jax_geo, name)(*args), name)


def test_triangulation_matches_jax_on_the_metrics_inputs():
    for kind in ("euc", "proj"):
        data, _, pred = scene_and_predictions(kind)
        M = data.M.astype(np.float64)
        Ns = data.Ns.astype(np.float64)
        Ps = np.linalg.inv(Ns) @ pred["Ps_norm"]
        assert_same(tri.n_view_triangulation(Ps, M=M, Ns=Ns),
                    jax_tri.n_view_triangulation(Ps, M=M, Ns=Ns))
        xs = geo.M_to_xs(M)
        vis = geo.xs_valid_points(xs)
        for simplified in (False, True):
            assert_same(tri.dlt_triangulation(Ps, xs, vis, simplified_dlt=simplified),
                        jax_tri.dlt_triangulation(Ps, xs, vis, simplified_dlt=simplified))


def test_backprojection_metric_matches_jax_with_the_same_generator():
    data, _, pred = scene_and_predictions("depth")
    xs = geo.M_to_xs(data.M.astype(np.float64))
    Ks = np.linalg.inv(data.Ns.astype(np.float64))
    Ps = data.y.astype(np.float64)
    vals = np.stack([np.arange(12.0), np.arange(12.0) * 2], axis=1)
    idx = np.array([[0, 1, 2, 0, 1, 2, 3, 3, 0, 1, 2, 3], [0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3]])
    assert_same(geo.shuffle_coo_along_axis_preserving_pattern(vals, idx, 0,
                                                              np.random.default_rng(5)),
                jax_geo.shuffle_coo_along_axis_preserving_pattern(vals, idx, 0,
                                                                  np.random.default_rng(5)))
    for calc_depths in (False, True):
        got = geo.reprojection_error_backproj_random_view_pairs(
            Ks, Ps, pred["depths_dense"], xs, calc_reproj_depths=calc_depths,
            rng=np.random.default_rng(7))
        want = jax_geo.reprojection_error_backproj_random_view_pairs(
            Ks, Ps, pred["depths_dense"], xs, calc_reproj_depths=calc_depths,
            rng=np.random.default_rng(7))
        assert_same(got, want)


def test_alignment_matches_jax():
    data, _, pred = scene_and_predictions("euc")
    Ns = data.Ns.astype(np.float64)
    Rs_gt, ts_gt = geo.decompose_camera_matrix(data.y.astype(np.float64), np.linalg.inv(Ns))
    Rs, ts = geo.decompose_camera_matrix(pred["Ps_norm"])
    # a similarity away from the GT frame, so the alignment has one to find
    S = rot.axis_angle_to_matrix_np(np.array([0.3, -0.2, 0.5]))
    Rs, ts = S @ Rs, 2.5 * ts @ S.T + np.array([1.0, -2.0, 0.5])
    for ret in (False, True):
        assert_same(alignment.align_cameras(Rs, Rs_gt, ts, ts_gt, return_alignment=ret),
                    jax_alignment.align_cameras(Rs, Rs_gt, ts, ts_gt, return_alignment=ret))
    assert_same(alignment.solve_sum_of_norms_scale_translation(ts, ts_gt),
                jax_alignment.solve_sum_of_norms_scale_translation(ts, ts_gt))
    assert_same(alignment.tranlsation_rotation_errors(Rs, ts, Rs_gt, ts_gt),
                jax_alignment.tranlsation_rotation_errors(Rs, ts, Rs_gt, ts_gt))
    assert alignment.translation_rotation_errors is alignment.tranlsation_rotation_errors


def test_ba_packing_matches_jax():
    data, _, pred = scene_and_predictions("euc")
    Ks = np.linalg.inv(data.Ns.astype(np.float64))
    Rs, ts = geo.decompose_camera_matrix(pred["Ps_norm"])
    packed = packing.order_cam_param_for_c(Rs, ts, Ks)
    assert_same(packed, jax_packing.order_cam_param_for_c(Rs, ts, Ks))
    assert_same(packing.reorder_from_c_to_py(packed, Ks),
                jax_packing.reorder_from_c_to_py(packed, Ks))


def test_scene_statistics_match_jax():
    data, jdata, _ = scene_and_predictions("euc")
    assert data.get_data_statistics() == jdata.get_data_statistics()
    assert_same(data.Ns_invT, jdata.Ns_invT)
    assert_same(data.xs(), jdata.xs())
    assert_same(data.pts_per_cam, jdata.pts_per_cam)
    assert_same(data.cam_per_pts, jdata.cam_per_pts)


# -- the metric battery ------------------------------------------------------


@pytest.mark.parametrize("kind,run_ba,repeat", [("euc", False, True), ("euc", True, True),
                                                ("euc", True, False), ("proj", False, True),
                                                ("proj", True, True), ("proj", True, False)])
def test_metric_battery_matches_jax(kind, run_ba, repeat):
    conf, jconf = confs(kind, **{"ba.repeat": str(repeat).lower()})
    data, jdata, pred = scene_and_predictions(kind)
    assert_same(metrics.compute_core_errors(data, pred, conf),
                jax_metrics.compute_core_errors(jdata, pred, jconf))
    outputs = metrics.prepare_predictions(data, pred, conf, run_ba)
    joutputs = jax_metrics.prepare_predictions(jdata, pred, jconf, run_ba)
    assert_same(outputs, joutputs, skip=TIMES)
    errors = metrics.compute_errors(outputs, conf, run_ba)
    assert_same(errors, jax_metrics.compute_errors(joutputs, jconf, run_ba), skip=TIMES)
    if run_ba:
        assert errors["repro_ba"] < errors["our_repro"]
    assert_same(metrics.get_dummy_errors(conf, run_ba),
                jax_metrics.get_dummy_errors(jconf, run_ba))


def test_depth_metrics_match_jax_and_the_backprojection_metric_is_finite():
    conf, jconf = confs("depth")
    data, jdata, pred = scene_and_predictions("depth")
    core = metrics.compute_core_errors(data, pred, conf)
    assert sorted(core) == sorted(jax_metrics.compute_core_errors(jdata, pred, jconf))
    assert np.isfinite(core["repro_backproj_rnd_gt_2view"])
    outputs = metrics.prepare_predictions(data, pred, conf, False)
    joutputs = jax_metrics.prepare_predictions(jdata, pred, jconf, False)
    assert_same(outputs, joutputs)
    errors = metrics.compute_errors(outputs, conf, False)
    jerrors = jax_metrics.compute_errors(joutputs, jconf, False)
    backproj = [k for k in jerrors if "backproj" in k]
    assert len(backproj) == 9
    assert_same({k: v for k, v in errors.items() if k not in backproj},
                {k: v for k, v in jerrors.items() if k not in backproj})
    assert sorted(errors) == sorted(jerrors)
    assert all(np.isfinite(errors[k]) for k in backproj)
    assert_same(metrics.get_dummy_errors(conf, False), jax_metrics.get_dummy_errors(jconf, False))


def test_predictions_to_host_scatters_the_graphs_edges():
    """The port's dense depths come from its graph's (camera, point) edges;
    the cameras and points go to the host in float64."""
    import torch

    data, _, pred = scene_and_predictions("depth")
    graph = data.to_scene_graph(device="cpu").graph
    cam, pt = graph.cam_idx.numpy(), graph.pt_idx.numpy()
    depths = torch.as_tensor(pred["depths_dense"][cam, pt], dtype=torch.float32)
    host = metrics.predictions_to_host({"depths": depths, "Ps_norm": torch.ones(10, 3, 4),
                                        "pts3D": torch.ones(4, 100)}, data, graph)
    assert host["Ps_norm"].dtype == np.float64 and host["pts3D"].shape == (4, 100)
    want = np.where(data.valid_pts, pred["depths_dense"].astype(np.float32), 0.0)
    np.testing.assert_array_equal(host["depths_dense"], want)
    np.testing.assert_array_equal(host["depths_edges"], want[cam, pt])


# -- bundle adjustment, directly ----------------------------------------------


@pytest.mark.parametrize("repeat,triangulation,with_ns", [(True, False, True),
                                                          (False, True, True),
                                                          (True, True, False),
                                                          (True, False, False)])
def test_euc_ba_matches_jax(repeat, triangulation, with_ns):
    conf, jconf = confs("euc")
    data, _, pred = scene_and_predictions("euc", seed=3)
    xs = geo.M_to_xs(data.M.astype(np.float64))
    Ns = data.Ns.astype(np.float64)
    Rs, ts = geo.decompose_camera_matrix(pred["Ps_norm"])
    kw = dict(Ks=np.linalg.inv(Ns), Xs_our=geo.pflat(pred["pts3D"])[:3].T,
              Ns=Ns if with_ns else None, repeat=repeat, triangulation=triangulation,
              print_out=False)
    got = ba.euc_ba(xs, Rs, ts, conf=conf, **kw)
    assert_same(got, jax_ba.euc_ba(xs, Rs, ts, conf=jconf, **kw))
    assert got["repro_after"] < got["repro_before"]


@pytest.mark.parametrize("repeat,triangulation", [(True, False), (False, True), (True, True)])
def test_proj_ba_matches_jax(repeat, triangulation):
    conf, jconf = confs("proj")
    data, _, pred = scene_and_predictions("proj", seed=3)
    xs = geo.M_to_xs(data.M.astype(np.float64))
    Ns = data.Ns.astype(np.float64)
    kw = dict(Ps=np.linalg.inv(Ns) @ pred["Ps_norm"], xs=xs,
              Xs_our=geo.pflat(pred["pts3D"])[:3].T, Ns=Ns, repeat=repeat,
              triangulation=triangulation, print_out=False)
    got = ba.proj_ba(conf=conf, **kw)
    assert_same(got, jax_ba.proj_ba(conf=jconf, **kw))
    assert got["repro_after"] < got["repro_before"]


def test_ba_solver_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A failed build raises with g++'s output; there is no build without
    OpenMP to fall back on."""
    from gasfm_tpu_torch.ba import native_lib

    bad = tmp_path / "ba_solver.cpp"
    bad.write_text('#include <omp.h>\nint f() { return omp_no_such_call(); }\n')
    monkeypatch.setattr(native_lib, "SRC", bad)
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="omp_no_such_call"):
        native_lib.build()
    assert not list((tmp_path / "_build").glob("*.so"))
