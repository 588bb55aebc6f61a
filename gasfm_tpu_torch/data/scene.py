"""Host-side scene container (numpy) and its conversion to a device scene.

The JAX package's data/scene.py: the (2m, n) measurement matrix, per-view
normalization matrices Ns (= inv(K) when calibrated) and their inverses'
transposes ``Ns_invT`` (float32, as the metrics read them), GT cameras, the
validity mask, the sample validity test and the data statistics of the
final evaluation's rows, and optional GT depths from host DLT triangulation
in float64 with the JAX package's (and the reference's, SceneData.py:57-132)
invariant asserts.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from gasfm_tpu_torch.geometry.np_geo import M_to_xs, get_M_valid_points, normalize_M
from gasfm_tpu_torch.geometry.triangulation import n_view_triangulation
from gasfm_tpu_torch.utils.constants import MIN_N_POINTS_PER_VIEW, MIN_N_VIEWS_PER_POINT


class SceneData:
    def __init__(
        self,
        M: np.ndarray,
        Ns: np.ndarray,
        Ps_gt: np.ndarray,
        scene_name: str,
        calibrated: bool = False,
        store_depth_targets: bool = False,
        depths: Optional[np.ndarray] = None,
    ):
        self.scene_name = scene_name
        self.calibrated = calibrated
        self.store_depth_targets = store_depth_targets
        self.M = np.asarray(M, dtype=np.float32)
        self.Ns = np.asarray(Ns, dtype=np.float32)
        self.y = np.asarray(Ps_gt, dtype=np.float32)  # GT cameras ("y" as in reference)
        n_images = self.y.shape[0]
        assert self.M.shape[0] == 2 * n_images
        self.valid_pts = get_M_valid_points(self.M)  # (m, n)
        self.norm_M = normalize_M(self.M, self.Ns, self.valid_pts)  # (m, n, 2)
        self.Ns_invT = np.transpose(
            np.linalg.inv(self.Ns.astype(np.float64)).astype(np.float32), (0, 2, 1))
        self.depths = None  # (m, n) GT depths with store_depth_targets
        self._host_graph = None  # host_graph()'s
        if store_depth_targets:
            self.depths = (np.asarray(depths, dtype=np.float32) if depths is not None
                           else self._triangulated_depths())
            assert self.depths.shape == (n_images, self.M.shape[1])

    @property
    def num_views(self) -> int:
        return self.y.shape[0]

    @property
    def num_points(self) -> int:
        return self.M.shape[1]

    @property
    def pts_per_cam(self) -> np.ndarray:
        return self.valid_pts.sum(axis=1)

    @property
    def cam_per_pts(self) -> np.ndarray:
        return self.valid_pts.sum(axis=0)

    def is_valid_sample(self) -> bool:
        """Every view sees at least MIN_N_POINTS_PER_VIEW points and every
        point lies in at least MIN_N_VIEWS_PER_POINT views (the JAX
        package's, reference dataset_utils.py:12-14)."""
        return bool(self.pts_per_cam.min() >= MIN_N_POINTS_PER_VIEW
                    and self.cam_per_pts.min() >= MIN_N_VIEWS_PER_POINT)

    def get_data_statistics(self) -> dict:
        """The scene's statistics that the best-model evaluation adds to its
        row (reference dataset_utils.py:49-55)."""
        valid_stat = self.valid_pts.sum(axis=0).astype(np.float64)
        return {
            "Max_2d_pt": float(self.M.max()),
            "Num_2d_pts": int(self.valid_pts.sum()),
            "n_pts": int(self.M.shape[-1]),
            "Cameras_per_pts_mean": float(valid_stat.mean()),
            "Cameras_per_pts_std": float(valid_stat.std(ddof=1)),
            "Num of cameras": int(self.y.shape[0]),
        }

    def xs(self) -> np.ndarray:
        return M_to_xs(self.M)

    def _triangulated_depths(self) -> np.ndarray:
        """(m, n) depths of the GT points, triangulated from the GT cameras in
        float64, in each camera's calibrated frame."""
        if not self.calibrated:
            raise NotImplementedError("depth targets of an uncalibrated scene (the JAX "
                                      "package and the reference have none either)")
        K_inv = self.Ns.astype(np.float64)
        Ps = self.y.astype(np.float64)
        X = n_view_triangulation(Ps, self.M.astype(np.float64), Ns=K_inv)  # (4, n)
        valid_scenepoint = self.valid_pts.any(axis=0)
        assert np.all(np.isfinite(X[:, valid_scenepoint]))
        assert np.allclose(X[3, valid_scenepoint], 1.0)
        assert np.allclose(K_inv[:, 2, :], np.array([0.0, 0.0, 1.0])[None, None, :])
        R = K_inv @ Ps[:, :, :3]
        assert np.allclose(np.linalg.norm(R, axis=2), 1.0, atol=1e-4)
        depths = (K_inv @ Ps @ X)[:, 2, :]
        vi, vj = np.nonzero(self.valid_pts)
        assert np.all(np.isfinite(depths[vi, vj]))
        assert np.all(depths[vi, vj] > 0), "negative GT depths at valid points"
        return depths.astype(np.float32)

    def host_graph(self):
        """The host half of the scene's graph
        (:class:`~gasfm_tpu_torch.graph.view_graph.HostSceneGraph`, numpy
        only), built at the first call and kept with the scene: a loader's
        thread builds it, :meth:`to_scene_graph` uploads it."""
        if self._host_graph is None:
            from gasfm_tpu_torch.graph.view_graph import build_host_scene_graph

            self._host_graph = build_host_scene_graph(self.M, self.Ns, self.y,
                                                      gt_depths_dense=self.depths)
        return self._host_graph

    def to_scene_graph(self, device: Optional[Union[str, torch.device]] = None):
        from gasfm_tpu_torch.graph.view_graph import upload

        return upload(self.host_graph(), device)
