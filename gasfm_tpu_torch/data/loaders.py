"""Scenes from ``.npz`` archives (Euclidean / Projective) or a conf's
synthetic block: the scene-construction entry points.

Counterpart of the JAX package's data/loaders.py (reference
code/datasets/Euclidean.py:11-44, Projective.py:10-40, SceneData.py:267-303
with the PantheonParis zero-visibility filter, and
dataset_utils.correct_matches_global, dataset_utils.py:58-68, for
``use_gt``). Archives live under ``dataset.datasets_path``, else
``$GASFM_DATASETS_PATH``, else ``datasets/`` at the repository's root.
"""

from __future__ import annotations

import os
import zlib
from typing import List, Optional

import numpy as np

from gasfm_tpu_torch.data.scene import SceneData
from gasfm_tpu_torch.geometry.np_geo import batch_pflat, get_M_valid_points
from gasfm_tpu_torch.geometry.triangulation import n_view_triangulation

_DEFAULT_DATASETS_PATH = os.environ.get(
    "GASFM_DATASETS_PATH", os.path.join(os.path.dirname(__file__), "..", "..", "datasets")
)

# Scenes whose points seen in no view are dropped (reference SceneData.py:286-292).
_SCENES_NEEDING_POINT_FILTER = {"PantheonParis"}


def path_to_datasets(conf=None) -> str:
    if conf is not None:
        p = conf.get_string("dataset.datasets_path", default=None)
        if p:
            return p
    return _DEFAULT_DATASETS_PATH


def correct_matches_global(M: np.ndarray, Ps: np.ndarray, Ns: np.ndarray) -> np.ndarray:
    """The measurements replaced by the reprojections of the points
    triangulated from the GT cameras (0 where unobserved)."""
    M_invalid = ~get_M_valid_points(M)
    Xs = n_view_triangulation(Ps, M, Ns)
    xs = batch_pflat(Ps @ Xs)[:, 0:2, :]
    xs = np.nan_to_num(xs, nan=0.0, posinf=0.0, neginf=0.0)
    xs[np.stack((M_invalid, M_invalid), axis=1)] = 0
    return xs.reshape(M.shape)


def get_raw_data_euclidean(scene: str, use_gt: bool, datasets_path: Optional[str] = None):
    """(M, Ns = inv(K), Ps_gt) of ``Euclidean/<scene>.npz`` (keys ``M``,
    ``Ps_gt``, ``K_gt``), the cameras scaled to rotations."""
    path = os.path.join(datasets_path or _DEFAULT_DATASETS_PATH, "Euclidean", f"{scene}.npz")
    data = np.load(path)
    M = data["M"].astype(np.float64)
    Ps_gt = data["Ps_gt"].astype(np.float64)
    Ns = np.linalg.inv(data["K_gt"].astype(np.float64))
    Ns = Ns / Ns[:, 2, 2][:, None, None]
    Ps_gt = Ps_gt / np.linalg.det(Ns @ Ps_gt[:, :, :3])[:, None, None] ** (1.0 / 3.0)
    R_gt = Ns @ Ps_gt[:, :, :3]
    assert np.allclose(R_gt.swapaxes(1, 2) @ R_gt, np.eye(3)[None], atol=1e-5)
    if use_gt:
        M = correct_matches_global(M, Ps_gt, Ns)
    return M.astype(np.float32), Ns.astype(np.float32), Ps_gt.astype(np.float32)


def get_raw_data_projective(scene: str, use_gt: bool, datasets_path: Optional[str] = None):
    """(M, Ns, Ps_gt) of ``Projective/<scene>.npz`` (keys ``M``, ``Ps_gt``,
    ``Ns``)."""
    path = os.path.join(datasets_path or _DEFAULT_DATASETS_PATH, "Projective", f"{scene}.npz")
    data = np.load(path)
    M = data["M"].astype(np.float64)
    Ps_gt = data["Ps_gt"].astype(np.float64)
    Ns = data["Ns"].astype(np.float64)
    Ns = Ns / Ns[:, 2, 2][:, None, None]
    if use_gt:
        M = correct_matches_global(M, Ps_gt, Ns)
    return M.astype(np.float32), Ns.astype(np.float32), Ps_gt.astype(np.float32)


def create_scene_data(
    conf,
    scene: Optional[str] = None,
    calibrated: Optional[bool] = None,
    use_gt: Optional[bool] = None,
) -> SceneData:
    """The scene of a conf (``dataset.scene``, ``dataset.calibrated``,
    ``dataset.use_gt`` unless given): with ``dataset.synthetic.enabled`` a
    synthetic scene, its seed offset by the CRC-32 of the scene's name (the
    same scene on every host and run), else the scene's archive. GT depths
    with ``model.depth_head.enabled``. Asserts a valid sample."""
    store_depth_targets = conf.get_bool("model.depth_head.enabled", default=False)
    scene = scene if scene is not None else conf.get_string("dataset.scene")
    calibrated = calibrated if calibrated is not None else conf.get_bool("dataset.calibrated")
    use_gt = use_gt if use_gt is not None else conf.get_bool("dataset.use_gt")

    if conf.get_bool("dataset.synthetic.enabled", default=False):
        from gasfm_tpu_torch.data.synthetic import synthetic_scene_from_conf

        seed_offset = zlib.crc32(scene.encode()) % 10_000 if scene else 0
        base_conf = conf.copy()
        base_conf.put("dataset.synthetic.seed",
                      conf.get_int("dataset.synthetic.seed", default=0) + seed_offset)
        data = synthetic_scene_from_conf(base_conf, scene_name=scene)
        assert data.is_valid_sample()
        return data

    datasets_path = path_to_datasets(conf)
    if calibrated:
        M, Ns, Ps_gt = get_raw_data_euclidean(scene, use_gt, datasets_path)
    else:
        M, Ns, Ps_gt = get_raw_data_projective(scene, use_gt, datasets_path)

    if scene in _SCENES_NEEDING_POINT_FILTER:
        M = M[:, get_M_valid_points(M).any(axis=0)]

    data = SceneData(M, Ns, Ps_gt, scene, calibrated=calibrated,
                     store_depth_targets=store_depth_targets)
    assert data.is_valid_sample()
    return data


def create_scene_data_from_list(scene_names: List[str], conf) -> List[SceneData]:
    """One scene per name (reference SceneData.py:456-462)."""
    return [create_scene_data(conf, scene=name) for name in scene_names]
