"""Camera parameter packing for the native BA solver.

A copy of the JAX package's ba/packing.py (reference
code/utils/ceres_utils.py:11-46) — Euclidean cameras packed
as 12 doubles: [Rodrigues(R^T) (3), world2cam translation -R^T t (3),
upper-triangular K (5), 1]; unpacking inverts the transform. Uses the
self-contained Rodrigues implementation (no cv2 dependency needed).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gasfm_tpu_torch.geometry.np_geo import get_camera_matrix
from gasfm_tpu_torch.geometry.rotations import axis_angle_to_matrix_np, matrix_to_axis_angle_np


def order_cam_param_for_c(Rs: np.ndarray, ts: np.ndarray, Ks: np.ndarray) -> np.ndarray:
    """(m,3,3) cam->world rotations, (m,3) camera centers, (m,3,3) K ->
    (m, 12) packed params. Parity: ceres_utils.py:11-29."""
    m = len(Rs)
    packed = np.zeros((m, 12))
    packed[:, 0:3] = matrix_to_axis_angle_np(np.transpose(Rs, (0, 2, 1)))
    packed[:, 3:6] = (-np.transpose(Rs, (0, 2, 1)) @ ts.reshape(m, 3, 1)).reshape(m, 3)
    packed[:, 6] = Ks[:, 0, 0]
    packed[:, 7] = Ks[:, 0, 1]
    packed[:, 8] = Ks[:, 0, 2]
    packed[:, 9] = Ks[:, 1, 1]
    packed[:, 10] = Ks[:, 1, 2]
    packed[:, 11] = 1.0
    return packed


def reorder_from_c_to_py(packed: np.ndarray, Ks: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(m,12) packed -> (Rs cam->world, ts camera centers, Ps). Parity:
    ceres_utils.py:32-46."""
    m = len(packed)
    Rs = np.transpose(axis_angle_to_matrix_np(packed[:, 0:3]), (0, 2, 1))
    ts = (-Rs @ packed[:, 3:6].reshape(m, 3, 1)).reshape(m, 3)
    Ps = np.zeros((m, 3, 4))
    for i in range(m):
        Ps[i] = get_camera_matrix(Rs[i], ts[i], Ks[i])
    return Rs, ts, Ps
