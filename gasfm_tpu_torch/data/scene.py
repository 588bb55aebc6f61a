"""Host-side scene container (numpy) and its conversion to a device scene.

The subset of the JAX package's data/scene.py that the forward slice needs:
the (2m, n) measurement matrix, per-view normalization matrices Ns
(= inv(K) when calibrated), GT cameras and the validity mask.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from gasfm_tpu_torch.geometry.np_geo import get_M_valid_points, normalize_M


class SceneData:
    def __init__(
        self,
        M: np.ndarray,
        Ns: np.ndarray,
        Ps_gt: np.ndarray,
        scene_name: str,
        calibrated: bool = False,
    ):
        self.scene_name = scene_name
        self.calibrated = calibrated
        self.M = np.asarray(M, dtype=np.float32)
        self.Ns = np.asarray(Ns, dtype=np.float32)
        self.y = np.asarray(Ps_gt, dtype=np.float32)  # GT cameras ("y" as in reference)
        assert self.M.shape[0] == 2 * self.y.shape[0]
        self.valid_pts = get_M_valid_points(self.M)  # (m, n)
        self.norm_M = normalize_M(self.M, self.Ns, self.valid_pts)  # (m, n, 2)

    def to_scene_graph(self, device: Optional[Union[str, torch.device]] = None):
        from gasfm_tpu_torch.graph.view_graph import build_scene_graph

        return build_scene_graph(self.M, self.Ns, self.y, device=device)
