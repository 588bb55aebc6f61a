"""Synthetic calibrated/projective scene generation.

A copy of the JAX package's data/synthetic.py generator: the same seed gives
the same measurement matrix, normalization matrices and cameras (the tests
check this), so the port's benchmark scenes are the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gasfm_tpu_torch.data.scene import SceneData
from gasfm_tpu_torch.utils.constants import MIN_N_POINTS_PER_VIEW, MIN_N_VIEWS_PER_POINT


def look_at_rotation(cam_pos: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World->camera rotation for a camera at `cam_pos` looking at `target`."""
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    up = np.asarray(up, dtype=np.float64)
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-8:
        x = np.cross(z, np.array([1.0, 0.0, 0.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)  # rows


def generate_synthetic_scene(
    n_views: int = 12,
    n_points: int = 200,
    visibility: float = 0.75,
    noise_px: float = 0.0,
    seed: int = 0,
    calibrated: bool = True,
    scene_name: Optional[str] = None,
    store_depth_targets: bool = False,
    focal: float = 1000.0,
    principal: float = 500.0,
    radius: float = 6.0,
    arc_degrees: float = 120.0,
    track_length_dist: str = "uniform",
    powerlaw_alpha: float = 1.8,
) -> SceneData:
    """Cameras on an arc looking at a point cloud near the origin.

    Visibility per point is a contiguous window of views (track-like) with
    random dropout, constrained so every point has >= MIN_N_VIEWS_PER_POINT
    views and every view >= MIN_N_POINTS_PER_VIEW points.

    ``track_length_dist``: "uniform" (default; window widths uniform in
    [~visibility*m/2, m]) or "powerlaw" — track lengths follow a truncated
    Pareto (most tracks 2-5 views, a heavy tail up to all views; no extra
    dropout), matching real SfM scene statistics where short tracks
    dominate (e.g. the CVPR'24 benchmark scenes' published shapes).
    """
    rng = np.random.default_rng(seed)
    if scene_name is None:
        scene_name = f"synthetic_v{n_views}_p{n_points}_s{seed}"

    # Point cloud in a box in front of the ring of cameras.
    X = rng.uniform(-1.5, 1.5, size=(n_points, 3))
    X[:, 2] *= 0.6

    K = np.array([[focal, 0.0, principal], [0.0, focal, principal], [0.0, 0.0, 1.0]])
    Ks = np.tile(K, (n_views, 1, 1))

    angles = np.deg2rad(np.linspace(-arc_degrees / 2, arc_degrees / 2, n_views))
    Ps = np.zeros((n_views, 3, 4))
    for i, a in enumerate(angles):
        cam_pos = np.array([radius * np.sin(a), 0.4 * np.sin(2 * a), -radius * np.cos(a)])
        R = look_at_rotation(cam_pos, np.zeros(3))
        t = -R @ cam_pos
        Ps[i] = Ks[i] @ np.concatenate([R, t[:, None]], axis=1)

    # Projections (m, n, 2)
    X4 = np.concatenate([X, np.ones((n_points, 1))], axis=1)
    proj = Ps @ X4.T  # (m, 3, n)
    depths = proj[:, 2, :]
    assert np.all(depths > 0), "synthetic construction guarantees positive depths"
    xs = (proj[:, :2, :] / depths[:, None, :]).transpose(0, 2, 1)
    if noise_px > 0:
        xs = xs + rng.normal(0.0, noise_px, size=xs.shape)

    # Track-like visibility: contiguous window per point (+ dropout for the
    # uniform distribution).
    assert track_length_dist in ("uniform", "powerlaw")
    vis = np.zeros((n_views, n_points), dtype=bool)
    for j in range(n_points):
        if track_length_dist == "powerlaw":
            w = MIN_N_VIEWS_PER_POINT + int(rng.pareto(powerlaw_alpha))
            w = min(w, n_views)
        else:
            w = rng.integers(
                max(MIN_N_VIEWS_PER_POINT, int(visibility * n_views * 0.5)), n_views + 1
            )
        start = rng.integers(0, n_views - w + 1)
        window = np.zeros(n_views, dtype=bool)
        window[start : start + w] = True
        if track_length_dist == "uniform":
            drop = rng.random(n_views) > visibility
            window &= ~drop
        if window.sum() < MIN_N_VIEWS_PER_POINT:
            idx = rng.choice(np.arange(start, start + w), size=MIN_N_VIEWS_PER_POINT, replace=False)
            window[:] = False
            window[idx] = True
        vis[:, j] = window

    # Ensure every view has enough points.
    for i in range(n_views):
        deficit = MIN_N_POINTS_PER_VIEW - vis[i].sum()
        if deficit > 0:
            candidates = np.nonzero(~vis[i])[0]
            add = rng.choice(candidates, size=deficit, replace=False)
            vis[i, add] = True

    M = np.zeros((2 * n_views, n_points), dtype=np.float64)
    for i in range(n_views):
        M[2 * i, vis[i]] = xs[i, vis[i], 0]
        M[2 * i + 1, vis[i]] = xs[i, vis[i], 1]

    # Guard against exact zeros at visible entries (would look invisible).
    zero_mask = (M[0::2] == 0) & (M[1::2] == 0) & vis
    if zero_mask.any():
        zi, zj = np.nonzero(zero_mask)
        M[2 * zi, zj] = 1e-6

    Ns = np.linalg.inv(Ks)
    if calibrated:
        # Match the Euclidean loader's conditioning: N has last row [0,0,1]
        # and P is rescaled so N @ P[:, :3] is a rotation (reference
        # code/datasets/Euclidean.py:31-35).
        Ns = Ns / Ns[:, 2, 2][:, None, None]
        Ps = Ps / np.linalg.det(Ns @ Ps[:, :, :3])[:, None, None] ** (1.0 / 3.0)
        R_chk = Ns @ Ps[:, :, :3]
        assert np.allclose(R_chk.swapaxes(1, 2) @ R_chk, np.eye(3)[None], atol=1e-6)
    else:
        # Projective: use point-statistics normalization matrices.
        from gasfm_tpu_torch.geometry.np_geo import batch_get_normalization_matrices

        Ns = batch_get_normalization_matrices(xs)

    return SceneData(
        M,
        Ns,
        Ps,
        scene_name,
        calibrated=calibrated,
        store_depth_targets=store_depth_targets,
    )


def synthetic_scene_from_conf(conf, scene_name=None) -> SceneData:
    """The scene of a conf's ``dataset.synthetic`` block, with the JAX
    package's defaults (12 views, 200 points, visibility 0.75; its
    ``synthetic_scene_from_conf``, data/synthetic.py:159-170)."""
    sub = "dataset.synthetic"
    return generate_synthetic_scene(
        n_views=conf.get_int(f"{sub}.n_views", default=12),
        n_points=conf.get_int(f"{sub}.n_points", default=200),
        visibility=conf.get_float(f"{sub}.visibility", default=0.75),
        noise_px=conf.get_float(f"{sub}.noise_px", default=0.0),
        seed=conf.get_int(f"{sub}.seed", default=0),
        calibrated=conf.get_bool("dataset.calibrated", default=True),
        scene_name=scene_name,
        store_depth_targets=conf.get_bool("model.depth_head.enabled", default=False),
    )
