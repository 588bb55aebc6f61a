"""The benchmark's scene generator: a frozen copy of the synthetic
calibrated scene of the port's ``data/synthetic.py`` (cameras on an arc
looking at a point cloud near the origin, track-like visibility).

Two seeds: ``layout_seed`` (the traffic file's) draws which camera sees
which point, so every run of a cell has the same edges and the same work;
``seed`` (the run's ``--seed``) draws the points' positions, so the
observations differ from run to run. With both seeds equal the scene is the
program generator's scene of that seed; the projections are taken per
observation rather than over the whole (m, n) grid, which a collection's
scale makes large.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MIN_VIEWS_PER_POINT = 2
MIN_POINTS_PER_VIEW = 8


@dataclass
class Scene:
    M: np.ndarray  # (2m, n) float32 observations, 0 where unobserved
    Ns: np.ndarray  # (m, 3, 3) float32 normalization (inverse intrinsics)
    Ps: np.ndarray  # (m, 3, 4) float32 ground-truth cameras
    name: str

    @property
    def num_edges(self) -> int:
        xy = self.M.reshape(self.M.shape[0] // 2, 2, -1)
        valid = np.abs(xy).sum(axis=1) != 0
        valid[:, valid.sum(axis=0) < MIN_VIEWS_PER_POINT] = False
        return int(valid.sum())


def _look_at(cam_pos: np.ndarray) -> np.ndarray:
    z = -cam_pos / np.linalg.norm(cam_pos)
    x = np.cross(z, np.array([0.0, 1.0, 0.0]))
    if np.linalg.norm(x) < 1e-8:
        x = np.cross(z, np.array([1.0, 0.0, 0.0]))
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=0)


def _visibility(rng, n_views, n_points, visibility, track_length_dist, powerlaw_alpha):
    vis = np.zeros((n_views, n_points), dtype=bool)
    for j in range(n_points):
        if track_length_dist == "powerlaw":
            w = min(MIN_VIEWS_PER_POINT + int(rng.pareto(powerlaw_alpha)), n_views)
        else:
            w = rng.integers(max(MIN_VIEWS_PER_POINT, int(visibility * n_views * 0.5)),
                             n_views + 1)
        start = rng.integers(0, n_views - w + 1)
        window = np.zeros(n_views, dtype=bool)
        window[start:start + w] = True
        if track_length_dist == "uniform":
            window &= ~(rng.random(n_views) > visibility)
        if window.sum() < MIN_VIEWS_PER_POINT:
            idx = rng.choice(np.arange(start, start + w), size=MIN_VIEWS_PER_POINT, replace=False)
            window[:] = False
            window[idx] = True
        vis[:, j] = window
    for i in range(n_views):
        deficit = MIN_POINTS_PER_VIEW - vis[i].sum()
        if deficit > 0:
            vis[i, rng.choice(np.nonzero(~vis[i])[0], size=deficit, replace=False)] = True
    return vis


def generate(traffic: dict, seed: int) -> Scene:
    """The scene of a traffic file's parameters and a run's seed."""
    n_views, n_points = int(traffic["n_views"]), int(traffic["n_points"])
    dist = traffic.get("track_length_dist", "uniform")
    if dist not in ("uniform", "powerlaw"):
        raise ValueError(f"track_length_dist {dist!r}: uniform or powerlaw")
    focal, principal = float(traffic.get("focal", 1000.0)), float(traffic.get("principal", 500.0))
    radius, arc = float(traffic.get("radius", 6.0)), float(traffic.get("arc_degrees", 120.0))

    layout = np.random.default_rng(int(traffic["layout_seed"]))
    layout.uniform(-1.5, 1.5, size=(n_points, 3))  # the positions' draws, kept for the stream
    vis = _visibility(layout, n_views, n_points, float(traffic.get("visibility", 0.75)), dist,
                      float(traffic.get("powerlaw_alpha", 1.8)))

    # seed % 2**64: numpy takes no negative seed; the others are unchanged
    X = np.random.default_rng(seed % 2**64).uniform(-1.5, 1.5, size=(n_points, 3))
    X[:, 2] *= 0.6
    K = np.array([[focal, 0.0, principal], [0.0, focal, principal], [0.0, 0.0, 1.0]])
    angles = np.deg2rad(np.linspace(-arc / 2, arc / 2, n_views))
    Ps = np.zeros((n_views, 3, 4))
    for i, a in enumerate(angles):
        cam_pos = np.array([radius * np.sin(a), 0.4 * np.sin(2 * a), -radius * np.cos(a)])
        R = _look_at(cam_pos)
        Ps[i] = K @ np.concatenate([R, (-R @ cam_pos)[:, None]], axis=1)
    cams, pts = np.nonzero(vis)
    proj = np.einsum("eij,ej->ei", Ps[cams],
                     np.concatenate([X[pts], np.ones((pts.size, 1))], axis=1))  # (E, 3)
    if not np.all(proj[:, 2] > 0):
        raise AssertionError("a point behind a camera")
    xs = proj[:, :2] / proj[:, 2:3]
    xs[(xs[:, 0] == 0) & (xs[:, 1] == 0), 0] = 1e-6  # an observation is nonzero

    M = np.zeros((2 * n_views, n_points), dtype=np.float32)
    M[2 * cams, pts] = xs[:, 0]
    M[2 * cams + 1, pts] = xs[:, 1]

    Ns = np.tile(np.linalg.inv(K), (n_views, 1, 1))
    Ns = Ns / Ns[:, 2, 2][:, None, None]
    Ps = Ps / np.linalg.det(Ns @ Ps[:, :, :3])[:, None, None] ** (1.0 / 3.0)
    scene = Scene(M=M, Ns=Ns.astype(np.float32), Ps=Ps.astype(np.float32),
                  name=f"synthetic_v{n_views}_p{n_points}_l{traffic['layout_seed']}_s{seed}")
    expected = traffic.get("expected_edges")
    if expected is not None and scene.num_edges != expected:
        raise AssertionError(f"{scene.num_edges} observations, the traffic file says {expected}")
    return scene
