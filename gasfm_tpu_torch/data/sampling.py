"""View subsampling and the max-shared-points view-curriculum subset.

Counterpart of the JAX package's data/sampling.py (reference
dataset_utils.sample_indices, dataset_utils.py:25-40, SceneData.sample_data,
SceneData.py:306-355, and SceneData.get_subset, SceneData.py:529-584): numpy
only, so that the loader's worker processes can run it. The same generator
draws give the same views.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gasfm_tpu_torch.data.scene import SceneData
from gasfm_tpu_torch.geometry.np_geo import get_M_valid_points


def sample_indices(
    N: int, num_samples: int, adjacent: bool, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Parity: reference dataset_utils.py:25-40."""
    if rng is None:
        rng = np.random.default_rng()
    if num_samples == 1:
        return np.arange(N)
    if num_samples < 1:
        num_samples = int(np.ceil(num_samples * N))
    num_samples = max(2, num_samples)
    if num_samples >= N:
        return np.arange(N)
    if adjacent:
        start = rng.integers(0, N - num_samples + 1)
        return np.arange(start, start + num_samples)
    return rng.choice(N, num_samples, replace=False)


def _subselect(data: SceneData, indices: np.ndarray) -> SceneData:
    """Build a SceneData from a subset of views, refiltering points that fall
    below the visibility minimum (shared core of sample_data/get_subset)."""
    indices = np.sort(np.asarray(indices))
    M_indices = np.sort(np.concatenate([2 * indices, 2 * indices + 1]))

    y, Ns = data.y[indices], data.Ns[indices]
    M = data.M[M_indices]
    depths = data.depths[indices, :] if data.store_depth_targets else None

    valid = get_M_valid_points(M)
    points_mask = valid.any(axis=0)
    M = M[:, points_mask]
    if depths is not None:
        depths = depths[:, points_mask]

    return SceneData(
        M,
        Ns,
        y,
        data.scene_name,
        calibrated=data.calibrated,
        store_depth_targets=data.store_depth_targets,
        depths=depths,
    )


def sample_data(
    data: SceneData,
    num_views: int,
    consecutive_views: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> SceneData:
    """Parity: reference SceneData.sample_data (SceneData.py:306-355)."""
    indices = sample_indices(data.num_views, num_views, adjacent=consecutive_views, rng=rng)
    sampled = _subselect(data, indices)
    if (sampled.pts_per_cam == 0).any():
        import warnings

        warnings.warn(f"Cameras with no points for dataset {data.scene_name}")
    return sampled


def get_subset(data: SceneData, subset_size: int, verbose: bool = False) -> SceneData:
    """Greedy max-shared-points view selection for the view-increment
    curriculum. Parity: reference SceneData.get_subset (SceneData.py:529-584)."""
    valid_pts = get_M_valid_points(data.M).copy()
    n_cams = valid_pts.shape[0]
    # Explicit contract: beyond n_cams the greedy argmax over an all-False
    # matrix would silently return index 0 repeatedly, building a sub-scene
    # with duplicated views. (The in-tree caller guards with
    # curr_n_views >= total_n_views before calling.)
    assert subset_size <= n_cams, (
        f"get_subset: subset_size {subset_size} exceeds the scene's "
        f"{n_cams} cameras"
    )

    first_idx = int(valid_pts.sum(axis=1).argmax())
    curr_pts = valid_pts[first_idx].copy()
    valid_pts[first_idx] = False
    indices = [first_idx]

    for _ in range(subset_size - 1):
        shared = np.broadcast_to(curr_pts, (n_cams, curr_pts.shape[0])) & valid_pts
        next_idx = int(shared.sum(axis=1).argmax())
        curr_pts = curr_pts | valid_pts[next_idx]
        valid_pts[next_idx] = False
        indices.append(next_idx)

    if verbose:
        print("Cameras are:")
        print(indices)

    return _subselect(data, np.array(indices))
