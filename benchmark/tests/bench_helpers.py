"""Small cells for the CPU tests: a configuration's published layout at a
few layers and widths, on a scene of a few dozen points."""

from __future__ import annotations

import copy

from benchmark import spec

SMALL_GASFM = dict(num_layers=2, n_feat_proj=8, n_feat_scenepoint=8, n_feat_view=16,
                   n_feat_global=16, n_heads=2)


def small_cell(workload: str, n_views: int = 12, n_points: int = 80):
    cell = copy.deepcopy(spec.load(workload))
    model = cell.config["conf"]["model"]
    if "num_layers" in model:
        model.update(SMALL_GASFM)
    else:
        model.update(num_features=16)
    cell.traffic = dict(cell.traffic, n_views=n_views, n_points=n_points, expected_edges=None)
    return cell
