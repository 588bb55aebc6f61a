"""``.mat`` readers for comparisons with external bundle-adjustment
pipelines: the counterpart of the JAX package's ba/io.py (reference
code/utils/ba_io.py:1-56), off the CLI's path. They read MATLAB-exported
scenes (``M`` measurement matrices, GT rotations / translations /
intrinsics, predicted cameras and points) with scipy's ``loadmat``, in the
reference's shapes:

- ``xs``: (m, n, 2) per-view 2D observations unpacked from the stacked
  ``M`` (2m, n) (``geometry/np_geo.M_to_xs``);
- ``Xs``: (n, 3) 3D points.
"""

from __future__ import annotations

import os

import numpy as np

from gasfm_tpu_torch.geometry.np_geo import M_to_xs


def _load_mat(path: str):
    import scipy.io as sio

    return sio.loadmat(path, squeeze_me=True)


def _m_to_xs(M) -> np.ndarray:
    """(2m, n) stacked measurement matrix -> (m, n, 2) observations."""
    return M_to_xs(np.asarray(M, dtype=np.float64))


def read_mat_files(path: str):
    """``<path>.mat``: cameras ``Ps`` (m, 3, 4), points ``Xs`` (n, 3),
    observations ``xs`` (m, n, 2)."""
    raw = _load_mat(path + ".mat")
    return {
        "Ps": np.stack(raw["Ps"]),
        "Xs": raw["Points3D"].T,
        "xs": _m_to_xs(raw["M"]),
    }


def read_euc_gt_mat_files(path: str):
    """``<path>.mat``: GT ``Rs``, ``ts``, ``Ks`` and the observations (``M``
    dense or MATLAB sparse)."""
    raw = _load_mat(path + ".mat")
    M = raw["M"]
    if not isinstance(M, (np.ndarray, np.generic)):
        M = np.asarray(M.todense())  # sparse MATLAB storage
    return {
        "Rs": np.stack(raw["R_gt"]),
        "ts": np.stack(raw["T_gt"]),
        "Ks": np.stack(raw["K_gt"]),
        "xs": _m_to_xs(M),
    }


def read_proj_gt_mat_files(path: str):
    """``<path>.mat``: the observations alone."""
    raw = _load_mat(path + ".mat")
    return {"xs": _m_to_xs(np.asarray(raw["M"]))}


def read_euc_our_mat_files(path: str, name: str = "Final_Cameras"):
    """``<path>/cameras/<name>.mat``: predicted points ``Xs`` (n, 3) and
    cameras ``Rs``, ``ts``, ``Ks``."""
    raw = _load_mat(os.path.join(path, "cameras", name) + ".mat")
    return {
        "Xs": raw["pts3D"][:3].T.astype(np.double),
        "Rs": raw["Rs"],
        "ts": raw["ts"],
        "Ks": raw["Ks"],
    }


def read_proj_our_mat_files(path: str, name: str = "Final_Cameras"):
    """``<path>/cameras/<name>.mat``: predicted points ``Xs`` (n, 3) and
    cameras ``Ps``."""
    raw = _load_mat(os.path.join(path, "cameras", name) + ".mat")
    return {
        "Xs": raw["pts3D"][:3].T.astype(np.double),
        "Ps": raw["Ps"],
    }
