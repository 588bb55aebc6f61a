"""Output heads decode: camera matrices and homogeneous 3D points.

Counterpart of the JAX package's models/heads.py (reference ``BaseNet``,
code/models/baseNet.py:8-92). The port's graphs hold real cameras only, so
there are no padded camera rows to guard.
"""

from __future__ import annotations

from typing import Optional

import torch

from gasfm_tpu_torch.geometry.rotations import (
    project_to_rot,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)


def view_head_out_channels(calibrated: bool, rot_representation: str) -> int:
    if not calibrated:
        return 12
    channels = {"6d": 9, "quat": 7, "svd": 12}
    if rot_representation not in channels:
        raise ValueError(f"Illegal output format: calibrated={calibrated}, rot={rot_representation}")
    return channels[rot_representation]


def decode_view_outputs(
    x: torch.Tensor,  # (m, out_channels)
    calibrated: bool,
    rot_representation: str = "quat",
    normalize_output: Optional[str] = None,
) -> torch.Tensor:
    """(m, C) head outputs -> (m, 3, 4) normalized camera matrices."""
    if calibrated:
        if rot_representation == "6d":
            RTs = rotation_6d_to_matrix(x[:, :6])
        elif rot_representation == "svd":
            RTs = project_to_rot(x[:, :9].reshape(-1, 3, 3))
        elif rot_representation == "quat":
            RTs = quaternion_to_matrix(x[:, :4])
        else:
            raise ValueError(f"Illegal rot representation {rot_representation!r}")
        return torch.cat([RTs, x[:, -3:, None]], dim=-1)
    Ps = x.reshape(-1, 3, 4)
    if normalize_output in ("Chirality", "Differentiable Chirality"):
        det = torch.linalg.det(Ps[:, 0:3, 0:3])
        row3 = torch.linalg.norm(Ps[:, 2, 0:3], dim=1).clamp_min(1e-12)
        if normalize_output == "Chirality":
            scale = torch.sign(det) / row3
        else:  # the reference multiplies det by 10e3 == 1e4 before the softsign
            scale = torch.nn.functional.softsign(det * 10e3) / row3
        Ps = Ps * scale[:, None, None]
    elif normalize_output == "Frobenius":
        fro = torch.linalg.norm(Ps.reshape(Ps.shape[0], -1), dim=1).clamp_min(1e-12)
        Ps = Ps / fro[:, None, None]
    return Ps


def decode_scenepoint_outputs(pts_3d: torch.Tensor) -> torch.Tensor:
    """(3, n) -> (4, n) homogeneous (ones padding)."""
    return torch.cat([pts_3d, torch.ones_like(pts_3d[:1])], dim=0)
