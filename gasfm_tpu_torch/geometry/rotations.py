"""Rotation parametrizations in PyTorch (the torch half of the JAX package's
geometry/rotations.py): pytorch3d ``quaternion_to_matrix`` and
``rotation_6d_to_matrix`` semantics, and the SVD projection to SO(3)."""

from __future__ import annotations

import torch


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotations; normalizes
    implicitly via 2 / ||q||^2, real part first."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3); rows are the orthonormalized basis."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def project_to_rot(m: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) matrices to SO(3) via SVD with a det fix-up."""
    u, _, vt = torch.linalg.svd(m, full_matrices=False)
    det = torch.linalg.det(u @ vt)
    vt = torch.cat([vt[..., :2, :], vt[..., 2:, :] * det[..., None, None]], dim=-2)
    return u @ vt
