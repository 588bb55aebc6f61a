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


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 4) wxyz unit quaternions, w >= 0: the
    JAX package's ``matrix_to_quaternion`` (geometry/rotations.py:71-116).
    Of the four candidates (each solved from its own pivot, 4w², 4x², 4y² or
    4z²) the one with the largest pivot is taken, so a rotation near 180°,
    where w vanishes, still takes a well-conditioned branch, the same one as
    in the JAX package."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22  # = 4 w^2
    tx = 1.0 + m00 - m11 - m22  # = 4 x^2
    ty = 1.0 - m00 + m11 - m22  # = 4 y^2
    tz = 1.0 - m00 - m11 + m22  # = 4 z^2

    def cand(t, a, b, c, order):
        s = torch.sqrt(torch.clamp(t, min=1e-12))
        inv = 0.5 / s
        comps = {order[0]: 0.5 * s, order[1]: a * inv, order[2]: b * inv, order[3]: c * inv}
        return torch.stack([comps["w"], comps["x"], comps["y"], comps["z"]], dim=-1)

    cands = torch.stack([
        cand(tw, m21 - m12, m02 - m20, m10 - m01, "wxyz"),
        cand(tx, m21 - m12, m01 + m10, m02 + m20, "xwyz"),
        cand(ty, m02 - m20, m01 + m10, m12 + m21, "ywxz"),
        cand(tz, m10 - m01, m02 + m20, m12 + m21, "zwxy"),
    ], dim=-2)  # (..., 4 candidates, 4)
    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0 (sign(0) -> +)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
