"""Rotation parametrizations: PyTorch (the model's heads) and NumPy (bundle
adjustment's packing, the evaluation's rotation errors).

The torch half of the JAX package's geometry/rotations.py (pytorch3d
``quaternion_to_matrix`` and ``rotation_6d_to_matrix`` semantics, the SVD
projection to SO(3)) and a copy of its NumPy half (Rodrigues vectors through
quaternions, the geodesic angle between rotations)."""

from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# NumPy (host): bundle adjustment's packing, the evaluation
# ---------------------------------------------------------------------------


def axis_angle_to_matrix_np(aa: np.ndarray) -> np.ndarray:
    aa = np.asarray(aa, dtype=np.float64)
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    small = (theta < 1e-12)[..., 0]
    axis = aa / np.where(theta < 1e-12, 1.0, theta)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    K = np.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1).reshape(aa.shape[:-1] + (3, 3))
    t = theta[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape).copy()
    R = eye + np.sin(t) * K + (1.0 - np.cos(t)) * (K @ K)
    R[small] = eye[small]
    return R


def _matrix_to_quaternion_np(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) wxyz unit quaternions (branch-free, robust
    at all angles including theta ~ pi)."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    qw = np.sqrt(np.maximum(1.0 + m00 + m11 + m22, 0.0)) / 2.0
    qx = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 0.0)) / 2.0
    qy = np.sqrt(np.maximum(1.0 - m00 + m11 - m22, 0.0)) / 2.0
    qz = np.sqrt(np.maximum(1.0 - m00 - m11 + m22, 0.0)) / 2.0
    q = np.stack([qw, qx, qy, qz], axis=-1)
    # Refine signs/values using the component of largest magnitude (stable).
    # Candidate reconstructions from each pivot:
    out = np.empty_like(q)
    pivot = np.argmax(q, axis=-1)
    it = np.ndindex(*q.shape[:-1])
    for idx in it:
        p = pivot[idx]
        Ri = R[idx]
        if p == 0:
            w = q[idx][0]
            out[idx] = [w, (Ri[2, 1] - Ri[1, 2]) / (4 * w), (Ri[0, 2] - Ri[2, 0]) / (4 * w),
                        (Ri[1, 0] - Ri[0, 1]) / (4 * w)]
        elif p == 1:
            x = q[idx][1]
            out[idx] = [(Ri[2, 1] - Ri[1, 2]) / (4 * x), x, (Ri[0, 1] + Ri[1, 0]) / (4 * x),
                        (Ri[0, 2] + Ri[2, 0]) / (4 * x)]
        elif p == 2:
            y = q[idx][2]
            out[idx] = [(Ri[0, 2] - Ri[2, 0]) / (4 * y), (Ri[0, 1] + Ri[1, 0]) / (4 * y), y,
                        (Ri[1, 2] + Ri[2, 1]) / (4 * y)]
        else:
            z = q[idx][3]
            out[idx] = [(Ri[1, 0] - Ri[0, 1]) / (4 * z), (Ri[0, 2] + Ri[2, 0]) / (4 * z),
                        (Ri[1, 2] + Ri[2, 1]) / (4 * z), z]
    out /= np.linalg.norm(out, axis=-1, keepdims=True)
    return out


def matrix_to_axis_angle_np(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotations -> (..., 3) axis-angle (Rodrigues vectors).

    Equivalent to cv2.Rodrigues applied batchwise (reference:
    code/utils/ceres_utils.py:25). Goes through the quaternion
    representation, which is uniformly accurate — including theta ~ pi,
    where the classic sin-based formula degrades (look-at cameras on a ring
    commonly have such rotations).
    """
    R = np.asarray(R, dtype=np.float64)
    q = _matrix_to_quaternion_np(R)
    q = np.where(q[..., :1] < 0, -q, q)  # hemisphere with w >= 0
    w = np.clip(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    norm = np.linalg.norm(xyz, axis=-1)
    theta = 2.0 * np.arctan2(norm, w)
    small = norm < 1e-12
    axis = xyz / np.where(small, 1.0, norm)[..., None]
    return axis * theta[..., None]


def compare_rotations_np(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    """Geodesic angle in degrees between rotation batches.

    Parity: reference code/utils/geo_utils.py:14-22.
    """
    cos_err = (R1 @ np.transpose(R2, (0, 2, 1)))[:, np.arange(3), np.arange(3)]
    cos_err = (cos_err.sum(axis=-1) - 1.0) / 2.0
    cos_err = np.clip(cos_err, -1.0, 1.0)
    return np.arccos(cos_err) * 180.0 / np.pi
