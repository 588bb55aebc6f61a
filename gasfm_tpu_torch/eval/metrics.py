"""On-device training metrics.

Counterpart of ``core_errors_device`` in the JAX package's eval/metrics.py
(:407-452).
"""

from __future__ import annotations

from typing import Dict

import torch


def core_errors_device(pred: Dict[str, torch.Tensor], scene) -> Dict[str, torch.Tensor]:
    """``our_repro``: the mean pixel reprojection error of the predicted
    cameras and points against the observed 2D points, as a 0-d tensor on
    the scene's device (no host synchronisation). Pixel cameras are
    ``Ns_inv @ Ps_norm``; observations are recovered from the normalized ones
    as pflat(Ns_inv [uv; 1]). Edges whose error is not finite or whose
    depth or homogeneous weight is 0 are left out (np.nanmean semantics of
    the reference's evaluation.py:8-74)."""
    g = scene.graph
    cam, pt = g.cam_idx.long(), g.pt_idx.long()
    Ps = torch.einsum("mij,mjk->mik", scene.Ns_inv, pred["Ps_norm"])  # (m, 3, 4)
    proj = torch.einsum("eij,ej->ei", Ps[cam], pred["pts3D"].T[pt])  # (E, 3)
    z = proj[:, 2]
    uv_proj = proj[:, :2] / torch.where(z == 0, torch.ones_like(z), z)[:, None]
    uv1 = torch.cat([g.uv, torch.ones_like(g.uv[:, :1])], dim=1)
    pixh = torch.einsum("eij,ej->ei", scene.Ns_inv[cam], uv1)
    w = pixh[:, 2]
    pix = pixh[:, :2] / torch.where(w == 0, torch.ones_like(w), w)[:, None]
    err = torch.sqrt(((uv_proj - pix) ** 2).sum(1))
    valid = torch.isfinite(err) & (z != 0) & (w != 0)
    count = valid.sum().clamp_min(1)
    return {"our_repro": torch.where(valid, err, torch.zeros_like(err)).sum() / count}
