"""On-device training metrics.

Counterpart of ``core_errors_device`` in the JAX package's eval/metrics.py
(:407-452), whose per-edge gathers of the camera and point rows reach the
TPU's gather kernels; here they go through the row-gather kernel
(``ops/kernels/segment_kernels.py``): three launches per call.
"""

from __future__ import annotations

from typing import Dict

import torch


def core_errors_device(pred: Dict[str, torch.Tensor], scene,
                       plain: bool = False) -> Dict[str, torch.Tensor]:
    """``our_repro``: the mean pixel reprojection error of the predicted
    cameras and points against the observed 2D points, as a 0-d tensor on
    the scene's device (no host synchronisation). Pixel cameras are
    ``Ns_inv @ Ps_norm``; observations are recovered from the normalized ones
    as pflat(Ns_inv [uv; 1]). Edges whose error is not finite or whose
    depth or homogeneous weight is 0 are left out (np.nanmean semantics of
    the reference's evaluation.py:8-74). ``plain=True`` gathers with the
    kernel's plain version whatever the device."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as k

    gather = k.gather_rows_plain if plain else k.gather_rows
    g = scene.graph
    m, E = g.num_cams, g.num_edges
    Ps = torch.einsum("mij,mjk->mik", scene.Ns_inv, pred["Ps_norm"])  # (m, 3, 4)
    P_e = gather(Ps.reshape(m, 12), g, "camera").reshape(E, 3, 4)
    X_e = gather(pred["pts3D"].T, g, "point")  # (E, 4)
    proj = torch.einsum("eij,ej->ei", P_e, X_e)  # (E, 3)
    z = proj[:, 2]
    uv_proj = proj[:, :2] / torch.where(z == 0, torch.ones_like(z), z)[:, None]
    uv1 = torch.cat([g.uv, torch.ones_like(g.uv[:, :1])], dim=1)
    N_e = gather(scene.Ns_inv.reshape(m, 9), g, "camera").reshape(E, 3, 3)
    pixh = torch.einsum("eij,ej->ei", N_e, uv1)
    w = pixh[:, 2]
    pix = pixh[:, :2] / torch.where(w == 0, torch.ones_like(w), w)[:, None]
    err = torch.sqrt(((uv_proj - pix) ** 2).sum(1))
    valid = torch.isfinite(err) & (z != 0) & (w != 0)
    count = valid.sum().clamp_min(1)
    return {"our_repro": torch.where(valid, err, torch.zeros_like(err)).sum() / count}
