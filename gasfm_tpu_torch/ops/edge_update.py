"""The 4-way gather-broadcast edge updates.

Counterpart of the JAX package's ops/edge_update.py (reference
``SetOfSetProjectionFeatureUpdate``, layers.py:129-147):
``out_e = (pe_e + ps[pt_e] + pv[cam_e] + pg) / 4``, through the edge-combine
kernel (``ops/kernels/fused_update.py``); and a GASFM layer's projection
update with its linear, skip and residual folded in (the JAX package's
``packed_edge_update``), through the projection-update kernel
(``ops/kernels/fused_proj_update.py``).
"""

from __future__ import annotations

import torch


def edge_combine(pe: torch.Tensor, ps: torch.Tensor, pv: torch.Tensor, pg: torch.Tensor,
                 graph, plain: bool = False) -> torch.Tensor:
    """pe (E, D) per-edge linear output, ps (n, D) point table, pv (m, D)
    camera table, pg (1, D) global row. ``plain=True`` runs the kernel's
    plain version whatever the device."""
    from gasfm_tpu_torch.ops.kernels import fused_update as k

    fn = k.fused_edge_combine_plain if plain else k.fused_edge_combine
    return fn(pe, ps, pv, pg, graph)


def projection_update(pending, graph, plain: bool = False) -> torch.Tensor:
    """Materialize a GASFM layer's projection update (a
    ``models.layers.PendingUpdate``): ``([en | skip2] w^T + b + ps[pt] +
    pv[cam] + pg) / 4 [+ res]``, (E, De). ``plain=True`` runs the kernel's
    plain version whatever the device."""
    from gasfm_tpu_torch.ops.kernels import fused_proj_update as k

    fn = k.projection_update_plain if plain else k.projection_update
    return fn(pending.en, pending.skip2, pending.res, pending.w, pending.b, pending.ps,
              pending.pv, pending.pg, graph)
