"""The 4-way gather-broadcast edge update of the set-of-sets layers.

Counterpart of the JAX package's ops/edge_update.py (reference
``SetOfSetProjectionFeatureUpdate``, layers.py:129-147):
``out_e = (pe_e + ps[pt_e] + pv[cam_e] + pg) / 4``, through the edge-combine
kernel (``ops/kernels/fused_update.py``).
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
