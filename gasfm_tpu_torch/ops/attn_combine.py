"""The segment softmax's combine over the shards of an edge mesh.

Counterpart of the JAX package's ``combine_attention_shards``
(``gasfm_tpu/ops/pallas/fused_attn.py:221``), which is plain XLA outside
Pallas; here it is plain PyTorch outside the CUDA kernels. Each rank's
attention kernel gives, over its own edges, each segment's output ``out``
(S, H*C), its per-head softmax max ``m`` and denominator ``den`` (S, H). A
segment with no edge on the rank has ``den == 0``; its max is taken as
-inf, the neutral of the max (the unvisited-window mask of
``fused_attn.py:245-250``). Then, over the edge group:

    m_g   = max(m)
    w     = den * exp(m - m_g)          (0 where den == 0)
    den_g = sum(w)
    out_g = sum(out * w) / den_g        (0 where den_g == 0)

``out * den`` recovers the unnormalized sum, so the kernels are unchanged
(no no-finalize flag). The max and the two sums of every direction given go
into one all-reduce MAX and one all-reduce SUM. The combine carries no
gradient: the kernels' backward takes the global ``(out_g, m_g, den_g)``
and the output's cotangent summed over the group (:func:`sum_cotangents`),
and gives the rank's exact share of each input's gradient.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from gasfm_tpu_torch.ops.segment import flat_collective


def combine_attention_shards(parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                             group) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``parts``: per direction this rank's (out (S, D), m (S, H), den (S,
    H)). Returns per direction the scene's (out_g, m_g, den_g): m_g 0 where
    no rank has an edge of the segment."""
    import torch.distributed as dist

    ms = [torch.where(den > 0, m, torch.full_like(m, float("-inf"))) for _, m, den in parts]
    m_gs = [torch.where(torch.isfinite(m_g), m_g, torch.zeros_like(m_g))
            for m_g in flat_collective(ms, group, dist.ReduceOp.MAX)]
    payload = []
    for (out, _, den), m, m_g in zip(parts, ms, m_gs):
        S, H = den.shape
        w = torch.where(den > 0, den * torch.exp(m - m_g), torch.zeros_like(den))
        num = torch.where(w[:, :, None] > 0, out.reshape(S, H, -1) * w[:, :, None],
                          torch.zeros((), dtype=out.dtype, device=out.device))
        payload += [w, num]
    sums = flat_collective(payload, group)
    combined = []
    for (out, _, _), m_g, den_g, num_g in zip(parts, m_gs, sums[0::2], sums[1::2]):
        out_g = torch.where(den_g[:, :, None] > 0, num_g / den_g.clamp_min(1e-38)[:, :, None],
                            torch.zeros_like(num_g)).reshape(out.shape)
        combined.append((out_g.contiguous(), m_g.contiguous(), den_g.contiguous()))
    return combined


def sum_cotangents(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The outputs' cotangents, each rank's partial, summed over the edge
    group in one all-reduce (the JAX kernels' ``psum`` of ``gp`` / ``gc`` at
    their backward's entry)."""
    return flat_collective(grads, group)
