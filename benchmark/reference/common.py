"""Plain building blocks shared by the reference models."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

NEGATIVE_SLOPE = 0.2


def segment_sum(x: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    out = x.new_zeros((num,) + tuple(x.shape[1:]))
    return out.index_add(0, ids, x)


def segment_mean(x: torch.Tensor, ids: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Mean per segment; an empty segment gives 0."""
    return segment_sum(x, ids, count.shape[0]) / count.clamp_min(1.0)[:, None]


def leaky_relu(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, NEGATIVE_SLOPE * z)


def segment_attention(xl: torch.Tensor, xr: torch.Tensor, att: torch.Tensor, ids: torch.Tensor,
                      num: int, heads: int) -> torch.Tensor:
    """GATv2 aggregation of the source rows ``xl`` (E, H*C) into ``num``
    segments with queries ``xr`` (num, H*C): per head ``softmax_seg(att .
    LeakyReLU(xl + xr[seg])) @ xl``; an empty segment gives 0. The softmax's
    shift is the detached per-segment max, which carries no gradient."""
    E, D = xl.shape
    C = D // heads
    logits = (leaky_relu(xl + xr[ids]) * att).reshape(E, heads, C).sum(-1)
    shift = torch.full((num, heads), float("-inf"), dtype=logits.dtype, device=logits.device)
    shift = shift.scatter_reduce(0, ids[:, None].expand(E, heads), logits.detach(), "amax")
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    p = torch.exp(logits - shift[ids])
    num_rows = segment_sum((p[:, :, None] * xl.reshape(E, heads, C)).reshape(E, D), ids, num)
    den = segment_sum(p, ids, num)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (num_rows.reshape(num, heads, C) / den[:, :, None]).reshape(num, D)


def attention_pool(xl: torch.Tensor, xr: torch.Tensor, att: torch.Tensor, mask: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """All rows where ``mask`` holds attend into one node: (1, H*C)."""
    ids = torch.zeros(xl.shape[0], dtype=torch.int64, device=xl.device)
    keep = mask.nonzero()[:, 0]
    return segment_attention(xl[keep], xr.reshape(1, -1), att, ids[keep], 1, heads)


class MLP(nn.Sequential):
    """Linears at indices 0, 2, 4, ... with ReLUs between them."""

    def __init__(self, feats: Sequence[int]):
        mods = []
        for i in range(len(feats) - 1):
            if i:
                mods.append(nn.ReLU())
            mods.append(nn.Linear(feats[i], feats[i + 1]))
        super().__init__(*mods)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(m, 4) real-first quaternions (not normalized) -> (m, 3, 3)."""
    r, i, j, k = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1)
    rows = [1 - s * (j * j + k * k), s * (i * j - k * r), s * (i * k + j * r),
            s * (i * j + k * r), 1 - s * (i * i + k * k), s * (j * k - i * r),
            s * (i * k - j * r), s * (j * k + i * r), 1 - s * (i * i + j * j)]
    return torch.stack(rows, -1).reshape(-1, 3, 3)


def decode_heads(view_out: torch.Tensor, point_out: torch.Tensor) -> dict:
    """Calibrated quaternion cameras (m, 3, 4) and homogeneous points (4, n)."""
    Ps = torch.cat([quaternion_to_matrix(view_out[:, :4]), view_out[:, -3:, None]], dim=-1)
    pts = torch.cat([point_out.T, torch.ones_like(point_out.T[:1])], dim=0)
    return {"Ps_norm": Ps, "pts3D": pts}
