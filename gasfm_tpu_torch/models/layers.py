"""Model building blocks (torch.nn) over the port's view graph.

Counterpart of the JAX package's models/layers.py. Class names follow the
JAX package; module and parameter attribute names follow the reference
``state_dict`` (``equivariant_blocks.{i}.global_feature_update.proj2view...``,
as tests/torch_oracle.py reproduces it), so a port ``state_dict()`` maps onto
the flax tree with the JAX package's reference-checkpoint converter.

The edge-stream path is always the merged one of the JAX package's packed
layout: layer 0 runs the frontend kernel and defers its projection update;
every later layer materializes the previous update inside its layer-step
kernel (``PendingUpdate``), and the final aggregation does so on the raw
stream. Per-node work (query adapters, the aggregators' finish MLPs, the
global pools, the table linears, the heads) is plain PyTorch.

Node-level LayerNorms are torch's ``nn.LayerNorm`` (one fused kernel, a
two-pass variance); the JAX package's flax LayerNorm computes the same
function as E[x^2] - mean^2, so the two round differently (the model parity
test holds them to rtol 1e-3). The edge-stream LayerNorm inside the kernels
keeps the flax form of the JAX kernels.

Initialization: ``init_parameters`` draws every parameter from an explicit
``torch.Generator`` — torch ``nn.Linear`` bounds (uniform +-1/sqrt(fan_in))
for plain linears, Glorot with zero bias for the GATv2 linears and
attention vectors, ones/zeros for LayerNorms.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from gasfm_tpu_torch.ops.gatv2 import (
    gatv2_attend_pool,
    gatv2_layer_frontend,
    merged_layer_frontend,
)

LN_EPS = 1e-5  # the edge LayerNorm's epsilon (torch nn.LayerNorm's default)


class PendingUpdate(NamedTuple):
    """A layer's projection update, deferred to the next layer's layer-step
    kernel: ``e = ([en | skip2] w^T + b + ps[pt] + pv[cam] + pg) / 4 [+ res]``.

    ``w`` is (De, d_in + d2) in torch layout (columns for en, then skip2)."""

    en: torch.Tensor  # (E, d_in) normalized edge stream
    skip2: Optional[torch.Tensor]  # (E, d2) init-skip stream or None
    res: Optional[torch.Tensor]  # (E, De) residual stream or None
    w: torch.Tensor
    b: torch.Tensor  # (De,)
    ps: torch.Tensor  # (n, De) point-table linear output
    pv: torch.Tensor  # (m, De) camera-table linear output
    pg: torch.Tensor  # (1, De) global linear output


class TorchDense(nn.Linear):
    """Linear layer with torch's default initialization bounds."""


class MLPStack(nn.Sequential):
    """Reference ``get_linear_layers(feats, norm=False)``: linears at
    indices 0, 2, 4, ... with ReLUs between them."""

    def __init__(self, feats: Sequence[int]):
        assert len(feats) >= 2
        mods = []
        for i in range(len(feats) - 1):
            if i:
                mods.append(nn.ReLU())
            mods.append(TorchDense(feats[i], feats[i + 1]))
        super().__init__(*mods)


def positional_embed(x: torch.Tensor, n_freq: int) -> torch.Tensor:
    """NeRF-style frequency embedding, include-input, 2^k frequencies."""
    if n_freq <= 0:
        return x
    outs = [x]
    for k in range(n_freq):
        outs += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(outs, dim=-1)


def pos_embed_dim(in_dim: int, n_freq: int) -> int:
    return in_dim if n_freq <= 0 else in_dim * (1 + 2 * n_freq)


class EmbeddingLayer(nn.Module):
    """Reference ``EmbeddingLayer``: positional embedding + a linear."""

    def __init__(self, pos_emb_n_freq: int, in_dim: int, post_embed_proj_dim: Optional[int] = -1):
        super().__init__()
        self.pos_emb_n_freq = pos_emb_n_freq
        self.d_out = pos_embed_dim(in_dim, pos_emb_n_freq)
        self.post_embed_lin = None
        if post_embed_proj_dim is not None:
            d = self.d_out if post_embed_proj_dim == -1 else post_embed_proj_dim
            self.post_embed_lin = TorchDense(self.d_out, d)
            self.d_out = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = positional_embed(x, self.pos_emb_n_freq)
        return x if self.post_embed_lin is None else self.post_embed_lin(x)


def default_agg_width(in_feat: int, heads: int) -> int:
    """Aggregation width defaulting rule (reference layers.py:287-291)."""
    return in_feat + (-in_feat) % heads


class GATv2SegmentConv(nn.Module):
    """PyG GATv2Conv(add_self_loops=False) over star graphs: its source and
    query linears, attention vectors and output bias. The attention itself
    runs in ops/gatv2 (pools) or the kernels (edge aggregations)."""

    def __init__(self, in_feat: int, out_per_head: int, heads: int):
        super().__init__()
        self.heads = heads
        D = heads * out_per_head
        self.lin_l = nn.Linear(in_feat, D)
        self.lin_r = nn.Linear(in_feat, D)
        self.att = nn.Parameter(torch.empty(1, heads, out_per_head))
        self.bias = nn.Parameter(torch.zeros(D))

    def transform_dst(self, query: Optional[torch.Tensor], num_segments: int) -> torch.Tensor:
        """(S, H*C) query rows; the bias alone for a stateless aggregation."""
        if query is None:
            return self.lin_r.bias.expand(num_segments, -1)
        return self.lin_r(query)

    def pool(self, x_src: torch.Tensor, row_mask: torch.Tensor,
             query: Optional[torch.Tensor]) -> torch.Tensor:
        """Single-node attention pool over the masked rows: (1, H*C)."""
        out = gatv2_attend_pool(self.lin_l(x_src), self.transform_dst(query, 1),
                                self.att.reshape(-1), row_mask, self.heads)
        return out + self.bias


class QueryAdapter(nn.Sequential):
    """LN + ReLU (+ Linear if widths differ): the stateful-attention query
    path (reference ``norm_and_proj_*`` Sequentials)."""

    def __init__(self, d_state: int, d_target: int):
        mods = [nn.LayerNorm(d_state), nn.ReLU()]
        if d_target != d_state:
            mods.append(TorchDense(d_state, d_target))
        super().__init__(*mods)


class AxialAttentionAggregator(nn.Module):
    """Edge -> node attention aggregation with residual MLP head: reference
    ``Proj2View`` (``target="view"``) / ``Proj2ScenePoint``
    (``target="scenepoint"``), whose attribute names it keeps."""

    def __init__(self, in_feat: int, out_feat: int, n_heads: int, target: str,
                 stateful: bool = True, agg_feat: Optional[int] = None,
                 n_hidden_layers: int = 0):
        super().__init__()
        agg = agg_feat or default_agg_width(in_feat, n_heads)
        assert agg % n_heads == 0
        self.stateful = stateful
        self._adapter = f"norm_and_proj_{target}2proj"
        self._proj = f"proj_proj2{target}"
        if stateful:
            self.add_module(self._adapter, QueryAdapter(out_feat, in_feat))
        self.graph_conv = GATv2SegmentConv(in_feat, agg // n_heads, n_heads)
        if agg != out_feat:
            self.add_module(self._proj, TorchDense(agg, out_feat))
        self.norm_pre_mlp = nn.LayerNorm(out_feat)
        self.mlp = MLPStack([out_feat] * (2 + n_hidden_layers))

    def query_transform(self, prev: Optional[torch.Tensor], num_segments: int) -> torch.Tensor:
        query = getattr(self, self._adapter)(prev) if self.stateful else None
        return self.graph_conv.transform_dst(query, num_segments)

    def finish(self, aggregated: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
        """Everything after the aggregation: bias, width adapter, residual,
        LN + ReLU + MLP with a second residual (reference layers.py:344-357)."""
        x = aggregated + self.graph_conv.bias
        if hasattr(self, self._proj):
            x = getattr(self, self._proj)(x)
        if prev is not None:
            x = prev + x
        return x + self.mlp(torch.relu(self.norm_pre_mlp(x)))


class ViewAndScenePoint2Global(nn.Module):
    """Two single-node attention pools (valid views -> global, valid points
    -> global) concatenated, then the residual MLP head. Reference
    layers.py:460-603."""

    def __init__(self, n_feat_scenepoint_in: int, n_feat_view_in: int, n_feat_global_out: int,
                 n_heads: int, stateful: bool = True,
                 n_feat_scenepoint2global_agg: Optional[int] = None,
                 n_feat_view2global_agg: Optional[int] = None, n_hidden_layers: int = 0):
        super().__init__()
        self.stateful = stateful
        s2g = n_feat_scenepoint2global_agg or default_agg_width(n_feat_scenepoint_in, n_heads)
        v2g = n_feat_view2global_agg or default_agg_width(n_feat_view_in, n_heads)
        if stateful:
            self.norm_and_proj_global2view = QueryAdapter(n_feat_global_out, n_feat_view_in)
        self.graph_conv_view2global = GATv2SegmentConv(n_feat_view_in, v2g // n_heads, n_heads)
        if stateful:
            self.norm_and_proj_global2scenepoint = QueryAdapter(
                n_feat_global_out, n_feat_scenepoint_in)
        self.graph_conv_scenepoint2global = GATv2SegmentConv(
            n_feat_scenepoint_in, s2g // n_heads, n_heads)
        self.proj_view_and_scenepoint2global = (
            TorchDense(v2g + s2g, n_feat_global_out) if v2g + s2g != n_feat_global_out else None
        )
        self.norm_pre_mlp = nn.LayerNorm(n_feat_global_out)
        self.mlp = MLPStack([n_feat_global_out] * (2 + n_hidden_layers))

    def forward(self, view_features, scenepoint_features, cam_valid, pt_valid, prev_global=None):
        assert self.stateful == (prev_global is not None)
        q_view = q_pt = None
        if self.stateful:
            q_view = self.norm_and_proj_global2view(prev_global)
            q_pt = self.norm_and_proj_global2scenepoint(prev_global)
        x = torch.cat([
            self.graph_conv_view2global.pool(view_features, cam_valid, q_view),
            self.graph_conv_scenepoint2global.pool(scenepoint_features, pt_valid, q_pt),
        ], dim=1)
        if self.proj_view_and_scenepoint2global is not None:
            x = self.proj_view_and_scenepoint2global(x)
        if prev_global is not None:
            x = prev_global + x
        return x + self.mlp(torch.relu(self.norm_pre_mlp(x)))


class GlobalBroadcastUpdate(nn.Module):
    """Global -> per-view / per-point residual broadcast update: reference
    ``Global2View`` (``target="view"``) / ``Global2ScenePoint``."""

    def __init__(self, n_feat_global_in: int, n_feat_in_out: int, target: str,
                 n_hidden_layers: int = 0):
        super().__init__()
        self._norm = f"{target}_norm_layer"
        self._lin = f"lin_{target}"
        self.add_module(self._norm, nn.LayerNorm(n_feat_in_out))
        self.global_norm_layer = nn.LayerNorm(n_feat_global_in)
        self.add_module(self._lin, TorchDense(n_feat_in_out, n_feat_in_out))
        self.lin_global = TorchDense(n_feat_global_in, n_feat_in_out, bias=False)
        self.mlp = (MLPStack([n_feat_in_out] * (n_hidden_layers + 1))
                    if n_hidden_layers > 0 else None)

    def forward(self, global_features: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        x = getattr(self, self._lin)(torch.relu(getattr(self, self._norm)(prev)))
        x = x + self.lin_global(torch.relu(self.global_norm_layer(global_features)))
        if self.mlp is not None:
            x = self.mlp(torch.relu(x))
        return prev + x


class GraphAttnGlobalFeatureUpdate(nn.Module):
    """The two edge aggregators (one frontend or layer-step kernel call),
    the global pools and the optional global broadcasts. Reference
    ``GraphAttnSfMGlobalFeatureUpdate`` (layers.py:723-870)."""

    def __init__(self, n_feat_proj_in: int, n_feat_scenepoint_out: int, n_feat_view_out: int,
                 n_feat_global_out: Optional[int] = None,
                 n_feat_proj2scenepoint_agg: Optional[int] = None,
                 n_feat_proj2view_agg: Optional[int] = None,
                 n_feat_scenepoint2global_agg: Optional[int] = None,
                 n_feat_view2global_agg: Optional[int] = None,
                 output_global: bool = True, n_heads: int = 1, stateful: bool = True,
                 global2view_and_global2scenepoint_enabled: bool = True,
                 n_hidden_layers_scenepoint_update: int = 0,
                 n_hidden_layers_view_update: int = 0,
                 n_hidden_layers_global_update: int = 0):
        super().__init__()
        self.n_heads = n_heads
        self.output_global = output_global
        self.g2vs = global2view_and_global2scenepoint_enabled
        self.proj2view = AxialAttentionAggregator(
            n_feat_proj_in, n_feat_view_out, n_heads, "view", stateful,
            n_feat_proj2view_agg, n_hidden_layers_view_update)
        self.proj2scenepoint = AxialAttentionAggregator(
            n_feat_proj_in, n_feat_scenepoint_out, n_heads, "scenepoint", stateful,
            n_feat_proj2scenepoint_agg, n_hidden_layers_scenepoint_update)
        self.view_and_scenepoint2global = None
        if output_global or self.g2vs:
            self.view_and_scenepoint2global = ViewAndScenePoint2Global(
                n_feat_scenepoint_out, n_feat_view_out, n_feat_global_out, n_heads, stateful,
                n_feat_scenepoint2global_agg, n_feat_view2global_agg,
                n_hidden_layers_global_update)
        if self.g2vs:
            self.global2view = GlobalBroadcastUpdate(
                n_feat_global_out, n_feat_view_out, "view", n_hidden_layers_view_update)
            self.global2scenepoint = GlobalBroadcastUpdate(
                n_feat_global_out, n_feat_scenepoint_out, "scenepoint",
                n_hidden_layers_scenepoint_update)

    def forward(self, x_edges, graph, prev_scenepoint_features=None, prev_view_features=None,
                prev_global_features=None, ln=None, plain=False):
        """``x_edges``: the raw (E, De) stream, or the previous layer's
        :class:`PendingUpdate`. ``ln``: this layer's (scale, bias) edge
        LayerNorm, or None for the final aggregation on the raw stream.
        Returns (s, v, g, e_norm, e_prev): e_prev is the materialized
        previous update when ``x_edges`` was pending, else None."""
        agg_p, agg_c = self.proj2scenepoint, self.proj2view
        conv_p, conv_c = agg_p.graph_conv, agg_c.graph_conv
        ln_scale, ln_bias = ln if ln is not None else (None, None)
        args = (
            ln_scale, ln_bias, LN_EPS,
            conv_p.lin_l.weight, conv_p.lin_l.bias, conv_c.lin_l.weight, conv_c.lin_l.bias,
            agg_p.query_transform(prev_scenepoint_features, graph.num_pts),
            agg_c.query_transform(prev_view_features, graph.num_cams),
            conv_p.att.reshape(-1), conv_c.att.reshape(-1), graph, self.n_heads,
        )
        e_prev = None
        if isinstance(x_edges, PendingUpdate):
            e_prev, en, out_p, out_c = merged_layer_frontend(
                x_edges, *args, raw_prologue=ln is None, plain=plain)
        else:
            en, out_p, out_c = gatv2_layer_frontend(
                x_edges, *args, raw_prologue=ln is None, plain=plain)
        s = agg_p.finish(out_p, prev_scenepoint_features)
        v = agg_c.finish(out_c, prev_view_features)
        g = None
        if self.view_and_scenepoint2global is not None:
            g = self.view_and_scenepoint2global(
                v, s, graph.cam_valid, graph.pt_valid, prev_global_features)
        if self.g2vs:
            s = self.global2scenepoint(g, s)
            v = self.global2view(g, v)
        return s, v, g, en, e_prev


class ProjectionFeatureUpdate(nn.Module):
    """The gather-broadcast edge update's parameters,
    ``(lin_proj(e) + lin_s(s)[pt] + lin_v(v)[cam] + lin_g(g)) / 4``; the
    per-edge part runs deferred in the next layer-step kernel. Reference
    ``GraphAttnSfMProjectionFeatureUpdate`` (layers.py:873-956)."""

    def __init__(self, n_feat_proj_in: int, n_feat_scenepoint_in: int, n_feat_view_in: int,
                 n_feat_global_in: int, n_feat_proj_out: int):
        super().__init__()
        self.scenepoint_norm_layer = nn.LayerNorm(n_feat_scenepoint_in)
        self.view_norm_layer = nn.LayerNorm(n_feat_view_in)
        self.global_norm_layer = nn.LayerNorm(n_feat_global_in)
        self.lin_proj = TorchDense(n_feat_proj_in, n_feat_proj_out)
        self.lin_scenepoint = TorchDense(n_feat_scenepoint_in, n_feat_proj_out, bias=False)
        self.lin_view = TorchDense(n_feat_view_in, n_feat_proj_out, bias=False)
        self.lin_global = TorchDense(n_feat_global_in, n_feat_proj_out, bias=False)

    def tables(self, s, v, g):
        """(ps (n, De), pv (m, De), pg (1, De)): the table linears."""
        return (self.lin_scenepoint(torch.relu(self.scenepoint_norm_layer(s))),
                self.lin_view(torch.relu(self.view_norm_layer(v))),
                self.lin_global(torch.relu(self.global_norm_layer(g))))


class ProjLayer(nn.Module):
    """Reference ``ProjLayer`` (a named linear)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.lin_proj = TorchDense(d_in, d_out)


class GraphAttnLayer(nn.Module):
    """One GASFM message-passing round. Reference ``GraphAttnSfMLayer``
    (layers.py:150-263): LN + ReLU on the edge stream -> global feature
    update -> optional init-embedding concat -> edge update -> residual
    (through a projected skip when the widths differ).

    ``forward`` returns this layer's update deferred (:class:`PendingUpdate`)
    with the new node features; the next layer step materializes it. When
    the widths differ (the first layer), the width-adapting residual rides
    the update's skip2 slot: skip2 = relu(LN_res(raw)) with weight columns
    4 * W_skip and bias + 4 * b_skip, which the update's /4 cancels — the
    JAX package's first-layer deferral (models/layers.py:954-994)."""

    def __init__(self, n_feat_proj_in: int, n_feat_proj_out: int, n_feat_scenepoint_hidden: int,
                 n_feat_view_hidden: int, n_feat_global_hidden: int,
                 n_feat_proj2scenepoint_agg: Optional[int] = None,
                 n_feat_proj2view_agg: Optional[int] = None,
                 n_feat_scenepoint2global_agg: Optional[int] = None,
                 n_feat_view2global_agg: Optional[int] = None,
                 add_residual_skipconn_proj_update: bool = True,
                 n_feat_skipconn_init_projfeat_in: Optional[int] = None,
                 n_heads: int = 1, stateful: bool = True,
                 global2view_and_global2scenepoint_enabled: bool = True,
                 n_hidden_layers_scenepoint_update: int = 0,
                 n_hidden_layers_view_update: int = 0,
                 n_hidden_layers_global_update: int = 0):
        super().__init__()
        self.add_residual = add_residual_skipconn_proj_update
        self.n_skip_in = n_feat_skipconn_init_projfeat_in or 0
        self.prev_projfeat_norm_layer = nn.LayerNorm(n_feat_proj_in)
        self.global_feature_update = GraphAttnGlobalFeatureUpdate(
            n_feat_proj_in, n_feat_scenepoint_hidden, n_feat_view_hidden,
            n_feat_global_out=n_feat_global_hidden,
            n_feat_proj2scenepoint_agg=n_feat_proj2scenepoint_agg,
            n_feat_proj2view_agg=n_feat_proj2view_agg,
            n_feat_scenepoint2global_agg=n_feat_scenepoint2global_agg,
            n_feat_view2global_agg=n_feat_view2global_agg,
            output_global=True, n_heads=n_heads, stateful=stateful,
            global2view_and_global2scenepoint_enabled=global2view_and_global2scenepoint_enabled,
            n_hidden_layers_scenepoint_update=n_hidden_layers_scenepoint_update,
            n_hidden_layers_view_update=n_hidden_layers_view_update,
            n_hidden_layers_global_update=n_hidden_layers_global_update)
        self.projection_feature_update = ProjectionFeatureUpdate(
            n_feat_proj_in + self.n_skip_in, n_feat_scenepoint_hidden, n_feat_view_hidden,
            n_feat_global_hidden, n_feat_proj_out)
        self.skip_projection = None
        if add_residual_skipconn_proj_update and n_feat_proj_in != n_feat_proj_out:
            if self.n_skip_in:
                raise NotImplementedError("a width-changing layer with an init skip")
            self.residual_skipconn_proj_norm_layer = nn.LayerNorm(n_feat_proj_in)
            self.skip_projection = ProjLayer(n_feat_proj_in, n_feat_proj_out)

    def forward(self, x_edges, graph, prev_scenepoint_features=None, prev_view_features=None,
                prev_global_features=None, skipconn_init_projfeat=None, plain=False):
        norm = self.prev_projfeat_norm_layer
        s, v, g, en, e_prev = self.global_feature_update(
            x_edges, graph, prev_scenepoint_features, prev_view_features,
            prev_global_features, ln=(norm.weight, norm.bias), plain=plain)
        raw = x_edges if e_prev is None else e_prev  # this layer's input stream
        update = self.projection_feature_update
        ps, pv, pg = update.tables(s, v, g)
        w, b = update.lin_proj.weight, update.lin_proj.bias
        skip2 = skipconn_init_projfeat if self.n_skip_in else None
        res = None
        if self.skip_projection is not None:
            lin = self.skip_projection.lin_proj
            skip2 = torch.relu(self.residual_skipconn_proj_norm_layer(raw))
            w = torch.cat([w, 4.0 * lin.weight], dim=1)
            b = b + 4.0 * lin.bias
        elif self.add_residual:
            res = raw
        return PendingUpdate(en, skip2, res, w, b, ps, pv, pg), s, v, g


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """(Re)draw every parameter of ``module`` from ``generator``."""

    def uniform_(t: torch.Tensor, bound: float) -> None:
        with torch.no_grad():
            r = torch.rand(t.shape, generator=generator, dtype=torch.float32)
            t.copy_((r * 2.0 - 1.0) * bound)

    def glorot_(t: torch.Tensor) -> None:
        fan_out, fan_in = t.shape[0], t.shape[1]
        receptive = t[0][0].numel()
        uniform_(t, math.sqrt(6.0 / ((fan_in + fan_out) * receptive)))

    gat_linears = set()
    for mod in module.modules():
        if isinstance(mod, GATv2SegmentConv):
            for lin in (mod.lin_l, mod.lin_r):
                glorot_(lin.weight)
                nn.init.zeros_(lin.bias)
                gat_linears.add(lin)
            glorot_(mod.att)
            nn.init.zeros_(mod.bias)
    for mod in module.modules():
        if isinstance(mod, nn.Linear) and mod not in gat_linears:
            bound = 1.0 / math.sqrt(mod.in_features)
            uniform_(mod.weight, bound)
            if mod.bias is not None:
                uniform_(mod.bias, bound)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
