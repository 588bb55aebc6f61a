"""Model building blocks (torch.nn) over the port's view graph.

Counterpart of the JAX package's models/layers.py. Class names follow the
JAX package; module and parameter attribute names follow the reference
``state_dict`` (``equivariant_blocks.{i}.global_feature_update.proj2view...``,
as tests/torch_oracle.py reproduces it), so a port ``state_dict()`` maps onto
the flax tree with the JAX package's reference-checkpoint converter.

The edge stream takes one of the JAX package's two GASFM paths, as the
model chooses per scene (``models/gasfm.py``):

- merged (its packed layout): layer 0 runs the frontend kernel and defers
  its projection update; every later layer materializes the previous update
  inside its layer-step kernel (``PendingUpdate``), and the final
  aggregation does so on the raw stream; a merged layer whose successor is
  not merged (with the depth head, layer L-2) materializes its own update
  through the projection-update kernel;
- unfused (its composite layer, ``gasfm_tpu/models/layers.py:919-929,
  996-1017``): the edge prologue (flax-form LayerNorm + ReLU, or ReLU alone
  without ``use_norm_proj_update``), the source linears and both
  aggregations (``ops/gatv2.py``, gated on the scene's camera count), then
  the materialized update ``lin_proj([e | skip])`` + the edge-combine kernel
  (+ the projection-update MLP), then the residual.

Per-node work (query adapters, the aggregators' finish MLPs, the global
pools, the table linears, the heads) is plain PyTorch.

The DPESFM (set-of-sets) blocks at the end of the module take their point
and camera means through the segment-sum kernel (``ops/segment.py``
``segment_mean``) and combine the edge stream through the edge-combine
kernel (``ops/edge_update.py``); their linears are plain ``nn.Linear``.

Under an edge mesh (``ops/segment.py`` ``edge_partitioned``) every
reduction over edges is the scene's through the ops (the segment means,
the aggregations) and :func:`~gasfm_tpu_torch.ops.segment.edge_mean` (the
DPESFM global mean and mean-centering, the JAX package's ``masked_mean``).
The view->global and point->global pools reduce the tables, which every
rank holds whole, with no collective (the JAX package's ``edge_replicated``,
``gasfm_tpu/models/layers.py:427-448``). Under table sharding
(``ops/segment.py`` ``table_sharded``) the point->global pool takes the
rank's owned point rows and combines its softmax over the edge group
(``ops/gatv2.py`` ``gatv2_attend_pool_sharded``; the JAX package's
``layers.py:244-253, 440-446``); the view pool stays local.

Node-level LayerNorms are torch's ``nn.LayerNorm`` (one fused kernel, a
two-pass variance); the JAX package's flax LayerNorm computes the same
function as E[x^2] - mean^2, so the two round differently (the model parity
test holds them to rtol 1e-3). The edge-stream LayerNorm inside the kernels
keeps the flax form of the JAX kernels.

Weights in bf16 (``train.param_dtype = bf16``, the JAX package's bf16
parameter storage with an f32 master in the optimizer) take the JAX
package's three paths, use by use:

- ``TorchDense`` (the flax ``TorchDense``) is a bf16 dot with f32
  accumulation (``gasfm_tpu/models/layers.py:72-81``): ``x`` rounded to
  bf16, an f32 product, ``+ bias`` in f32 (:class:`_Bf16Dense`);
- every other use upcasts the weight to f32 under autograd (:func:`f32`),
  as JAX promotes a bf16 operand beside an f32 one and as it upcasts the
  weight-side operands of its Pallas kernels (``ops/gatv2.py`` ``_opf32``):
  the GATv2 source and query linears (:class:`Linear32`) and attention
  vectors, the LayerNorms (:class:`LayerNorm`, as flax promotes its scale
  and bias), the edge LayerNorm and the projection update's weights handed
  to the kernels, the aggregators' output bias. The kernels stay float32;
  the upcast's backward rounds each use's f32 gradient to bf16, as JAX's
  convert transposes.

Initialization: ``init_parameters`` draws every parameter from an explicit
``torch.Generator`` — torch ``nn.Linear`` bounds (uniform +-1/sqrt(fan_in))
for plain linears, Glorot with zero bias for the GATv2 linears and
attention vectors, ones/zeros for LayerNorms.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gasfm_tpu_torch.ops.edge_update import edge_combine, projection_update
from gasfm_tpu_torch.ops.gatv2 import (
    gatv2_attend_dual,
    gatv2_attend_pool,
    gatv2_attend_pool_sharded,
    gatv2_layer_frontend,
    merged_layer_frontend,
)
from gasfm_tpu_torch.ops.kernels.build import upcast
from gasfm_tpu_torch.ops.segment import edge_mean, segment_mean, table_shard

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


f32 = upcast  # a bf16 weight upcast to float32 (its gradient comes back rounded)


def to_stream(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """An edge stream stored in ``dtype``: rounded to bf16 (to nearest even)
    under bf16 streams; as it is under float32 streams (also a float64
    reference run's)."""
    return t.to(dtype) if t is not None and dtype == torch.bfloat16 else t


class _Bf16Dense(torch.autograd.Function):
    """``jax.lax.dot_general(x.astype(bf16), W_bf16, preferred_element_type=
    f32) + b`` and its transpose: forward ``x`` rounded to bf16, products
    accumulated in f32, an f32 output, then ``+ b`` in f32; backward ``dx``
    in f32 rounded to bf16 (the convert's transpose takes it back to f32),
    ``dW`` and ``db`` in f32 rounded to bf16. On the card the product is
    cuBLAS's bf16 GEMM with an f32 output; on the CPU (where torch has no
    such GEMM) the f32 product of the bf16 values, which are exact in f32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xb = x.to(torch.bfloat16)
        x2 = xb.reshape(-1, xb.shape[-1])
        if x2.is_cuda:
            y = torch.mm(x2, weight.t(), out_dtype=torch.float32)
        else:
            y = x2.float() @ weight.float().t()
        y = y.reshape(*x.shape[:-1], weight.shape[0])
        if bias is not None:
            y = y + bias.float()
        ctx.save_for_backward(xb, weight)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, g):
        xb, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ weight.float()).to(torch.bfloat16).float().reshape(xb.shape)
        dw = (g2.t() @ xb.reshape(-1, xb.shape[-1]).float()).to(torch.bfloat16)
        db = g2.sum(0).to(torch.bfloat16) if ctx.has_bias else None
        return dx, dw, db


class TorchDense(nn.Linear):
    """Linear layer with torch's default initialization bounds; with bf16
    weights the JAX ``TorchDense``'s bf16 dot (:class:`_Bf16Dense`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == torch.bfloat16:
            return _Bf16Dense.apply(x, self.weight, self.bias)
        return super().forward(x)


class Linear32(nn.Linear):
    """A linear whose bf16 weights are upcast to f32 for an f32 product (the
    JAX package's GATv2 linears, ``x @ kernel + bias`` with promotion)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, f32(self.weight), f32(self.bias))


class LayerNorm(nn.LayerNorm):
    """torch's LayerNorm with bf16 scale and bias upcast to f32, as flax
    promotes them beside an f32 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, f32(self.weight), f32(self.bias),
                            self.eps)


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
        self.lin_l = Linear32(in_feat, D)
        self.lin_r = Linear32(in_feat, D)
        self.att = nn.Parameter(torch.empty(1, heads, out_per_head))
        self.bias = nn.Parameter(torch.zeros(D))

    def transform_dst(self, query: Optional[torch.Tensor], num_segments: int) -> torch.Tensor:
        """(S, H*C) query rows; the bias alone for a stateless aggregation."""
        if query is None:
            return f32(self.lin_r.bias).expand(num_segments, -1)
        return self.lin_r(query)

    def pool(self, x_src: torch.Tensor, row_mask: torch.Tensor,
             query: Optional[torch.Tensor], sharded: bool = False) -> torch.Tensor:
        """Single-node attention pool over the masked rows: (1, H*C). With
        ``sharded``, the rows are this rank's share of a table sharded over
        the edge group, the pool the whole table's."""
        fn = gatv2_attend_pool_sharded if sharded else gatv2_attend_pool
        out = fn(self.lin_l(x_src), self.transform_dst(query, 1), f32(self.att).reshape(-1),
                 row_mask, self.heads)
        return out + f32(self.bias)


class QueryAdapter(nn.Sequential):
    """LN + ReLU (+ Linear if widths differ): the stateful-attention query
    path (reference ``norm_and_proj_*`` Sequentials)."""

    def __init__(self, d_state: int, d_target: int):
        mods = [LayerNorm(d_state), nn.ReLU()]
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
        self.norm_pre_mlp = LayerNorm(out_feat)
        self.mlp = MLPStack([out_feat] * (2 + n_hidden_layers))

    def query_transform(self, prev: Optional[torch.Tensor], num_segments: int) -> torch.Tensor:
        query = getattr(self, self._adapter)(prev) if self.stateful else None
        return self.graph_conv.transform_dst(query, num_segments)

    def finish(self, aggregated: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
        """Everything after the aggregation: bias, width adapter, residual,
        LN + ReLU + MLP with a second residual (reference layers.py:344-357)."""
        x = aggregated + f32(self.graph_conv.bias)
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
        self.norm_pre_mlp = LayerNorm(n_feat_global_out)
        self.mlp = MLPStack([n_feat_global_out] * (2 + n_hidden_layers))

    def forward(self, view_features, scenepoint_features, cam_valid, pt_valid, prev_global=None):
        assert self.stateful == (prev_global is not None)
        q_view = q_pt = None
        if self.stateful:
            q_view = self.norm_and_proj_global2view(prev_global)
            q_pt = self.norm_and_proj_global2scenepoint(prev_global)
        shard = table_shard()
        if shard is None:
            pt_pooled = self.graph_conv_scenepoint2global.pool(scenepoint_features, pt_valid, q_pt)
        else:  # the rank's owned points
            own = slice(shard.own_lo, shard.own_hi)
            pt_pooled = self.graph_conv_scenepoint2global.pool(
                scenepoint_features[own], pt_valid[own], q_pt, sharded=True)
        x = torch.cat([self.graph_conv_view2global.pool(view_features, cam_valid, q_view),
                       pt_pooled], dim=1)
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
        self.add_module(self._norm, LayerNorm(n_feat_in_out))
        self.global_norm_layer = LayerNorm(n_feat_global_in)
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
    """The two edge aggregators (a frontend or layer-step kernel call, or
    the source linears and ``gatv2_attend_dual``), the global pools and the
    optional global broadcasts. Reference
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
                prev_global_features=None, ln=None, plain=False, en_dtype=None):
        """``x_edges``: the raw (E, De) stream, or the previous layer's
        :class:`PendingUpdate`. ``ln``: this layer's (scale, bias) edge
        LayerNorm, or None for an aggregation of the stream as it is (the
        final aggregation; an unfused layer without ``use_norm_proj_update``,
        whose ReLU the caller applied). ``en_dtype``: e_norm's stored dtype
        on a raw stream (the frontend kernel's). Returns (s, v, g, e_norm,
        e_prev): e_prev is the materialized previous update when ``x_edges``
        was pending, else None; e_norm is ``x_edges`` itself without ``ln``.
        A pending update's streams and outputs keep their dtype."""
        agg_p, agg_c = self.proj2scenepoint, self.proj2view
        conv_p, conv_c = agg_p.graph_conv, agg_c.graph_conv
        ln_scale, ln_bias = ln if ln is not None else (None, None)
        args = (
            f32(ln_scale), f32(ln_bias), LN_EPS,
            f32(conv_p.lin_l.weight), f32(conv_p.lin_l.bias),
            f32(conv_c.lin_l.weight), f32(conv_c.lin_l.bias),
            agg_p.query_transform(prev_scenepoint_features, graph.num_pts),
            agg_c.query_transform(prev_view_features, graph.num_cams),
            f32(conv_p.att).reshape(-1), f32(conv_c.att).reshape(-1), graph, self.n_heads,
        )
        e_prev = None
        if isinstance(x_edges, PendingUpdate):
            e_prev, en, out_p, out_c = merged_layer_frontend(
                x_edges, *args, raw_prologue=ln is None, plain=plain)
        elif ln is not None:
            en, out_p, out_c = gatv2_layer_frontend(x_edges, *args, plain=plain,
                                                    en_dtype=en_dtype)
        else:  # the JAX package's prepare + gatv2_attend_dual
            en = x_edges
            out_p, out_c = gatv2_attend_dual(conv_p.lin_l(en), conv_c.lin_l(en), *args[7:],
                                             plain=plain)
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
    """The gather-broadcast edge update,
    ``(lin_proj(e) + lin_s(s)[pt] + lin_v(v)[cam] + lin_g(g)) / 4`` then,
    with ``n_hidden_layers``, ReLU and an MLP of that many linears. On the
    merged path its per-edge part runs deferred in the next layer-step
    kernel (``tables``); on the unfused path ``forward`` materializes it
    through the edge-combine kernel. Reference
    ``GraphAttnSfMProjectionFeatureUpdate`` (layers.py:873-956)."""

    def __init__(self, n_feat_proj_in: int, n_feat_scenepoint_in: int, n_feat_view_in: int,
                 n_feat_global_in: int, n_feat_proj_out: int, n_hidden_layers: int = 0):
        super().__init__()
        self.scenepoint_norm_layer = LayerNorm(n_feat_scenepoint_in)
        self.view_norm_layer = LayerNorm(n_feat_view_in)
        self.global_norm_layer = LayerNorm(n_feat_global_in)
        self.lin_proj = TorchDense(n_feat_proj_in, n_feat_proj_out)
        self.lin_scenepoint = TorchDense(n_feat_scenepoint_in, n_feat_proj_out, bias=False)
        self.lin_view = TorchDense(n_feat_view_in, n_feat_proj_out, bias=False)
        self.lin_global = TorchDense(n_feat_global_in, n_feat_proj_out, bias=False)
        self.mlp = (MLPStack([n_feat_proj_out] * (n_hidden_layers + 1))
                    if n_hidden_layers > 0 else None)

    def tables(self, s, v, g):
        """(ps (n, De), pv (m, De), pg (1, De)): the table linears."""
        return (self.lin_scenepoint(torch.relu(self.scenepoint_norm_layer(s))),
                self.lin_view(torch.relu(self.view_norm_layer(v))),
                self.lin_global(torch.relu(self.global_norm_layer(g))))

    def forward(self, s, v, g, x_edges, graph, plain=False):
        """The materialized (E, De) update of the (E, d_in) stream."""
        e = edge_combine(self.lin_proj(x_edges), *self.tables(s, v, g), graph, plain)
        return e if self.mlp is None else self.mlp(torch.relu(e))


class ProjLayer(nn.Module):
    """Reference ``ProjLayer`` (a named linear)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.lin_proj = TorchDense(d_in, d_out)


class GraphAttnLayer(nn.Module):
    """One GASFM message-passing round. Reference ``GraphAttnSfMLayer``
    (layers.py:150-263): LN + ReLU on the edge stream (ReLU alone without
    ``use_norm_proj_update``) -> global feature update -> optional
    init-embedding concat -> edge update -> residual (through a projected
    skip when the widths differ).

    ``forward(merged=True)`` runs the frontend through the frontend or
    layer-step kernel and returns this layer's update deferred
    (:class:`PendingUpdate`) with the new node features; the next layer step
    materializes it. When the widths differ (the first layer), the
    width-adapting residual rides the update's skip2 slot: skip2 =
    relu(LN_res(raw)) with weight columns 4 * W_skip and bias + 4 * b_skip,
    which the update's /4 cancels — the JAX package's first-layer deferral
    (models/layers.py:954-994). With ``defer=False`` it materializes the
    update itself through the projection-update kernel, skip2 the init skip
    and the layer's input stream the residual — the JAX package's packed
    layer whose successor is not packed (models/layers.py:932-952).
    ``forward(merged=False)`` is the JAX package's unfused layer
    (models/layers.py:919-929, 996-1017): it returns the materialized (E, De)
    stream, with the projected skip applied after the update (also when the
    layer widens the stream and concatenates the init skip, as the depth
    head's last layer does). All take the same parameters."""

    def __init__(self, n_feat_proj_in: int, n_feat_proj_out: int, n_feat_scenepoint_hidden: int,
                 n_feat_view_hidden: int, n_feat_global_hidden: int,
                 n_feat_proj2scenepoint_agg: Optional[int] = None,
                 n_feat_proj2view_agg: Optional[int] = None,
                 n_feat_scenepoint2global_agg: Optional[int] = None,
                 n_feat_view2global_agg: Optional[int] = None,
                 use_norm_proj_update: bool = True,
                 add_residual_skipconn_proj_update: bool = True,
                 n_feat_skipconn_init_projfeat_in: Optional[int] = None,
                 n_heads: int = 1, stateful: bool = True,
                 global2view_and_global2scenepoint_enabled: bool = True,
                 n_hidden_layers_scenepoint_update: int = 0,
                 n_hidden_layers_view_update: int = 0,
                 n_hidden_layers_global_update: int = 0,
                 n_hidden_layers_proj_update: int = 0):
        super().__init__()
        self.use_norm = use_norm_proj_update
        self.add_residual = add_residual_skipconn_proj_update
        self.n_skip_in = n_feat_skipconn_init_projfeat_in or 0
        if use_norm_proj_update:
            self.prev_projfeat_norm_layer = LayerNorm(n_feat_proj_in)
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
            n_feat_global_hidden, n_feat_proj_out, n_hidden_layers_proj_update)
        self.skip_projection = None
        if add_residual_skipconn_proj_update and n_feat_proj_in != n_feat_proj_out:
            if use_norm_proj_update:
                self.residual_skipconn_proj_norm_layer = LayerNorm(n_feat_proj_in)
            self.skip_projection = ProjLayer(n_feat_proj_in, n_feat_proj_out)

    def forward(self, x_edges, graph, prev_scenepoint_features=None, prev_view_features=None,
                prev_global_features=None, skipconn_init_projfeat=None, merged=True,
                defer=True, plain=False, stream_dtype=torch.float32):
        """``stream_dtype``: the merged path's stored edge streams
        (``compile.stream_dtype``). A merged layer stores e_norm, skip2 and
        res in it, rounding where its input stream is float32 (the first
        layer's, as the JAX package's first-layer deferral rounds them,
        models/layers.py:789-793, :975-990); a bf16 stream keeps its dtype
        through the kernels. The unfused layer ignores it."""
        nodes = (prev_scenepoint_features, prev_view_features, prev_global_features)
        if not merged:
            return self._unfused(x_edges, graph, nodes, skipconn_init_projfeat, plain)
        # the update's one skip2 slot holds the init skip or the width adapter
        assert not (self.n_skip_in and self.skip_projection is not None)
        norm = self.prev_projfeat_norm_layer
        s, v, g, en, e_prev = self.global_feature_update(
            x_edges, graph, *nodes, ln=(norm.weight, norm.bias), plain=plain,
            en_dtype=stream_dtype)
        raw = x_edges if e_prev is None else e_prev  # this layer's input stream
        update = self.projection_feature_update
        ps, pv, pg = update.tables(s, v, g)
        w, b = f32(update.lin_proj.weight), f32(update.lin_proj.bias)
        skip2 = skipconn_init_projfeat if self.n_skip_in else None
        res = None
        if self.skip_projection is not None:
            lin = self.skip_projection.lin_proj
            skip2 = to_stream(torch.relu(self.residual_skipconn_proj_norm_layer(raw)),
                              stream_dtype)
            w = torch.cat([w, 4.0 * f32(lin.weight)], dim=1)
            b = b + 4.0 * f32(lin.bias)
        elif self.add_residual:
            res = to_stream(raw, stream_dtype)
        pending = PendingUpdate(en, skip2, res, w, b, ps, pv, pg)
        if defer:
            return pending, s, v, g
        return projection_update(pending, graph, plain), s, v, g

    def _unfused(self, raw, graph, nodes, skip_init, plain):
        gfu = self.global_feature_update
        if self.use_norm:
            norm = self.prev_projfeat_norm_layer
            s, v, g, x, _ = gfu(raw, graph, *nodes, ln=(norm.weight, norm.bias), plain=plain)
        else:  # reference layers.py:228-234: ReLU only, no normalization
            x = torch.relu(raw)
            s, v, g, _, _ = gfu(x, graph, *nodes, ln=None, plain=plain)
        if self.n_skip_in:
            x = torch.cat([x, skip_init], dim=1)
        e = self.projection_feature_update(s, v, g, x, graph, plain)
        if self.add_residual:
            x_skip = raw
            if self.skip_projection is not None:
                if self.use_norm:
                    x_skip = torch.relu(self.residual_skipconn_proj_norm_layer(x_skip))
                x_skip = self.skip_projection.lin_proj(x_skip)
            e = x_skip + e
        return e, s, v, g


# ---------------------------------------------------------------------------
# DPESFM (set-of-sets) blocks
# ---------------------------------------------------------------------------


def normalize_edge_features(x: torch.Tensor, graph) -> torch.Tensor:
    """Mean-centering over the edges (reference ``normalize_projection_features``
    with no LayerNorm, layers.py:972-979): the port's graph holds valid edges
    only, so the JAX package's masked mean is the column mean over the
    scene's edges (:func:`~gasfm_tpu_torch.ops.segment.edge_mean`)."""
    return x - edge_mean(x, graph)


class SetOfSetGlobalFeatureUpdate(nn.Module):
    """Per-point and per-view means (segment-sum kernel) and the global mean,
    each through a linear. Reference layers.py:100-126."""

    def __init__(self, d_in: int, d_out: int, output_global: bool = True):
        super().__init__()
        self.lin_scenepoint = TorchDense(d_in, d_out)
        self.lin_view = TorchDense(d_in, d_out)
        self.lin_global = TorchDense(d_in, d_out) if output_global else None

    def forward(self, x_edges, graph, plain=False):
        s = self.lin_scenepoint(segment_mean(x_edges, graph, "point", plain))
        v = self.lin_view(segment_mean(x_edges, graph, "camera", plain))
        if self.lin_global is None:
            return s, v
        return s, v, self.lin_global(edge_mean(x_edges, graph))


class SetOfSetLayer(nn.Module):
    """Reference ``SetOfSetLayer`` (layers.py:87-97): the means' linears and
    the edge linear, combined by the edge-combine kernel."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.global_feature_update = SetOfSetGlobalFeatureUpdate(d_in, d_out)
        self.projection_feature_update = ProjLayer(d_in, d_out)

    def forward(self, x_edges, graph, plain=False):
        s, v, g = self.global_feature_update(x_edges, graph, plain)
        pe = self.projection_feature_update.lin_proj(x_edges)
        return edge_combine(pe, s, v, g, graph, plain)


class SetOfSetBlock(nn.Module):
    """Reference ``SetOfSetBlock`` (code/models/SetOfSet.py:7-46):
    ``block_size`` layers with mean-centering and ReLU between them, an
    optional residual (through ``skip_projection`` when the widths differ),
    and a final ReLU."""

    def __init__(self, d_in: int, d_out: int, block_size: int, proj_feat_normalization: bool,
                 add_skipconn_for_residual_blocks: bool):
        super().__init__()
        self.proj_feat_normalization = proj_feat_normalization
        self.add_skip = add_skipconn_for_residual_blocks
        self.layers = nn.ModuleList([SetOfSetLayer(d_in if j == 0 else d_out, d_out)
                                     for j in range(block_size)])
        self.skip_projection = (ProjLayer(d_in, d_out)
                                if self.add_skip and d_in != d_out else None)

    def forward(self, x_edges, graph, plain=False):
        xl = x_edges
        for j, layer in enumerate(self.layers):
            xl = layer(xl, graph, plain)
            if j < len(self.layers) - 1:
                if self.proj_feat_normalization:
                    xl = normalize_edge_features(xl, graph)
                xl = torch.relu(xl)
        if self.add_skip:
            x_skip = x_edges
            if self.skip_projection is not None:
                x_skip = self.skip_projection.lin_proj(x_skip)
                if self.proj_feat_normalization:
                    x_skip = normalize_edge_features(x_skip, graph)
            xl = x_skip + xl
        return torch.relu(xl)


class Parameter3DPts(nn.Module):
    """A learnable bank of 3D points, ``pts_3d`` (3, n_pts), normal with
    sigma 0.1 (drawn from ``generator``; left uninitialized without one):
    the JAX package's ``Parameter3DPts`` (models/layers.py:1094; reference
    models/layers.py:47-57), unused by the shipped confs. Its flax key is
    ``pts_3d``, its layout the same."""

    def __init__(self, n_pts: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pts_3d = nn.Parameter(torch.empty(3, n_pts))
        if generator is not None:
            init_parameters(self, generator)

    def forward(self) -> torch.Tensor:
        return self.pts_3d


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
        elif isinstance(mod, Parameter3DPts):
            with torch.no_grad():
                mod.pts_3d.copy_(torch.randn(mod.pts_3d.shape, generator=generator) * 0.1)
