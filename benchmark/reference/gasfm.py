"""GASFM, the graph-attention SfM network, in plain PyTorch.

Four streams: one row per observation (edge), per point, per camera and one
global row. Each of ``num_layers`` rounds takes the edge stream through a
LayerNorm and a ReLU, aggregates it into the points and the cameras by GATv2
attention (queries from the previous round's node rows, from the layer
bias alone in the first round), pools the cameras and the points into the
global row by attention, and updates the edges as
``(lin_proj([e | e_0]) + lin_s(s)[pt] + lin_v(v)[cam] + lin_g(g)) / 4`` with
a residual (through a projection in the first round, where the width
changes). A last aggregation of the raw stream feeds the camera head
(quaternion and translation) and the point head.

Follows the published ``GraphAttnSfMNet`` for the options of the flagship
configuration; ``check_options`` refuses the others. Each round runs under
``torch.utils.checkpoint``: the backward recomputes its activations, the
same arithmetic, so that the float64 reference of a scene of a million
observations fits the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import (MLP, attention_pool, decode_heads, layer_norm,
                                        segment_attention)


def agg_width(d: int, heads: int) -> int:
    return d + (-d) % heads


class GraphConv(nn.Module):
    def __init__(self, d_in: int, per_head: int, heads: int):
        super().__init__()
        D = heads * per_head
        self.heads = heads
        self.lin_l = nn.Linear(d_in, D)
        self.lin_r = nn.Linear(d_in, D)
        self.att = nn.Parameter(torch.empty(1, heads, per_head))
        self.bias = nn.Parameter(torch.empty(D))

    def query(self, q: Optional[torch.Tensor], rows: int) -> torch.Tensor:
        return self.lin_r.bias.expand(rows, -1) if q is None else self.lin_r(q)


def adapter(d_state: int, d_target: int) -> nn.Sequential:
    mods = [nn.LayerNorm(d_state), nn.ReLU()]
    if d_target != d_state:
        mods.append(nn.Linear(d_state, d_target))
    return nn.Sequential(*mods)


class Aggregator(nn.Module):
    """Edges -> points or cameras: attention, width adapter, residual, and
    a residual MLP behind a LayerNorm."""

    def __init__(self, d_in: int, d_out: int, heads: int, target: str, stateful: bool,
                 n_hidden: int):
        super().__init__()
        agg = agg_width(d_in, heads)
        self.stateful = stateful
        self.target = target
        if stateful:
            self.add_module(f"norm_and_proj_{target}2proj", adapter(d_out, d_in))
        self.graph_conv = GraphConv(d_in, agg // heads, heads)
        if agg != d_out:
            self.add_module(f"proj_proj2{target}", nn.Linear(agg, d_out))
        self.norm_pre_mlp = nn.LayerNorm(d_out)
        self.mlp = MLP([d_out] * (2 + n_hidden))

    def forward(self, en, ids, num, prev):
        conv = self.graph_conv
        q = getattr(self, f"norm_and_proj_{self.target}2proj")(prev) if self.stateful else None
        x = segment_attention(conv.lin_l(en), conv.query(q, num), conv.att.reshape(-1), ids, num,
                              conv.heads) + conv.bias
        proj = getattr(self, f"proj_proj2{self.target}", None)
        if proj is not None:
            x = proj(x)
        if prev is not None:
            x = prev + x
        return x + self.mlp(torch.relu(layer_norm(x, self.norm_pre_mlp)))


class GlobalPool(nn.Module):
    """Cameras and points -> the global row."""

    def __init__(self, d_point: int, d_view: int, d_global: int, heads: int, stateful: bool,
                 n_hidden: int):
        super().__init__()
        s2g, v2g = agg_width(d_point, heads), agg_width(d_view, heads)
        self.stateful = stateful
        if stateful:
            self.norm_and_proj_global2view = adapter(d_global, d_view)
        self.graph_conv_view2global = GraphConv(d_view, v2g // heads, heads)
        if stateful:
            self.norm_and_proj_global2scenepoint = adapter(d_global, d_point)
        self.graph_conv_scenepoint2global = GraphConv(d_point, s2g // heads, heads)
        self.proj_view_and_scenepoint2global = (nn.Linear(v2g + s2g, d_global)
                                                if v2g + s2g != d_global else None)
        self.norm_pre_mlp = nn.LayerNorm(d_global)
        self.mlp = MLP([d_global] * (2 + n_hidden))

    def forward(self, v, s, cam_valid, pt_valid, prev):
        qv = qs = None
        if self.stateful:
            qv = self.norm_and_proj_global2view(prev)
            qs = self.norm_and_proj_global2scenepoint(prev)
        parts = []
        for conv, x, mask, q in ((self.graph_conv_view2global, v, cam_valid, qv),
                                 (self.graph_conv_scenepoint2global, s, pt_valid, qs)):
            parts.append(attention_pool(conv.lin_l(x), conv.query(q, 1), conv.att.reshape(-1),
                                        mask, conv.heads) + conv.bias)
        x = torch.cat(parts, dim=1)
        if self.proj_view_and_scenepoint2global is not None:
            x = self.proj_view_and_scenepoint2global(x)
        if prev is not None:
            x = prev + x
        return x + self.mlp(torch.relu(layer_norm(x, self.norm_pre_mlp)))


class GlobalFeatureUpdate(nn.Module):
    def __init__(self, d_in, d_point, d_view, d_global, heads, stateful, with_global, n_hidden):
        super().__init__()
        self.proj2view = Aggregator(d_in, d_view, heads, "view", stateful, n_hidden["view"])
        self.proj2scenepoint = Aggregator(d_in, d_point, heads, "scenepoint", stateful,
                                          n_hidden["scenepoint"])
        if with_global:
            self.view_and_scenepoint2global = GlobalPool(d_point, d_view, d_global, heads,
                                                         stateful, n_hidden["global"])

    def forward(self, en, graph, prev_s, prev_v, prev_g):
        s = self.proj2scenepoint(en, graph.pt, graph.num_pts, prev_s)
        v = self.proj2view(en, graph.cam, graph.num_cams, prev_v)
        g = None
        if hasattr(self, "view_and_scenepoint2global"):
            g = self.view_and_scenepoint2global(v, s, graph.cam_valid, graph.pt_valid, prev_g)
        return s, v, g


class EdgeUpdate(nn.Module):
    def __init__(self, d_in, d_point, d_view, d_global, d_out):
        super().__init__()
        self.scenepoint_norm_layer = nn.LayerNorm(d_point)
        self.view_norm_layer = nn.LayerNorm(d_view)
        self.global_norm_layer = nn.LayerNorm(d_global)
        self.lin_proj = nn.Linear(d_in, d_out)
        self.lin_scenepoint = nn.Linear(d_point, d_out, bias=False)
        self.lin_view = nn.Linear(d_view, d_out, bias=False)
        self.lin_global = nn.Linear(d_global, d_out, bias=False)

    def forward(self, x, s, v, g, graph):
        ps = self.lin_scenepoint(torch.relu(layer_norm(s, self.scenepoint_norm_layer)))
        pv = self.lin_view(torch.relu(layer_norm(v, self.view_norm_layer)))
        pg = self.lin_global(torch.relu(layer_norm(g, self.global_norm_layer)))
        return (self.lin_proj(x) + ps[graph.pt] + pv[graph.cam] + pg) / 4.0


class SkipProjection(nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.lin_proj = nn.Linear(d_in, d_out)


class Layer(nn.Module):
    def __init__(self, d_in, d_out, d_point, d_view, d_global, heads, stateful, d_skip, n_hidden):
        super().__init__()
        self.d_skip = d_skip
        self.prev_projfeat_norm_layer = nn.LayerNorm(d_in)
        self.global_feature_update = GlobalFeatureUpdate(d_in, d_point, d_view, d_global, heads,
                                                         stateful, True, n_hidden)
        self.projection_feature_update = EdgeUpdate(d_in + d_skip, d_point, d_view, d_global,
                                                    d_out)
        if d_in != d_out:
            self.residual_skipconn_proj_norm_layer = nn.LayerNorm(d_in)
            self.skip_projection = SkipProjection(d_in, d_out)

    def forward(self, raw, graph, skip_init, prev_s, prev_v, prev_g):
        x = torch.relu(layer_norm(raw, self.prev_projfeat_norm_layer))
        s, v, g = self.global_feature_update(x, graph, prev_s, prev_v, prev_g)
        if self.d_skip:
            x = torch.cat([x, skip_init], dim=1)
        e = self.projection_feature_update(x, s, v, g, graph)
        if hasattr(self, "skip_projection"):
            raw = self.skip_projection.lin_proj(
                torch.relu(layer_norm(raw, self.residual_skipconn_proj_norm_layer)))
        return raw + e, s, v, g


class Embed(nn.Module):
    def __init__(self):
        super().__init__()
        self.post_embed_lin = nn.Linear(2, 2)


OPTIONS = dict(stateful_global_features=True, add_skipconn_from_init_projfeat=True,
               use_norm_proj_update=True, add_residual_skipconn_proj_update=True,
               global2view_and_global2scenepoint_enabled=False, pos_emb_n_freq=0,
               n_hidden_layers_proj_update=0)


def check_options(model_conf: dict) -> None:
    for key, want in OPTIONS.items():
        if model_conf.get(key, want) != want:
            raise NotImplementedError(f"the reference GASFM takes {key} = {want} only")
    if model_conf.get("depth_head", {}).get("enabled", False):
        raise NotImplementedError("the reference GASFM has no depth head")
    if model_conf["view_head"].get("rot_representation", "quat") != "quat":
        raise NotImplementedError("the reference GASFM decodes quaternion cameras only")


class GASFM(nn.Module):
    def __init__(self, model_conf: dict):
        super().__init__()
        check_options(model_conf)
        c = model_conf
        L, H, D = c["num_layers"], c["n_heads"], c["n_feat_proj"]
        S, V, G = c["n_feat_scenepoint"], c["n_feat_view"], c["n_feat_global"]
        n_hidden = {"view": c.get("n_hidden_layers_view_update", 0),
                    "scenepoint": c.get("n_hidden_layers_scenepoint_update", 0),
                    "global": c.get("n_hidden_layers_global_update", 0)}
        self.embed = Embed()
        self.equivariant_blocks = nn.ModuleList([
            Layer(2 if i == 0 else D, D, S, V, G, H, stateful=i > 0, d_skip=0 if i == 0 else 2,
                  n_hidden=n_hidden)
            for i in range(L)])
        self.final_global_update = GlobalFeatureUpdate(D, S, V, G, H, True, False, n_hidden)
        self.view_head = MLP([V] * (1 + c["view_head"]["n_hidden_layers"]) + [7])
        self.scenepoint_head = MLP([S] * (1 + c["scenepoint_head"]["n_hidden_layers"]) + [3])

    def forward(self, graph) -> dict:
        e = self.embed.post_embed_lin(graph.uv)
        skip_init = e
        s = v = g = None
        for blk in self.equivariant_blocks:
            e, s, v, g = checkpoint(blk, e, graph, skip_init, s, v, g, use_reentrant=False)
        s, v, _ = self.final_global_update(e, graph, s, v, None)
        return decode_heads(self.view_head(torch.relu(v)), self.scenepoint_head(torch.relu(s)))
