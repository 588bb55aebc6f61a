"""DPESFM, the set-of-sets network, in plain PyTorch.

Each set-of-sets layer maps the edge stream x to
``(lin_proj(x) + lin_s(mean_pt(x))[pt] + lin_v(mean_cam(x))[cam] +
lin_g(mean(x))) / 4``; inside a block the layers are separated by
mean-centering over the edges and a ReLU, and the block ends in a ReLU. The
heads read the point and camera means of the last stream through their own
linears. Follows the published ``SetOfSetNet`` for the options of the
configuration; ``check_options`` refuses the others.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.common import MLP, decode_heads, segment_mean


class Means(nn.Module):
    def __init__(self, d_in: int, d_out: int, with_global: bool = True):
        super().__init__()
        self.lin_scenepoint = nn.Linear(d_in, d_out)
        self.lin_view = nn.Linear(d_in, d_out)
        if with_global:
            self.lin_global = nn.Linear(d_in, d_out)

    def forward(self, x, graph):
        s = self.lin_scenepoint(segment_mean(x, graph.pt, graph.pt_count))
        v = self.lin_view(segment_mean(x, graph.cam, graph.cam_count))
        return s, v


class EdgeLinear(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.lin_proj = nn.Linear(d_in, d_out)


class SetLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.global_feature_update = Means(d_in, d_out)
        self.projection_feature_update = EdgeLinear(d_in, d_out)

    def forward(self, x, graph):
        s, v = self.global_feature_update(x, graph)
        g = self.global_feature_update.lin_global(x.mean(0, keepdim=True))
        pe = self.projection_feature_update.lin_proj(x)
        return (pe + s[graph.pt] + v[graph.cam] + g) / 4.0


class Block(nn.Module):
    def __init__(self, d_in: int, d_out: int, size: int, normalize: bool):
        super().__init__()
        self.normalize = normalize
        self.layers = nn.ModuleList([SetLayer(d_in if j == 0 else d_out, d_out)
                                     for j in range(size)])

    def forward(self, x, graph):
        for j, layer in enumerate(self.layers):
            x = layer(x, graph)
            if j < len(self.layers) - 1:
                if self.normalize:
                    x = x - x.mean(0, keepdim=True)
                x = torch.relu(x)
        return torch.relu(x)


OPTIONS = dict(add_skipconn_for_residual_blocks=False, pos_emb_n_freq=0)


def check_options(model_conf: dict) -> None:
    for key, want in OPTIONS.items():
        if model_conf.get(key, want) != want:
            raise NotImplementedError(f"the reference DPESFM takes {key} = {want} only")
    if model_conf.get("depth_head", {}).get("enabled", False):
        raise NotImplementedError("the reference DPESFM has no depth head")
    if model_conf["view_head"].get("rot_representation", "quat") != "quat":
        raise NotImplementedError("the reference DPESFM decodes quaternion cameras only")


class DPESFM(nn.Module):
    def __init__(self, model_conf: dict):
        super().__init__()
        check_options(model_conf)
        c = model_conf
        F_ = c["num_features"]
        self.equivariant_blocks = nn.ModuleList([
            Block(2 if i == 0 else F_, F_, c["block_size"], c["proj_feat_normalization"])
            for i in range(c["num_blocks"])])
        self.final_global_update = Means(F_, F_, with_global=False)
        self.view_head = MLP([F_] * (1 + c["view_head"]["n_hidden_layers"]) + [7])
        self.scenepoint_head = MLP([F_] * (1 + c["scenepoint_head"]["n_hidden_layers"]) + [3])

    def forward(self, graph) -> dict:
        e = graph.uv
        for blk in self.equivariant_blocks:
            e = blk(e, graph)
        s, v = self.final_global_update(e, graph)
        return decode_heads(self.view_head(torch.relu(v)), self.scenepoint_head(torch.relu(s)))
