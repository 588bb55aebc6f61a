"""GASFM: the graph-attention SfM network (forward).

Counterpart of the JAX package's models/gasfm.py (reference
``GraphAttnSfMNet``, code/models/graph_attn_sfm.py:8-185). Four feature
streams (per-edge projection, per-point, per-view, global), ``num_layers``
attention rounds with stateful global features and the init-embedding skip,
a final global update without the global stream, then the view and
scenepoint heads.

The edge stream always takes the merged-kernel path of the JAX package's
packed layout (``GASFM_PACKED=1``, ``GASFM_MERGED=1``, final aggregation on
the raw stream): per forward one frontend call (layer 0) and ``num_layers``
layer-step calls. Configurations that path does not cover (no edge
LayerNorm, a projection-update MLP, the depth head, a head disabled) raise
``NotImplementedError``; they come with later slices.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from gasfm_tpu_torch.models.heads import (
    decode_scenepoint_outputs,
    decode_view_outputs,
    view_head_out_channels,
)
from gasfm_tpu_torch.models.layers import (
    EmbeddingLayer,
    GraphAttnGlobalFeatureUpdate,
    GraphAttnLayer,
    MLPStack,
    init_parameters,
)


class GraphAttnSfMNet(nn.Module):
    def __init__(
        self,
        num_layers: int,
        n_heads: int,
        n_feat_proj: int,
        n_feat_scenepoint: int,
        n_feat_view: int,
        n_feat_global: int,
        calibrated: bool = True,
        rot_representation: str = "quat",
        normalize_output: Optional[str] = None,
        n_feat_proj2scenepoint_agg: Optional[int] = None,
        n_feat_proj2view_agg: Optional[int] = None,
        n_feat_scenepoint2global_agg: Optional[int] = None,
        n_feat_view2global_agg: Optional[int] = None,
        n_hidden_layers_scenepoint_update: int = 0,
        n_hidden_layers_view_update: int = 0,
        n_hidden_layers_global_update: int = 0,
        n_hidden_layers_proj_update: int = 0,
        pos_emb_n_freq: int = 0,
        use_norm_proj_update: bool = True,
        add_residual_skipconn_proj_update: bool = True,
        add_skipconn_from_init_projfeat: bool = True,
        stateful_global_features: bool = True,
        global2view_and_global2scenepoint_enabled: bool = False,
        depth_head_enabled: bool = False,
        view_head_enabled: bool = True,
        view_head_n_hidden_layers: int = 2,
        scenepoint_head_enabled: bool = True,
        scenepoint_head_n_hidden_layers: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not use_norm_proj_update or n_hidden_layers_proj_update or depth_head_enabled \
                or not (view_head_enabled and scenepoint_head_enabled):
            raise NotImplementedError(
                "the port's GASFM forward covers use_norm_proj_update, no projection-update "
                "MLP, no depth head, and both view and scenepoint heads")
        self.calibrated = calibrated
        self.rot_representation = rot_representation
        self.normalize_output = normalize_output
        self.stateful = stateful_global_features
        self.add_skipconn_from_init_projfeat = add_skipconn_from_init_projfeat

        self.embed = EmbeddingLayer(pos_emb_n_freq, 2, post_embed_proj_dim=-1)
        d_emb = self.embed.d_out
        common = dict(
            n_feat_proj2scenepoint_agg=n_feat_proj2scenepoint_agg,
            n_feat_proj2view_agg=n_feat_proj2view_agg,
            n_feat_scenepoint2global_agg=n_feat_scenepoint2global_agg,
            n_feat_view2global_agg=n_feat_view2global_agg,
            n_heads=n_heads,
            global2view_and_global2scenepoint_enabled=global2view_and_global2scenepoint_enabled,
            n_hidden_layers_scenepoint_update=n_hidden_layers_scenepoint_update,
            n_hidden_layers_view_update=n_hidden_layers_view_update,
            n_hidden_layers_global_update=n_hidden_layers_global_update,
        )
        self.equivariant_blocks = nn.ModuleList([
            GraphAttnLayer(
                d_emb if i == 0 else n_feat_proj, n_feat_proj,
                n_feat_scenepoint, n_feat_view, n_feat_global,
                add_residual_skipconn_proj_update=add_residual_skipconn_proj_update,
                n_feat_skipconn_init_projfeat_in=(
                    d_emb if (i > 0 and add_skipconn_from_init_projfeat) else None),
                stateful=False if i == 0 else stateful_global_features,
                **common,
            )
            for i in range(num_layers)
        ])
        self.final_global_update = GraphAttnGlobalFeatureUpdate(
            n_feat_proj, n_feat_scenepoint, n_feat_view, n_feat_global_out=n_feat_global,
            output_global=False, stateful=stateful_global_features, **common)
        out_ch = view_head_out_channels(calibrated, rot_representation)
        self.view_head = MLPStack([n_feat_view] * (1 + view_head_n_hidden_layers) + [out_ch])
        self.scenepoint_head = MLPStack(
            [n_feat_scenepoint] * (1 + scenepoint_head_n_hidden_layers) + [3])
        # float32 whatever torch's default dtype is: the slice runs in f32
        # end to end, and the kernels take float32 only.
        self.to(torch.float32)
        if generator is not None:
            init_parameters(self, generator)

    def forward(self, graph, plain: bool = False) -> Dict[str, torch.Tensor]:
        """Predicted normalized cameras ``Ps_norm`` (m, 3, 4) and homogeneous
        points ``pts3D`` (4, n) for one scene graph. ``plain=True`` runs the
        kernels' plain PyTorch versions whatever the device."""
        e = self.embed(graph.uv)
        skip_init = e if self.add_skipconn_from_init_projfeat else None
        s = v = g = None
        for blk in self.equivariant_blocks:
            e, s, v, g = blk(
                e, graph,
                prev_scenepoint_features=s if self.stateful else None,
                prev_view_features=v if self.stateful else None,
                prev_global_features=g if self.stateful else None,
                skipconn_init_projfeat=skip_init, plain=plain,
            )
        n_input, m_input, _, _, _ = self.final_global_update(
            e, graph,
            prev_scenepoint_features=s if self.stateful else None,
            prev_view_features=v if self.stateful else None,
            prev_global_features=g if self.stateful else None,
            ln=None, plain=plain,
        )
        m_out = self.view_head(torch.relu(m_input))
        n_out = self.scenepoint_head(torch.relu(n_input)).T  # (3, n)
        return {
            "Ps_norm": decode_view_outputs(m_out, self.calibrated, self.rot_representation,
                                           self.normalize_output),
            "pts3D": decode_scenepoint_outputs(n_out),
        }
