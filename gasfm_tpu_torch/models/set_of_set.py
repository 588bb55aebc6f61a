"""DPESFM: the set-of-sets permutation-equivariant baseline (forward).

Counterpart of the JAX package's models/set_of_set.py (reference
``SetOfSetNet``, code/models/SetOfSet.py:49-142): the embedding (the raw
uv, or its positional embedding), ``num_blocks`` residual blocks of
segment-mean layers, then a final global update without the global stream,
ReLU, and the view and scenepoint heads, or (``depth_head_enabled``) a
per-edge depth MLP on the last block's stream, which that block narrows to
``depth_head_n_feat`` (reference SetOfSet.py:53-84). Per forward, each layer
launches two segment sums (its point and camera means) and one edge
combine, and the final update two more segment sums.

Head combinations that no loss of the JAX package accepts raise
``NotImplementedError`` (``models/heads.py`` ``check_heads``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from gasfm_tpu_torch.models.heads import (
    check_heads,
    decode_scenepoint_outputs,
    decode_view_outputs,
    view_head_out_channels,
)
from gasfm_tpu_torch.models.layers import (
    EmbeddingLayer,
    MLPStack,
    SetOfSetBlock,
    SetOfSetGlobalFeatureUpdate,
    init_parameters,
)


class SetOfSetNet(nn.Module):
    def __init__(
        self,
        num_blocks: int,
        num_features: int,
        block_size: int,
        calibrated: bool = True,
        rot_representation: str = "quat",
        normalize_output: Optional[str] = None,
        proj_feat_normalization: bool = True,
        add_skipconn_for_residual_blocks: bool = True,
        pos_emb_n_freq: int = 0,
        depth_head_enabled: bool = False,
        depth_head_n_feat: int = 128,
        depth_head_n_hidden_layers: int = 2,
        view_head_enabled: bool = True,
        view_head_n_hidden_layers: int = 2,
        scenepoint_head_enabled: bool = True,
        scenepoint_head_n_hidden_layers: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        check_heads(depth_head_enabled, view_head_enabled, scenepoint_head_enabled)
        self.depth_head_enabled = depth_head_enabled
        self.calibrated = calibrated
        self.rot_representation = rot_representation
        self.normalize_output = normalize_output
        # the widest per-edge, per-point, per-view and global activation
        self.activation_widths = (max(num_features, depth_head_n_feat if depth_head_enabled
                                      else 0), num_features, num_features, num_features)

        self.embed = EmbeddingLayer(pos_emb_n_freq, 2, post_embed_proj_dim=None)
        self.equivariant_blocks = nn.ModuleList([
            SetOfSetBlock(self.embed.d_out if i == 0 else num_features,
                          (depth_head_n_feat if depth_head_enabled and i == num_blocks - 1
                           else num_features),
                          block_size, proj_feat_normalization, add_skipconn_for_residual_blocks)
            for i in range(num_blocks)
        ])
        if depth_head_enabled:
            self.depth_head = MLPStack(
                [depth_head_n_feat] * (1 + depth_head_n_hidden_layers) + [1])
        else:
            self.final_global_update = SetOfSetGlobalFeatureUpdate(
                num_features, num_features, output_global=False)
            out_ch = view_head_out_channels(calibrated, rot_representation)
            self.view_head = MLPStack([num_features] * (1 + view_head_n_hidden_layers) + [out_ch])
            self.scenepoint_head = MLPStack(
                [num_features] * (1 + scenepoint_head_n_hidden_layers) + [3])
        self.to(torch.float32)  # the kernels take float32 only
        if generator is not None:
            init_parameters(self, generator)

    @staticmethod
    def conf_kwargs(conf) -> dict:
        """The constructor's keyword arguments from a conf, read as the JAX
        package's ``SetOfSetNet.from_conf`` reads them
        (``gasfm_tpu/models/set_of_set.py:112-135``, reference
        SetOfSet.py:50-100)."""
        return dict(
            num_blocks=conf.get_int("model.num_blocks"),
            num_features=conf.get_int("model.num_features"),
            block_size=conf.get_int("model.block_size"),
            calibrated=conf.get_bool("dataset.calibrated"),
            rot_representation=conf.get_string("model.view_head.rot_representation",
                                               default="quat"),
            normalize_output=conf.get_string("model.view_head.normalize_output", default=None),
            proj_feat_normalization=conf.get_bool("model.proj_feat_normalization"),
            add_skipconn_for_residual_blocks=conf.get_bool(
                "model.add_skipconn_for_residual_blocks"),
            pos_emb_n_freq=conf.get_int("model.pos_emb_n_freq"),
            depth_head_enabled=conf.get_bool("model.depth_head.enabled", default=False),
            depth_head_n_feat=conf.get_int("model.depth_head.n_feat", default=128),
            depth_head_n_hidden_layers=conf.get_int("model.depth_head.n_hidden_layers",
                                                    default=2),
            view_head_enabled=conf.get_bool("model.view_head.enabled", default=False),
            view_head_n_hidden_layers=conf.get_int("model.view_head.n_hidden_layers", default=2),
            scenepoint_head_enabled=conf.get_bool("model.scenepoint_head.enabled", default=False),
            scenepoint_head_n_hidden_layers=conf.get_int("model.scenepoint_head.n_hidden_layers",
                                                         default=2),
        )

    @classmethod
    def from_conf(cls, conf, generator: Optional[torch.Generator] = None) -> "SetOfSetNet":
        """Build from a conf (:meth:`conf_kwargs`), its weights drawn from
        ``generator`` (the port's initializer; a JAX init carries over
        through ``models.convert.params_from_jax``)."""
        return cls(**cls.conf_kwargs(conf), generator=generator)

    def forward(self, graph, plain: bool = False) -> Dict[str, torch.Tensor]:
        """Predicted normalized cameras ``Ps_norm`` (m, 3, 4) and homogeneous
        points ``pts3D`` (4, n) for one scene graph, or with the depth head
        the per-edge ``depths`` (E,) in the graph's edge order.
        ``plain=True`` runs the kernels' plain PyTorch versions whatever the
        device."""
        e = self.embed(graph.uv)
        for blk in self.equivariant_blocks:
            e = blk(e, graph, plain)
        if self.depth_head_enabled:
            return {"depths": self.depth_head(e)[:, 0]}
        n_input, m_input = self.final_global_update(e, graph, plain)
        m_out = self.view_head(torch.relu(m_input))
        n_out = self.scenepoint_head(torch.relu(n_input)).T  # (3, n)
        return {
            "Ps_norm": decode_view_outputs(m_out, self.calibrated, self.rot_representation,
                                           self.normalize_output),
            "pts3D": decode_scenepoint_outputs(n_out),
        }
