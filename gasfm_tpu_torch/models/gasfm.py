"""GASFM: the graph-attention SfM network (forward).

Counterpart of the JAX package's models/gasfm.py (reference
``GraphAttnSfMNet``, code/models/graph_attn_sfm.py:8-185). Four feature
streams (per-edge projection, per-point, per-view, global), ``num_layers``
attention rounds with stateful global features and the init-embedding skip,
then either a final global update without the global stream and the view
and scenepoint heads, or (``depth_head_enabled``) a per-edge depth MLP on the
last layer's stream, which that layer widens to ``depth_head_n_feat``.

The edge stream takes the path the JAX package's model code takes for the
scene (``gasfm_tpu/models/gasfm.py:93-160``), decided per graph at forward
time, so one model serves small and large scenes:

- merged — with ``use_norm_proj_update``, no projection-update MLP, an edge
  stream of at most 32 features and at most ``DENSE_MAX_SEGMENTS`` (1024)
  cameras — the path of its packed layout (``GASFM_PACKED=1``,
  ``GASFM_MERGED=1``), layer by layer as its plan has it: a layer is merged
  unless it is the first or changes the stream's width; a merged layer (and
  the first, when its successor is merged) defers its update into the next
  layer-step kernel when its successor is merged too, or when it is the last
  and the final aggregation runs on the raw stream (no depth head); another
  merged layer materializes its update through the projection-update
  kernel; every other layer runs unfused. The flagship without the depth
  head: one frontend call (layer 0) and ``num_layers`` layer-step calls per
  forward. With it: the frontend at layers 0 and L-1, the layer step at
  layers 1 to L-2, the projection update at L-2, the unfused, widening
  update (edge combine) at L-1;
- unfused otherwise: every layer and the final aggregation run the
  composite layer (``models/layers.py``), whose aggregations take the dual
  kernel up to 1024 cameras, and above it the single-direction kernel for
  the points and the composite of gathers, segment max and segment sums for
  the cameras.

Under ``stream_dtype=torch.bfloat16`` (``compile.stream_dtype = "bf16"``,
the JAX package's ``GASFM_STREAM_DTYPE``) the merged path stores its edge
streams and their cotangents in bfloat16 where the JAX package's packed
layout does (``gasfm_tpu/models/gasfm.py:117-121``, ``:160-168``,
``:217``; ``models/layers.py:775-797``, ``:967-993``; the kernels'
outputs of the stream's dtype): the init skip and a stream entering a
merged layer are rounded (to nearest even), the first layer's e_norm,
skip2 or residual too, and the layer-step, frontend and projection-update
kernels load bf16 rows, compute in float32 and round what they store. A
stream leaving the merged path is upcast. The unfused path, DPESFM and the
depth head's last (widening) layer are untouched by it. With
``remat_layers`` (``model.remat_layers``, the JAX package's
``nn.remat(GraphAttnLayer)``) each layer runs under
``torch.utils.checkpoint`` while autograd records: the backward keeps what
crosses a layer's boundary and recomputes the rest, its kernels launching
again.

The packed layout's other gates (its chunk and window shapes) are TPU
layout devices and do not apply. Head combinations that no loss of the JAX
package accepts (``gasfm_tpu/losses.py:344-359``) raise
``NotImplementedError``: the depth head beside another head, or exactly one
of the view and scenepoint heads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gasfm_tpu_torch.models.heads import (
    check_heads,
    decode_scenepoint_outputs,
    decode_view_outputs,
    view_head_out_channels,
)
from gasfm_tpu_torch.models.layers import (
    EmbeddingLayer,
    GraphAttnGlobalFeatureUpdate,
    GraphAttnLayer,
    MLPStack,
    default_agg_width,
    init_parameters,
    to_stream,
)
from gasfm_tpu_torch.ops.kernels.build import upcast
from gasfm_tpu_torch.utils.constants import DENSE_MAX_SEGMENTS

STREAM_DTYPES = {None: torch.float32, "f32": torch.float32, "bf16": torch.bfloat16}


def stream_dtype_from_conf(conf) -> torch.dtype:
    """``compile.stream_dtype``: null or "f32" float32, "bf16" bfloat16;
    anything else raises ``ValueError`` (the JAX package asserts,
    gasfm_tpu/main.py:94)."""
    name = conf.get_string("compile.stream_dtype", default=None)
    if name not in STREAM_DTYPES:
        raise ValueError(f"compile.stream_dtype must be f32|bf16, got {name}")
    return STREAM_DTYPES[name]


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
        depth_head_n_feat: int = 128,
        depth_head_n_hidden_layers: int = 2,
        view_head_enabled: bool = True,
        view_head_n_hidden_layers: int = 2,
        scenepoint_head_enabled: bool = True,
        scenepoint_head_n_hidden_layers: int = 2,
        stream_dtype: torch.dtype = torch.float32,
        remat_layers: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if stream_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"stream_dtype must be float32 or bfloat16, got {stream_dtype}")
        self.stream_dtype = stream_dtype
        self.remat_layers = remat_layers
        check_heads(depth_head_enabled, view_head_enabled, scenepoint_head_enabled)
        self.num_layers = num_layers
        self.n_feat_proj = n_feat_proj
        self.depth_head_enabled = depth_head_enabled
        self.depth_head_n_feat = depth_head_n_feat
        self.use_norm_proj_update = use_norm_proj_update
        self.n_hidden_layers_proj_update = n_hidden_layers_proj_update
        self.calibrated = calibrated
        self.rot_representation = rot_representation
        self.normalize_output = normalize_output
        self.stateful = stateful_global_features
        self.add_skipconn_from_init_projfeat = add_skipconn_from_init_projfeat

        self.embed = EmbeddingLayer(pos_emb_n_freq, 2, post_embed_proj_dim=-1)
        d_emb = self.embed.d_out
        agg_p = n_feat_proj2scenepoint_agg or default_agg_width(n_feat_proj, n_heads)
        agg_c = n_feat_proj2view_agg or default_agg_width(n_feat_proj, n_heads)
        # the widest row of the forward's per-edge, per-point, per-view and
        # global activations: the edge stream (with the init skip beside it),
        # the aggregations' source rows and the depth head's; the node
        # features and their aggregations' rows
        self.activation_widths = (
            max(n_feat_proj + d_emb, agg_p, agg_c, depth_head_n_feat if depth_head_enabled else 0),
            max(n_feat_scenepoint, agg_p, n_feat_scenepoint2global_agg or 0),
            max(n_feat_view, agg_c, n_feat_view2global_agg or 0), n_feat_global)
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
                d_emb if i == 0 else n_feat_proj, self.proj_out(i),
                n_feat_scenepoint, n_feat_view, n_feat_global,
                use_norm_proj_update=use_norm_proj_update,
                add_residual_skipconn_proj_update=add_residual_skipconn_proj_update,
                n_hidden_layers_proj_update=n_hidden_layers_proj_update,
                n_feat_skipconn_init_projfeat_in=(
                    d_emb if (i > 0 and add_skipconn_from_init_projfeat) else None),
                stateful=False if i == 0 else stateful_global_features,
                **common,
            )
            for i in range(num_layers)
        ])
        if depth_head_enabled:
            self.depth_head = MLPStack(
                [depth_head_n_feat] * (1 + depth_head_n_hidden_layers) + [1])
        else:
            self.final_global_update = GraphAttnGlobalFeatureUpdate(
                n_feat_proj, n_feat_scenepoint, n_feat_view, n_feat_global_out=n_feat_global,
                output_global=False, stateful=stateful_global_features, **common)
            out_ch = view_head_out_channels(calibrated, rot_representation)
            self.view_head = MLPStack([n_feat_view] * (1 + view_head_n_hidden_layers) + [out_ch])
            self.scenepoint_head = MLPStack(
                [n_feat_scenepoint] * (1 + scenepoint_head_n_hidden_layers) + [3])
        # float32 whatever torch's default dtype is: the kernels take float32
        # weights and tables (the edge streams alone may be bf16).
        self.to(torch.float32)
        if generator is not None:
            init_parameters(self, generator)

    @staticmethod
    def conf_kwargs(conf) -> dict:
        """The constructor's keyword arguments from a conf, read as the JAX
        package's ``GraphAttnSfMNet.from_conf`` reads them
        (``gasfm_tpu/models/gasfm.py:293-335``, reference
        graph_attn_sfm.py:9-41), with ``compile.stream_dtype``
        (:func:`stream_dtype_from_conf`) and ``model.remat_layers``."""
        return dict(
            num_layers=conf.get_int("model.num_layers"),
            n_heads=conf.get_int("model.n_heads"),
            n_feat_proj=conf.get_int("model.n_feat_proj"),
            n_feat_scenepoint=conf.get_int("model.n_feat_scenepoint"),
            n_feat_view=conf.get_int("model.n_feat_view"),
            n_feat_global=conf.get_int("model.n_feat_global"),
            calibrated=conf.get_bool("dataset.calibrated"),
            rot_representation=conf.get_string("model.view_head.rot_representation",
                                               default="quat"),
            normalize_output=conf.get_string("model.view_head.normalize_output", default=None),
            n_feat_proj2scenepoint_agg=conf.get_int("model.n_feat_proj2scenepoint_agg",
                                                    default=None),
            n_feat_proj2view_agg=conf.get_int("model.n_feat_proj2view_agg", default=None),
            n_feat_scenepoint2global_agg=conf.get_int("model.n_feat_scenepoint2global_agg",
                                                      default=None),
            n_feat_view2global_agg=conf.get_int("model.n_feat_view2global_agg", default=None),
            n_hidden_layers_scenepoint_update=conf.get_int(
                "model.n_hidden_layers_scenepoint_update"),
            n_hidden_layers_view_update=conf.get_int("model.n_hidden_layers_view_update"),
            n_hidden_layers_global_update=conf.get_int("model.n_hidden_layers_global_update"),
            n_hidden_layers_proj_update=conf.get_int("model.n_hidden_layers_proj_update"),
            pos_emb_n_freq=conf.get_int("model.pos_emb_n_freq"),
            use_norm_proj_update=conf.get_bool("model.use_norm_proj_update"),
            add_residual_skipconn_proj_update=conf.get_bool(
                "model.add_residual_skipconn_proj_update"),
            add_skipconn_from_init_projfeat=conf.get_bool("model.add_skipconn_from_init_projfeat"),
            stateful_global_features=conf.get_bool("model.stateful_global_features"),
            global2view_and_global2scenepoint_enabled=conf.get_bool(
                "model.global2view_and_global2scenepoint_enabled"),
            depth_head_enabled=conf.get_bool("model.depth_head.enabled", default=False),
            depth_head_n_feat=conf.get_int("model.depth_head.n_feat", default=128),
            depth_head_n_hidden_layers=conf.get_int("model.depth_head.n_hidden_layers",
                                                    default=2),
            view_head_enabled=conf.get_bool("model.view_head.enabled", default=False),
            view_head_n_hidden_layers=conf.get_int("model.view_head.n_hidden_layers", default=2),
            scenepoint_head_enabled=conf.get_bool("model.scenepoint_head.enabled", default=False),
            scenepoint_head_n_hidden_layers=conf.get_int("model.scenepoint_head.n_hidden_layers",
                                                         default=2),
            stream_dtype=stream_dtype_from_conf(conf),
            remat_layers=conf.get_bool("model.remat_layers", default=False),
        )

    @classmethod
    def from_conf(cls, conf, generator: Optional[torch.Generator] = None) -> "GraphAttnSfMNet":
        """Build from a conf (:meth:`conf_kwargs`), its weights drawn from
        ``generator``: the port's initializer, not JAX's PRNG bits (a JAX
        init carries over through ``models.convert.params_from_jax``)."""
        return cls(**cls.conf_kwargs(conf), generator=generator)

    def proj_out(self, i: int) -> int:
        """Layer i's output width: the depth head's for the last layer."""
        last = i == self.num_layers - 1
        return self.depth_head_n_feat if self.depth_head_enabled and last else self.n_feat_proj

    def merged_path(self, graph) -> bool:
        """Whether ``graph`` runs the merged path (the JAX package's packed
        layout gates, models/gasfm.py:93-100, with its ``packable`` width
        of exactly 32, ops/pallas/packing.py:63-70), else the unfused one."""
        return (self.use_norm_proj_update and self.n_hidden_layers_proj_update == 0
                and self.n_feat_proj == 32 and graph.num_cams <= DENSE_MAX_SEGMENTS)

    def layer_plan(self, graph) -> List[Tuple[bool, bool]]:
        """(merged, defer) per layer: the JAX package's per-layer plan
        (models/gasfm.py:110-160) with :meth:`merged_path` for its
        ``use_packed``. A merged layer runs the frontend or layer-step
        kernel; it defers its update into the next layer step, or
        materializes it through the projection-update kernel."""
        L, D = self.num_layers, self.n_feat_proj
        use_packed = self.merged_path(graph)
        final_raw = use_packed and L > 1 and not self.depth_head_enabled
        plan = []
        for i in range(L):
            first, last = i == 0, i == L - 1
            layer_packed = use_packed and not first and self.proj_out(i) == D
            next_packed = use_packed and not last and self.proj_out(i + 1) == D
            # the first layer defers its update (and its width adapter, in the
            # skip2 slot) when the update kernel takes its widths
            defer_first = (first and next_packed and self.proj_out(i) == D
                           and self.embed.d_out <= 32)
            defer = (layer_packed and (next_packed or (last and final_raw))) or defer_first
            plan.append((layer_packed or defer_first, defer))
        return plan

    def forward(self, graph, plain: bool = False) -> Dict[str, torch.Tensor]:
        """Predicted normalized cameras ``Ps_norm`` (m, 3, 4) and homogeneous
        points ``pts3D`` (4, n) for one scene graph, or with the depth head
        the per-edge ``depths`` (E,) in the graph's (point-major) edge order.
        ``plain=True`` runs the kernels' plain PyTorch versions whatever the
        device."""
        sd = self.stream_dtype
        e = self.embed(graph.uv)
        skip_init = e if self.add_skipconn_from_init_projfeat else None
        skip_merged = to_stream(skip_init, sd)  # the init skip a merged layer takes
        s = v = g = None
        remat = self.remat_layers and torch.is_grad_enabled()
        for i, (blk, (merged, defer)) in enumerate(zip(self.equivariant_blocks,
                                                       self.layer_plan(graph))):
            if isinstance(e, torch.Tensor) and not merged:  # an unfused layer: float32
                e = upcast(e)
            elif isinstance(e, torch.Tensor) and i > 0:  # a stream entering a merged layer
                e = to_stream(e, sd)
            args = (e, graph)
            kwargs = dict(
                prev_scenepoint_features=s if self.stateful else None,
                prev_view_features=v if self.stateful else None,
                prev_global_features=g if self.stateful else None,
                skipconn_init_projfeat=skip_merged if merged and i > 0 else skip_init,
                merged=merged, defer=defer, plain=plain, stream_dtype=sd,
            )
            if remat:
                # no random numbers in a layer: stashing the RNG state is not
                # needed, and is illegal while a CUDA graph records
                e, s, v, g = checkpoint(blk, *args, use_reentrant=False,
                                        preserve_rng_state=False, **kwargs)
            else:
                e, s, v, g = blk(*args, **kwargs)
        if isinstance(e, torch.Tensor):
            e = upcast(e)
        if self.depth_head_enabled:
            return {"depths": self.depth_head(e)[:, 0]}
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
