"""Weights carried across from the JAX package.

``params_from_jax`` maps the JAX package's flax parameters of
``GraphAttnSfMNet`` (nested dicts of numpy arrays, with or without the
top-level ``"params"`` key) onto the port's ``state_dict`` names, which are
the reference checkpoint's. Conventions translated:

- flax ``Dense`` kernels are (in, out); torch ``nn.Linear.weight`` is (out, in);
- flax LayerNorm ``scale`` is torch ``weight``;
- the GATv2 ``lin_l_kernel``/``lin_r_kernel`` become ``lin_l.weight`` /
  ``lin_r.weight``; ``att`` (H, C) becomes (1, H, C);
- ``MLPStack``'s ``TorchDense_k`` is the Sequential's index ``2k``;
- the aggregators' ``query_adapter`` / ``proj_agg`` take the reference's
  per-direction names.

Every flax leaf is mapped or the call raises; loading the result with
``load_state_dict(strict=True)`` then proves every port key was filled.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch

_LEAF = {
    "kernel": ("weight", True),
    "scale": ("weight", False),
    "bias": ("bias", False),
    "lin_l_kernel": ("lin_l.weight", True),
    "lin_l_bias": ("lin_l.bias", False),
    "lin_r_kernel": ("lin_r.weight", True),
    "lin_r_bias": ("lin_r.bias", False),
    "att": ("att", False),
    "prev_projfeat_norm_scale": ("prev_projfeat_norm_layer.weight", False),
    "prev_projfeat_norm_bias": ("prev_projfeat_norm_layer.bias", False),
}

# Module renames that depend on the parent module's name.
_IN_PARENT = {
    ("proj2view", "query_adapter"): "norm_and_proj_view2proj",
    ("proj2view", "proj_agg"): "proj_proj2view",
    ("proj2scenepoint", "query_adapter"): "norm_and_proj_scenepoint2proj",
    ("proj2scenepoint", "proj_agg"): "proj_proj2scenepoint",
    ("view_and_scenepoint2global", "query_adapter_view"): "norm_and_proj_global2view",
    ("view_and_scenepoint2global", "query_adapter_scenepoint"):
        "norm_and_proj_global2scenepoint",
    ("view_and_scenepoint2global", "proj_global"): "proj_view_and_scenepoint2global",
    ("projection_feature_update", "scenepoint_norm"): "scenepoint_norm_layer",
    ("projection_feature_update", "view_norm"): "view_norm_layer",
    ("projection_feature_update", "global_norm"): "global_norm_layer",
    ("global2view", "node_norm"): "view_norm_layer",
    ("global2view", "lin_node"): "lin_view",
    ("global2view", "global_norm"): "global_norm_layer",
    ("global2scenepoint", "node_norm"): "scenepoint_norm_layer",
    ("global2scenepoint", "lin_node"): "lin_scenepoint",
    ("global2scenepoint", "global_norm"): "global_norm_layer",
}


def _module_name(parent: str, name: str) -> str:
    if (parent, name) in _IN_PARENT:
        return _IN_PARENT[(parent, name)]
    if name.startswith("equivariant_blocks_"):
        return "equivariant_blocks." + name.rsplit("_", 1)[1]
    if name == "LayerNorm_0":
        return "0"
    if name.startswith("TorchDense_"):
        k = int(name.rsplit("_", 1)[1])
        return "2" if parent.startswith("query_adapter") else str(2 * k)
    if name == "residual_skipconn_proj_norm":
        return "residual_skipconn_proj_norm_layer"
    if name == "skip_projection":
        return "skip_projection.lin_proj"
    return name


def _torch_key(path: List[str]) -> Tuple[str, bool]:
    parts = []
    for i, name in enumerate(path[:-1]):
        parent = path[i - 1] if i else ""
        parts.append(_module_name(parent, name))
    leaf, transpose = _LEAF[path[-1]]
    return ".".join(parts + [leaf]), transpose


def params_from_jax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """flax params of the JAX ``GraphAttnSfMNet`` -> the port's state_dict."""
    tree = tree.get("params", tree)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + [k])
            return
        key, transpose = _torch_key(path)
        a = np.asarray(node, dtype=np.float32)
        if transpose:
            a = a.T
        if path[-1] == "att":
            a = a.reshape((1,) + a.shape)
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = torch.tensor(a)

    walk(tree, [])
    return out
