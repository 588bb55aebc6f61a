"""Weights carried across from the JAX package.

``params_from_jax`` maps the JAX package's flax parameters of
``GraphAttnSfMNet`` or ``SetOfSetNet`` (nested dicts of numpy arrays, with
or without the top-level ``"params"`` key) onto the port's ``state_dict``
names, which are the reference checkpoint's. Conventions translated:

- flax ``Dense`` kernels are (in, out); torch ``nn.Linear.weight`` is (out, in);
- flax LayerNorm ``scale`` is torch ``weight``;
- the GATv2 ``lin_l_kernel``/``lin_r_kernel`` become ``lin_l.weight`` /
  ``lin_r.weight``; ``att`` (H, C) becomes (1, H, C);
- ``MLPStack``'s ``TorchDense_k`` is the Sequential's index ``2k``;
- the aggregators' ``query_adapter`` / ``proj_agg`` take the reference's
  per-direction names;
- a set-of-sets block's ``layers_{j}`` is ``layers.{j}``, and its edge
  linear ``layers_{j}/lin_proj`` is
  ``layers.{j}.projection_feature_update.lin_proj``.

Every flax leaf is mapped or the call raises; loading the result with
``load_state_dict(strict=True)`` then proves every port key was filled.

bf16 leaves (the JAX package's weights under ``train.param_dtype = bf16``:
``ml_dtypes`` bfloat16 arrays, which ``np.savez`` stores as ``|V2``, raw
bfloat16 bits) become torch bfloat16 tensors and back, through an int16 view
of their bits: the port has no ``ml_dtypes``.

``params_to_jax`` is its inverse: the port's ``state_dict`` as flat flax key
paths (``"/"``-joined, as the JAX package's ``save_params`` writes them) in
flax's layouts; each key is mapped back through ``params_from_jax``'s own
rule and raises unless it comes out as the key it started from.
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
    "pts_3d": ("pts_3d", False),  # Parameter3DPts
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
    if name.startswith(("equivariant_blocks_", "layers_")):
        return name.rsplit("_", 1)[0] + "." + name.rsplit("_", 1)[1]
    if name == "lin_proj" and parent.startswith("layers_"):
        return "projection_feature_update.lin_proj"
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


def _is_bf16_bits(a: np.ndarray) -> bool:
    """An ``ml_dtypes`` bfloat16 array, or the ``|V2`` array an npz gives
    back for one."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2 and not a.dtype.names


def params_from_jax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """flax params of the JAX ``GraphAttnSfMNet`` or ``SetOfSetNet`` -> the
    port's state_dict."""
    tree = tree.get("params", tree)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + [k])
            return
        key, transpose = _torch_key(path)
        a = np.asarray(node)
        bf16 = _is_bf16_bits(a)
        a = a.view(np.int16) if bf16 else a.astype(np.float32)
        if transpose:
            a = a.T
        if path[-1] == "att":
            a = a.reshape((1,) + a.shape)
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        t = torch.tensor(a)
        out[key] = t.view(torch.bfloat16) if bf16 else t

    walk(tree, [])
    return out


# The inverse renames: (flax parent, torch name) -> flax name, and the leaves
# that span two torch names.
_IN_PARENT_BACK = {(parent, torch_name): flax_name
                   for (parent, flax_name), torch_name in _IN_PARENT.items()}
_LEAF_BACK = {torch_name: flax_name for flax_name, (torch_name, _) in _LEAF.items()
              if "." in torch_name}


def _flax_path(key: str, ndim: int) -> List[str]:
    """The flax key path of the port's state_dict key ``key`` (a tensor of
    ``ndim`` dimensions)."""
    parts = key.split(".")
    if ".".join(parts[-2:]) in _LEAF_BACK:
        leaf, parts = _LEAF_BACK[".".join(parts[-2:])], parts[:-2]
    else:
        leaf, parts = parts[-1], parts[:-1]
        if leaf == "weight":
            leaf = "kernel" if ndim == 2 else "scale"
    path: List[str] = []
    i = 0
    while i < len(parts):
        parent, name = (path[-1] if path else ""), parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        step = 1
        if (parent, name) in _IN_PARENT_BACK:
            name = _IN_PARENT_BACK[(parent, name)]
        elif name in ("equivariant_blocks", "layers") and nxt is not None and nxt.isdigit():
            name, step = f"{name}_{nxt}", 2
        elif name == "projection_feature_update" and nxt == "lin_proj" \
                and parent.startswith("layers_"):
            name, step = "lin_proj", 2
        elif name == "skip_projection" and nxt == "lin_proj":
            step = 2
        elif name.isdigit():
            k = int(name)
            if parent.startswith("query_adapter"):
                name = "LayerNorm_0" if k == 0 else "TorchDense_0"
            else:
                name = f"TorchDense_{k // 2}"
        elif name == "residual_skipconn_proj_norm_layer":
            name = "residual_skipconn_proj_norm"
        path.append(name)
        i += step
    return path + [leaf]


def params_to_jax(state_dict) -> "OrderedDict[str, np.ndarray]":
    """The port's ``state_dict`` -> {flax key path joined by "/": array in
    flax's layout}, without the top-level ``"params"``; a bf16 tensor
    becomes a ``|V2`` array of its bits (what ``np.savez`` stores of an
    ``ml_dtypes`` bfloat16 array)."""
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for key, t in state_dict.items():
        t = t.detach().cpu()
        bf16 = t.dtype == torch.bfloat16
        a = t.contiguous().view(torch.int16).numpy() if bf16 else t.numpy().astype(np.float32)
        path = _flax_path(key, a.ndim)
        back, transpose = _torch_key(path)
        if back != key:
            raise ValueError(f"{key}: maps to flax {'/'.join(path)}, which maps back to {back}")
        if transpose:
            a = a.T
        if path[-1] == "att":
            a = a.reshape(a.shape[1:])
        a = np.ascontiguousarray(a)
        out["/".join(path)] = a.view("V2") if bf16 else a
    return out
