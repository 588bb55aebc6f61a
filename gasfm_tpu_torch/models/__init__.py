"""The models: GASFM's graph-attention network and DPESFM's set-of-sets
baseline, their layers and heads, weight conversion, and ``get_model``.

Counterpart of the JAX package's models/__init__.py: ``get_model`` builds
the model a conf's ``model.type`` names (reference main.py:134-136).
"""

from typing import Optional

import torch

from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.models.set_of_set import SetOfSetNet

_MODEL_REGISTRY = {
    # the reference's model.type strings, and the bare class names
    "graph_attn_sfm.GraphAttnSfMNet": GraphAttnSfMNet,
    "SetOfSet.SetOfSetNet": SetOfSetNet,
    "GraphAttnSfMNet": GraphAttnSfMNet,
    "SetOfSetNet": SetOfSetNet,
}


def get_model(conf, generator: Optional[torch.Generator] = None):
    """The model of ``model.type``, its weights drawn from ``generator``
    (left uninitialized without one)."""
    type_str = conf.get_string("model.type")
    if type_str not in _MODEL_REGISTRY:
        raise ValueError(f"Unknown model.type {type_str!r}; known: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[type_str].from_conf(conf, generator=generator)


__all__ = ["GraphAttnSfMNet", "SetOfSetNet", "get_model"]
