"""A run's weights, made on the device from the seed.

One draw of uniform numbers for all parameters, then per parameter the
initialization of the published models: a linear's weight and bias
uniform in +-1/sqrt(fan_in); GATv2's source and query linears and its
attention vectors Glorot-uniform with zero biases; LayerNorms ones and
zeros. A configuration may fix some parameters' values instead
(``fixed_weights``). The names and shapes are the reference model's, which
the program keeps too.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from benchmark.reference.gasfm import GraphConv


def _rules(model: nn.Module) -> Dict[str, tuple]:
    """name -> ("uniform", bound) | ("const", value)."""
    rules = {}
    for prefix, mod in model.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(mod, GraphConv):
            for lin in ("lin_l", "lin_r"):
                w = getattr(mod, lin).weight
                rules[f"{p}{lin}.weight"] = ("uniform", math.sqrt(6.0 / sum(w.shape)))
                rules[f"{p}{lin}.bias"] = ("const", 0.0)
            _, heads, per_head = mod.att.shape
            rules[f"{p}att"] = ("uniform", math.sqrt(6.0 / ((heads + 1) * per_head)))
            rules[f"{p}bias"] = ("const", 0.0)
        elif isinstance(mod, nn.LayerNorm):
            rules[f"{p}weight"] = ("const", 1.0)
            rules[f"{p}bias"] = ("const", 0.0)
        elif isinstance(mod, nn.Linear) and f"{p}weight" not in rules:
            bound = 1.0 / math.sqrt(mod.in_features)
            rules[f"{p}weight"] = ("uniform", bound)
            if mod.bias is not None:
                rules[f"{p}bias"] = ("uniform", bound)
    return rules


def make_weights(model: nn.Module, seed: int, device, fixed: Optional[dict] = None
                 ) -> Dict[str, torch.Tensor]:
    """The weights of ``model``'s parameters (a module on any device, the
    meta device too) for ``seed``, float32 on ``device``; ``fixed`` (the
    configuration's ``fixed_weights``) names parameters given as values."""
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    rules = _rules(model)
    missing = sorted(set(shapes) - set(rules))
    if missing:
        raise KeyError(f"no initialization rule for {missing[:5]}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        kind, value = rules[name]
        leaf = flat[at:at + n].view(shape)
        if fixed and name in fixed:
            leaf.copy_(torch.tensor(fixed[name], dtype=torch.float32).reshape(shape))
        elif kind == "uniform":
            leaf.mul_(value)
        else:
            leaf.fill_(value)
        out[name] = leaf
        at += n
    return out
