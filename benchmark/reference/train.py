"""The reference's first training steps: forward, ESFM loss, gradients,
their global norm, Adam with the schedule's rate, and our_repro of the
step's predictions, on one scene, from given weights.

``tf32`` runs the matrix products in TF32 (with ``dtype`` float32: the
control, the nearest precision below the configurations' float32).
``half_edges`` takes the loss over the first half of the observations only
(a fault that leaves half of the batch out and takes the mean over the
rest).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from benchmark.reference.adam import Adam, learning_rate
from benchmark.reference.loss import esfm_loss, our_repro


def model_class(path: str):
    """``"package.module:Class"`` -> the class."""
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[k].double() for k in names]))
    return dict(zip(names, norms.tolist()))


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def train_steps(config: dict, graph, weights: Dict[str, torch.Tensor], steps: int = 3,
                tf32: bool = False, half_edges: bool = False,
                dtype: torch.dtype = torch.float64) -> dict:
    """Per step the loss, our_repro and global gradient norm; the first
    gradient's norm per parameter; each parameter's change after the
    steps. ``weights`` is left as it was.

    The arithmetic (forward, loss, backward) runs in ``dtype``; the
    parameters and Adam's moments are kept in float32, as the
    configurations state, and each step's gradients reach Adam rounded to
    float32. So the float64 default reads the program's arithmetic against
    exact arithmetic, and its float32 storage against the same storage.
    ``dtype`` float32 with ``tf32`` is the control."""
    conf = config["conf"]
    if conf["loss"].get("grad_clip_mode") is not None:
        raise NotImplementedError("the reference takes no gradient clipping")
    set_tf32(tf32)
    try:
        with torch.device("meta"):
            model = model_class(config["reference"])(conf["model"])
        model = model.to_empty(device=graph.uv.device).to(dtype)
        names = [k for k, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        stored = [weights[k].detach().float().clone() for k in names]
        adam = Adam(stored)
        graph = graph.to(dtype)
        edges = slice(0, graph.num_edges // 2) if half_edges else None
        out: Dict[str, List[float]] = {"loss": [], "repro": [], "grad_norm": []}
        for t in range(steps):
            with torch.no_grad():
                for p, w in zip(params, stored):
                    p.copy_(w)
            pred = model(graph)
            loss = esfm_loss(pred, graph, conf["loss"], edges)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            if t == 0:
                out["grad_leaf"] = leaf_norms(dict(zip(names, grads)))
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            repro = our_repro({k: v.detach() for k, v in pred.items()}, graph)
            del pred
            adam.step([g.float() for g in grads], learning_rate(conf["train"], t))
            out["loss"].append(float(loss.detach()))
            out["repro"].append(float(repro))
            out["grad_norm"].append(float(norm))
        with torch.no_grad():
            out["change_leaf"] = leaf_norms({k: w - weights[k].float()
                                             for k, w in zip(names, stored)})
        return out
    finally:
        set_tf32(False)
