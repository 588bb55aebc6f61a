"""What the ranks of tests/test_torch_port_parallel.py run: the port's mesh
session on the CPU, one case after another, through
``gasfm_tpu_torch.parallel.run_ranks``. It imports neither JAX nor the JAX
package (the ranks stay clean of both); the test process compares what the
ranks return with the JAX package's step.

A case is a dict: ``model`` ("gasfm" or "dpesfm", its keyword arguments),
``state`` (the initial ``state_dict`` as numpy arrays), ``loss`` ("esfm" or
"depth", its keyword arguments), ``optim``, ``table_sharding`` (the
session's: None, on with more than one edge shard; False, replicated
tables), optionally ``rank_noise``
(rank r adds r x it to the weights before its session broadcasts rank
0's) — or ``conf``, a HOCON string that ``TrainingSession.from_conf``
takes (with its mesh) — then optionally ``mesh`` ((n_data, n_edge), another
layout of the same ranks), ``scenes``
(a group: each a dict of M, Ns, y and depths or None), ``steps`` and
``fused`` (the steps after the first through ``fused_group_step``, else
``group_loss_and_grads`` + ``update``; "all": the first one too) and
``evaluate`` (the index of a scene: :func:`evaluate_failing` and
:func:`evaluate_unfit` after the steps). Each rank
returns, per case: the first step's loss, gradients (by parameter name)
and predictions, with ``session.loss`` of those predictions (unless
"all"), with more than one data slot ``forward_group``'s predictions
first, every fused step's (loss, our_repro, n_valid, grad_norm) or later
loss, after each update a digest of its weights, and its final
``state_dict`` (bf16 as float32; with "all", also Adam's first moment
after the first step, 0.1 x its gradient). Each rank also runs its share of
the cases on a single-rank session (:func:`single_rank`), the reference of
the later steps.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from gasfm_tpu_torch.data.scene import SceneData
from gasfm_tpu_torch.losses import DirectDepthLoss, ESFMLoss
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
from gasfm_tpu_torch.train.loop import TrainingSession

MODELS = {"gasfm": GraphAttnSfMNet, "dpesfm": SetOfSetNet}
LOSSES = {"esfm": ESFMLoss, "depth": DirectDepthLoss}


def digest(model) -> str:
    """A digest of every parameter's bytes: equal digests, equal weights."""
    h = hashlib.sha256()
    for _, p in sorted(model.state_dict().items()):
        h.update(p.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host, bf16 as float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def scene_data(d, i=0):
    depths = d.get("depths")
    return SceneData(d["M"], d["Ns"], d["y"], f"scene{i}", calibrated=True,
                     store_depth_targets=depths is not None, depths=depths)


def make_session(case, mesh=None, device="cpu"):
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in case["state"].items()}
    if mesh is not None and case.get("rank_noise"):  # each rank starts from its own weights
        state = {k: v + mesh.rank * case["rank_noise"] if v.is_floating_point() else v
                 for k, v in state.items()}
    if "conf" in case:
        from gasfm_tpu_torch.config import ConfigFactory
        from gasfm_tpu_torch.models import get_model

        conf = ConfigFactory.parse_string(case["conf"])
        model = get_model(conf)
        model.load_state_dict(state)
        return TrainingSession.from_conf(conf, model, device=device, mesh=mesh)
    name, kw = case["model"]
    model = MODELS[name](**kw)
    model.load_state_dict(state)
    loss_name, loss_kw = case["loss"]
    return TrainingSession(model, LOSSES[loss_name](**loss_kw), device=device,
                           optim=case["optim"], mesh=mesh,
                           table_sharding=case.get("table_sharding"))


def run_case(session, case):
    """The case on ``session`` (with a mesh or not); the result dict."""
    datas = [scene_data(d, i) for i, d in enumerate(case["scenes"])]
    names = [k for k, p in session.model.named_parameters() if p.requires_grad]
    out = dict(steps=[], digests=[])
    if session.mesh.n_data > 1:  # each slot's scene's predictions, shared
        out["group_pred"] = [{k: host(v) for k, v in pred.items()}
                             for pred in session.forward_group(datas)]
    steps = case["steps"]
    if case["fused"] != "all":
        loss, pred, grads = session.group_loss_and_grads(datas)
        slot = 0 if session.mesh is None else min(session.mesh.data_slot, len(datas) - 1)
        out.update(loss=float(loss), grads={k: host(g) for k, g in zip(names, grads)},
                   pred={k: host(v) for k, v in pred.items()},
                   pred_loss=float(session.loss(pred, session.scene_graph(datas[slot]))))
        session.update(grads)
        out["digests"].append(digest(session.model))
        steps -= 1
    for _ in range(steps):
        if case["fused"]:
            vals = session.fused_group_step(datas)
            out["steps"].append([float(v) for v in vals])
        else:
            loss, _, grads = session.group_loss_and_grads(datas)
            session.update(grads)
            out["steps"].append([float(loss)])
        out["digests"].append(digest(session.model))
        if case["fused"] == "all" and "mu" not in out:
            state = session.optimizer.adam.state
            out["mu"] = {k: state[p]["exp_avg"].cpu().numpy()
                         for k, p in zip(names, session.params)}
    out["state"] = {k: host(v) for k, v in session.model.state_dict().items()}
    return out


def evaluate_failing(session, case):
    """``epoch_evaluation`` of the case's scenes (batches of one, no BA,
    ``crash_on_scene_exhausting_memory=False``), then again with the graph
    of scene ``case["evaluate"]`` running the device out of memory on the
    last rank alone: rank 0's two tables' rows, None on the other ranks."""
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.train.loop import epoch_evaluation
    from gasfm_tpu_torch.utils.phases import Phases

    conf = load_config("synth/learning_synth_gasfm.conf")
    datas = [scene_data(d, i) for i, d in enumerate(case["scenes"])]

    def run():
        table = epoch_evaluation([[d] for d in datas], session, None, conf, 0,
                                 Phases.VALIDATION, bundle_adjustment=False,
                                 crash_on_scene_exhausting_memory=False)
        return None if table is None else table.rows

    clean = run()
    if session.mesh.rank == session.mesh.size - 1:
        make = session.scene_graph

        def scene_graph(data):
            if data is datas[case["evaluate"]]:
                raise torch.cuda.OutOfMemoryError("out of memory on this rank alone")
            return make(data)

        session.scene_graph = scene_graph
    return clean, run()


def evaluate_unfit(session, case):
    """``epoch_evaluation`` of the case's scenes twice over (scene0 to
    scene3 on [2, 1]: two groups; no BA, ``crash_on_scene_exhausting_memory=False``),
    then again with the reservation of the last scene's forward
    (``TrainingSession.reserve_forward``) running the device out of memory
    on the last rank alone: rank 0's two tables' rows, None on the other
    ranks."""
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.train.loop import epoch_evaluation
    from gasfm_tpu_torch.utils.phases import Phases

    conf = load_config("synth/learning_synth_gasfm.conf")
    datas = [scene_data(d, i) for i, d in enumerate(case["scenes"] * 2)]

    def run():
        table = epoch_evaluation([[d] for d in datas], session, None, conf, 0,
                                 Phases.VALIDATION, bundle_adjustment=False,
                                 crash_on_scene_exhausting_memory=False)
        return None if table is None else table.rows

    clean = run()
    if session.mesh.rank == session.mesh.size - 1:
        reserve, last = session.reserve_forward, session.scene_graph(datas[-1])

        def reserve_forward(scene):
            if scene is last:
                raise torch.cuda.OutOfMemoryError("the forward would not fit on this rank")
            return reserve(scene)

        session.reserve_forward = reserve_forward
    return clean, run()


def single_rank(case):
    """The case's group on a single-rank session: per step (the sum of the
    scenes' losses, of their our_repro, the gradient norm), the scenes'
    gradients accumulated (the JAX package's accumulate path), and each
    scene's predictions before any update."""
    session = make_session(case)
    datas = [scene_data(d, i) for i, d in enumerate(case["scenes"])]
    graphs = [session.scene_graph(d) for d in datas]
    preds0 = [{k: host(v) for k, v in session.forward(g).items()} for g in graphs]
    steps = []
    for _ in range(case["steps"]):
        total, repro, grads = 0.0, 0.0, None
        for sg in graphs:
            loss, pred, g = session.loss_and_grads(sg)
            total += float(loss)
            if not session.model.depth_head_enabled:
                repro += float(session.our_repro(pred, sg))
            grads = g if grads is None else session.accumulate(grads, g)
        steps.append((total, repro, float(session.update(grads))))
    return dict(steps=steps, preds0=preds0)


def run_cases(mesh, cases, references=()):
    """A rank's results of every case on the mesh, then the single-rank
    references of the cases ``references`` names that fall to this rank
    (every ``mesh.size``-th from its rank), and whether it stayed clean of
    JAX and the JAX package: ``run_ranks``' function."""
    from gasfm_tpu_torch.parallel import make_mesh

    results = []
    for case in cases:  # a case's own layout of the same ranks ([2, 1] of [1, 2]'s)
        on = make_mesh(*case["mesh"], mesh.device) if "mesh" in case else mesh
        session = make_session(case, on, on.device)
        results.append(run_case(session, case))
        if "evaluate" in case:
            results[-1]["evaluation"] = evaluate_failing(session, case)
            results[-1]["unfit"] = evaluate_unfit(session, case)
    mine = list(references)[mesh.rank::mesh.size]
    refs = {i: single_rank(cases[i]) for i in mine}
    clean = not any(m.split(".")[0] in ("jax", "jaxlib", "gasfm_tpu") for m in sys.modules)
    return results, refs, clean


# ---------------------------------------------------------------------------
# multi-host: launcher processes of their own (tests/test_torch_port_multihost.py)
# ---------------------------------------------------------------------------


def layout(mesh):
    """A rank's place: its global rank, data slot, edge shard and the
    process id of the launcher that spawned it."""
    import os

    return dict(rank=mesh.rank, data_slot=mesh.data_slot, edge_shard=mesh.edge_shard,
                launcher=os.getppid())


def multihost_cases(mesh, cases):
    """A rank's :func:`layout` and its results of every case
    (:func:`run_cases`)."""
    return layout(mesh), run_cases(mesh, cases)[0]


def raise_on(mesh, rank):
    """Rank ``rank`` raises; the others wait for it in an all-reduce over
    the world."""
    import torch.distributed as dist

    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return mesh.rank


def launcher_main(call_path):
    """One launcher process: ``run_ranks`` of the call in ``call_path``
    (fn, n_data, n_edge, args, the host's ``Distributed``) on the CPU; its
    ranks' results, or its error's text, into ``call_path`` + ".out"."""
    from gasfm_tpu_torch.parallel import run_ranks

    fn, n_data, n_edge, args, spec = torch.load(call_path, weights_only=False)
    try:
        out = ("ok", run_ranks(fn, n_data, n_edge, args=args, device="cpu", distributed=spec))
    except Exception as e:  # noqa: BLE001 - the test reads the error's text
        out = ("error", str(e))
    torch.save(out, call_path + ".out")
    return 0 if out[0] == "ok" else 1
