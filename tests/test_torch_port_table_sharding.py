"""Table sharding on an edge mesh (``parallel.table_sharding`` null or true,
the JAX package's default with more than one edge shard) and multi-scene
learning on a mesh, on the CPU, against the JAX package.

The ranks are gloo processes spawned by the port's launcher
(``gasfm_tpu_torch.parallel.run_ranks``); they run
tests/torch_port_mesh_ranks.py, which imports no JAX. The file spawns three
times: four ranks (``[1, 4]``), two ranks (``[1, 2]``, and ``[2, 1]`` as
another layout of the same ranks) and the CLI under ``[2, 1]``.

- The host half: each shard's boundary points and owned points
  (``graph.view_graph.table_shard``): the owned ranges cover every point
  exactly once, points without edges too, for 2, 3 and 4 shards; the
  boundary ids and their sharing; the span contract
  (``parallel.check_table_shard_contract``) refuses a hub point over three
  shards and a scene with too few edges. The exchange's merge
  (``ops/attn_combine.py``) against the whole scene's softmax on a graph
  where a shard's first point is its last, the kernels' side (forward and
  backward) with the collective replaced by the sum of the shards' slabs.
- ``[1, 4]`` and ``[1, 2]`` with table sharding null, the four models of
  tests/test_torch_port_parallel.py (the flagship-shaped merged GASFM, the
  unfused 16-wide GASFM, DPESFM, the depth head): the first step's loss
  and every gradient against the JAX package's single-device step; the
  predictions (``pts3D`` put together over the edge group, ``Ps_norm``,
  the depths) whole on every rank and equal to the single-rank forward's;
  the weights bitwise equal across the ranks after every update; the later
  steps' losses against the single-rank port. These run the plain path's
  exchange (``ops/gatv2.py``). Tolerances of that file.
- The JAX package's own table-sharded step (tests/test_parallel.py's
  ``TestTableSharding`` scene: 12 views, 256 points, seed 3, ``[1, 4]``,
  interpret mode, on the conftest's CPU mesh) against the port's ``[1, 4]``
  ranks from the same weights (the port's init carried by the converter).
- ``parallel.table_sharding = true`` on ``[2, 1]``: bitwise the same run as
  ``false`` (one edge shard: nothing to shard).
- The grouped evaluation on ``[2, 1]`` under
  ``crash_on_scene_exhausting_memory=False``, a failure faked on rank 1
  alone: a graph that runs out of memory gets its scene's row of NaNs, a
  forward whose reservation runs out of memory its group's rows, on every
  rank, and the run goes on.
- The CLI: ``multi-scene-learning`` under ``[2, 1]`` (batches of two sampled
  scenes: one ``fused_group_step`` per batch, grouped evaluations) for 2
  epochs writes one tree; its first epoch's losses match the single-rank
  CLI's at the same seeds (rtol 2e-4), and its evaluation rows the
  single-rank evaluation's for ``our_repro``, ``t_err_mean`` and
  ``R_err_mean`` (rtol 5e-3, atol 1e-3: tests/test_parallel.py's bounds for
  the JAX package's grouped evaluation).
"""

import concurrent.futures
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.config import ConfigFactory as JaxConfigFactory
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.models.convert import convert_reference_state_dict

import torch_port_mesh_ranks as R
from test_parallel import CONF as TS_CONF
from test_torch_port_cli import scalars
from test_torch_port_parallel import CASES, assert_grads_close, case_of, jax_step, scene
from gasfm_tpu_torch.graph.view_graph import (build_host_scene_graph, point_spans,
                                              shard_host_graph, table_shard)
from gasfm_tpu_torch.ops import attn_combine as ac
from gasfm_tpu_torch.parallel import check_table_shard_contract, run_ranks

MESHES = {"1x4": (1, 4), "1x2": (1, 2)}
STEPS_TS = 3  # the first step, then two
TS_MESH = "\nparallel { mesh_shape = [1, 4], table_sharding = true }\n"
CLI_ARGS = ["multi-scene-learning", "--conf", "synth/learning_synth_gasfm.conf", "--device",
            "cpu", "--external-params", "train.n_epochs=2", "eval.eval_interval=1",
            "train.finetune_n_epochs=1", "dataset.batch_size=2"]


def jax_ts_case():
    """tests/test_parallel.py's TestTableSharding model and scene, from the
    port's init: the ranks' case, and the JAX side's conf, scene and the
    same weights as a flax tree."""
    from gasfm_tpu_torch.config import ConfigFactory
    from gasfm_tpu_torch.models import get_model

    data = jax_synthetic_scene(n_views=12, n_points=256, seed=3)
    model = get_model(ConfigFactory.parse_string(TS_CONF + TS_MESH),
                      generator=torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params = convert_reference_state_dict(state, "graph_attn_sfm.GraphAttnSfMNet")
    case = dict(conf=TS_CONF + TS_MESH, state=state, steps=1, fused=False,
                scenes=[dict(M=data.M, Ns=data.Ns, y=data.y)])
    return case, (JaxConfigFactory.parse_string(TS_CONF + TS_MESH), data, params)


class _Runs:
    """The file's three spawns, each on a thread of its own from the first
    test that asks, while the JAX package's
    steps run in this process: ``get(mesh)`` waits and returns (the cases
    by name, each rank's results by name, the single-rank references by
    name, made by the [1, 4] ranks); ``cli`` is the CLI runs' future."""

    def __init__(self, results_dir):
        self.cases = {mesh: {name: dict(case_of(name, 1), table_sharding=None, steps=STEPS_TS)
                             for name in CASES} for mesh in MESHES}
        self.cases["1x4"]["jax_ts"], self.jax_ts = jax_ts_case()
        for ts in (True, False):
            self.cases["1x2"][f"2x1_{ts}"] = dict(case_of("merged", 2), mesh=(2, 1),
                                                  table_sharding=ts, steps=STEPS_TS)
        self.cases["1x2"]["2x1_False"]["evaluate"] = 1
        self.pool = concurrent.futures.ThreadPoolExecutor(3)
        self.futures = {"1x4": self.pool.submit(self._spawn, "1x4")}
        self.cli_dir = results_dir
        self.cli = self.pool.submit(self._cli, results_dir)
        self.futures["1x2"] = self.pool.submit(self._spawn, "1x2")

    @staticmethod
    def _cli(results_dir):
        """The learning CLI under [2, 1] (exp dir "mesh"), then on one rank
        ("single", on one intra-op thread), into ``results_dir``; their exit
        codes."""
        from gasfm_tpu_torch.main import main

        before = os.environ.get("GASFM_RESULTS_PATH")
        os.environ["GASFM_RESULTS_PATH"] = str(results_dir)
        torch.set_num_threads(1)
        try:
            return [main(CLI_ARGS[:5] + ["--exp-dir", name] + CLI_ARGS[5:] + extra)
                    for name, extra in (("mesh", ["parallel.mesh_shape=[2,1]"]),
                                        ("single", []))]
        finally:
            if before is None:
                del os.environ["GASFM_RESULTS_PATH"]
            else:
                os.environ["GASFM_RESULTS_PATH"] = before

    def _spawn(self, mesh):
        refs = [i for i, name in enumerate(self.cases[mesh]) if name in CASES and mesh == "1x4"]
        return run_ranks(R.run_cases, *MESHES[mesh], args=(list(self.cases[mesh].values()), refs),
                         device="cpu")

    def _results(self, mesh):
        names = list(self.cases[mesh])
        ranks = self.futures[mesh].result()
        assert all(clean for _, _, clean in ranks), "a rank imported JAX"
        results = [dict(zip(names, res)) for res, _, _ in ranks]
        refs = {names[i]: ref for _, part, _ in ranks for i, ref in part.items()}
        return results, refs

    def get(self, mesh):
        results, refs = self._results(mesh)
        return self.cases[mesh], results, refs if mesh == "1x4" else self._results("1x4")[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("ts_cli"))
    yield r
    r.pool.shutdown()


# ---------------------------------------------------------------------------
# the host half: boundary and owned points, the contract
# ---------------------------------------------------------------------------


def scene_with_empty_points():
    """tests/test_torch_port_parallel.py's scene with five points seen in no
    view: the first, two inside, the last two (position E)."""
    s = scene(3)
    M = s["M"].copy()
    M[:, [0, 40, 41, 148, 149]] = 0.0
    return build_host_scene_graph(M, s["Ns"], s["y"])


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_owned_points_cover_every_point_once(n_shards):
    host = scene_with_empty_points()
    ptr, pt_idx = host.pt_ptr.astype(np.int64), host.pt_idx
    n, E = ptr.shape[0] - 1, int(ptr[-1])
    assert (np.diff(ptr) == 0).sum() == 5
    owners, spans = np.zeros(n, dtype=int), np.zeros(n, dtype=int)
    for k in range(n_shards):
        sh = shard_host_graph(host, k, n_shards)
        ts = sh.table_shard
        assert ts == table_shard(host.pt_ptr, pt_idx, k, n_shards)
        lo, hi = sh.edge_offset, sh.edge_offset + sh.cam_idx.shape[0]
        owners[ts.own_lo:ts.own_hi] += 1
        # point p is owned by the shard whose edge range holds pt_ptr[p]
        for p in range(ts.own_lo, ts.own_hi):
            assert lo <= ptr[p] < hi or (k == n_shards - 1 and ptr[p] == E)
        # the boundary points and whether a neighbour shares each
        assert (ts.first, ts.last) == (pt_idx[lo], pt_idx[hi - 1])
        assert ts.shared_left == (k > 0 and pt_idx[lo - 1] == ts.first)
        assert ts.shared_right == (hi < E and pt_idx[hi] == ts.last)
        # a shard's touched points lie in [first, last]; it owns them but a
        # first point shared with the left
        touched = np.unique(sh.pt_idx)
        assert touched.min() == ts.first and touched.max() == ts.last
        owned_touched = touched[(touched >= ts.own_lo) & (touched < ts.own_hi)]
        want = touched[1:] if ts.shared_left else touched
        np.testing.assert_array_equal(owned_touched, want)
        spans[touched] += 1
    np.testing.assert_array_equal(owners, np.ones(n))
    # the contract's count: the shards whose edges touch each point
    np.testing.assert_array_equal(point_spans(host.pt_ptr, n_shards), spans)


def hub_ptr(degrees):
    ptr = np.zeros(len(degrees) + 1, dtype=np.int32)
    np.cumsum(degrees, out=ptr[1:])
    return ptr, np.repeat(np.arange(len(degrees)), degrees).astype(np.int32)


def test_shard_whose_first_point_is_its_last():
    """Points of 6 and 6 edges over three shards of 4: the first shard lies
    inside point 0, the last inside point 1 and owns no point (point 1's
    first edge is the middle shard's), the middle one shares both."""
    ptr, pt_idx = hub_ptr([6, 6])
    check_table_shard_contract(ptr, 3)
    got = [table_shard(ptr, pt_idx, k, 3) for k in range(3)]
    assert [(t.first, t.last, t.shared_left, t.shared_right) for t in got] == [
        (0, 0, False, True), (0, 1, True, True), (1, 1, True, False)]
    assert [(t.own_lo, t.own_hi) for t in got] == [(0, 1), (1, 2), (2, 2)]


def test_span_contract():
    ptr, _ = hub_ptr([2, 12, 2, 2])  # point 1 over edges 2..13: shards 0-2 of 4 (5 each)
    with pytest.raises(ValueError, match="span<=2"):
        check_table_shard_contract(ptr, 4)
    check_table_shard_contract(ptr, 2)
    with pytest.raises(ValueError, match="span<=2"):  # too few edges for the shards
        check_table_shard_contract(hub_ptr([2, 1])[0], 4)
    s = scene(3)
    host = build_host_scene_graph(s["M"], s["Ns"], s["y"])
    check_table_shard_contract(host.pt_ptr, 4)
    with pytest.raises(ValueError, match="span<=2"):  # shards of 4 edges: points of 8 span 3
        check_table_shard_contract(host.pt_ptr, host.cam_idx.shape[0] // 4)


# ---------------------------------------------------------------------------
# the exchange on the host: the merge, and the kernels' side
# ---------------------------------------------------------------------------

H, C = 2, 3


def local_triples(pt_idx, logits, xl, lo, hi, n):
    """A shard's per-point (num, m, den) over edges [lo, hi): float64."""
    m = torch.full((n, H), float("-inf"), dtype=torch.float64)
    ids = torch.as_tensor(pt_idx[lo:hi]).long()
    m = m.scatter_reduce(0, ids[:, None].expand(-1, H), logits[lo:hi], "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits[lo:hi] - m[ids])
    den = torch.zeros((n, H), dtype=torch.float64).index_add(0, ids, p)
    num = torch.zeros((n, H * C), dtype=torch.float64).index_add(
        0, ids, (p[:, :, None] * xl[lo:hi].reshape(-1, H, C)).reshape(-1, H * C))
    return num, m, den


def fake_collective(monkeypatch, summed):
    """Replace the exchange's all-reduce by ``summed``, the slab summed over
    the shards (the first call of each shard records its slab)."""
    seen = []

    def collective(tensors, group, op=None, src=None):
        seen.append(tensors[0])
        return [summed[0] if summed else tensors[0]] + list(tensors[1:])

    monkeypatch.setattr(ac, "flat_collective", collective)
    return seen


@pytest.mark.parametrize("degrees", [[6, 6], [3, 5, 1, 7, 2]])
def test_boundary_exchange_matches_whole_scene(degrees, monkeypatch):
    """Three shards: each shard's triples, merged through the sum of the
    shards' slabs, are the whole scene's on every point it touches; the
    kernels' side (``exchange_points``, normalized outputs) gives the whole
    scene's outputs there, and its backward (``exchange_cotangents``) the
    sum of the shards' cotangents on the two boundary points."""
    ptr, pt_idx = hub_ptr(degrees)
    n, E, S = len(degrees), int(ptr[-1]), 3
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(E, H, generator=gen, dtype=torch.float64) * 3
    xl = torch.randn(E, H * C, generator=gen, dtype=torch.float64)
    num_w, m_w, den_w = local_triples(pt_idx, logits, xl, 0, E, n)
    out_w = (num_w.reshape(n, H, C) / den_w[:, :, None]).reshape(n, H * C)
    shards = [table_shard(ptr, pt_idx, k, S) for k in range(S)]
    per = -(-E // S)
    local = [local_triples(pt_idx, logits, xl, k * per, min(E, (k + 1) * per), n)
             for k in range(S)]
    ends = [tuple(ac.end_rows(t, sh) for t in loc) for loc, sh in zip(local, shards)]
    slab = sum(ac.boundary_slab(*e, sh) for e, sh in zip(ends, shards))
    for k, (sh, e, loc) in enumerate(zip(shards, ends, local)):
        touched = np.unique(pt_idx[k * per:min(E, (k + 1) * per)])
        num_e, m_e, den_e = ac.merge_ends(*e, slab, sh, H)
        num = ac.put_ends(loc[0].clone(), num_e, sh)
        den = ac.put_ends(loc[2].clone(), den_e, sh)
        m = ac.put_ends(loc[1].clone(), m_e, sh)
        out = (num.reshape(n, H, C) / den[:, :, None]).reshape(n, H * C)
        torch.testing.assert_close(out[touched], out_w[touched], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(m[touched], m_w[touched], rtol=0, atol=0)
    # the kernels' side: normalized outputs (0 where a shard has no edge)
    outs = [((loc[0].reshape(n, H, C) / loc[2].clamp_min(1e-300)[:, :, None]).reshape(n, H * C),
             loc[1], loc[2]) for loc in local]
    summed = []
    seen = fake_collective(monkeypatch, summed)
    for sh, o in zip(shards, outs):
        ac.exchange_points(o, sh, None, H)
    summed.append(sum(seen))
    g = [torch.randn(n, H * C, generator=gen, dtype=torch.float64) for _ in range(S)]
    for k, (sh, o) in enumerate(zip(shards, outs)):
        touched = np.unique(pt_idx[k * per:min(E, (k + 1) * per)])
        (out, _, den), _ = ac.exchange_points(tuple(t.clone() for t in o), sh, None, H)
        torch.testing.assert_close(out[touched], out_w[touched], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(den[touched], den_w[touched], rtol=1e-12, atol=1e-12)
    seen.clear()
    summed.clear()
    for sh, gk in zip(shards, g):
        ac.exchange_cotangents(gk, sh, None)
    summed.append(sum(seen))
    for k, (sh, gk) in enumerate(zip(shards, g)):
        got, _ = ac.exchange_cotangents(gk, sh, None)
        for p in {sh.first, sh.last}:
            want = sum(g[j][p] for j in range(S)
                       if p in pt_idx[j * per:min(E, (j + 1) * per)])
            torch.testing.assert_close(got[p], want, rtol=1e-12, atol=1e-12)
        inner = [p for p in range(n) if p not in (sh.first, sh.last)]
        torch.testing.assert_close(got[inner], gk[inner], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the table-sharded step against the JAX package
# ---------------------------------------------------------------------------


def first_step_matches_jax(runs, mesh, name):
    case = runs.cases[mesh][name]
    want_loss, want, type_str = jax_step(name, case)
    _, results, _ = runs.get(mesh)
    for rank, res in enumerate(results):
        got = res[name]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=2e-5, err_msg=f"rank {rank}")
        assert_grads_close(got["grads"], want, type_str, f"rank {rank}: grad of")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_first_step_matches_jax(runs, mesh, name):
    first_step_matches_jax(runs, mesh, name)


def test_jax_table_sharded_step_matches_the_port(runs):
    """The JAX package's table-sharded step (``edge_partitioned`` +
    ``table_sharded(compute_owned_points(...))`` in a ``shard_map`` over 4
    of the conftest's CPU devices, interpret mode) against the port's
    ``[1, 4]`` ranks from the same weights: the loss and every gradient."""
    from jax.sharding import PartitionSpec as P

    from gasfm_tpu.graph.view_graph import CHUNK
    from gasfm_tpu.losses import get_loss_func
    from gasfm_tpu.models import get_model
    from gasfm_tpu.ops import segment as seg
    from gasfm_tpu.ops.segment import edge_partitioned, table_sharded
    from gasfm_tpu.parallel import (EDGE_AXIS, compute_owned_points, make_mesh,
                                    scene_graph_specs, stack_scene_graphs)

    conf, data, params = runs.jax_ts
    model, loss_func = get_model(conf), get_loss_func(conf)
    sg = data.to_scene_graph(caps=(16, 256, 4 * CHUNK))

    def per_device(p, sc):
        sc = jax.tree_util.tree_map(lambda x: x[0], sc)
        with edge_partitioned(EDGE_AXIS), table_sharded(compute_owned_points(sc.graph,
                                                                             EDGE_AXIS)):
            loss, grads = jax.value_and_grad(
                lambda q: loss_func(model.apply(q, sc.graph), sc))(p)
        return loss, jax.lax.psum(grads, EDGE_AXIS)

    seg.set_kernel_mode("interpret")
    try:
        sharded = jax.shard_map(per_device, mesh=make_mesh(n_edge=4, n_data=1),
                                in_specs=(P(), scene_graph_specs(batched=True)),
                                out_specs=(P(), P()), check_vma=False)
        loss, grads = jax.jit(sharded)(jax.tree_util.tree_map(jnp.array, params),
                                       stack_scene_graphs([sg]))
    finally:
        seg.set_kernel_mode("auto")
    _, results, _ = runs.get("1x4")
    for rank, res in enumerate(results):
        got = res["jax_ts"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=2e-5, err_msg=f"rank {rank}")
        assert_grads_close(got["grads"], grads, "graph_attn_sfm.GraphAttnSfMNet",
                           f"rank {rank}: grad of")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_predictions_whole_on_every_rank(runs, mesh, name):
    """The first step's predictions, put together on every rank (the owned
    columns of ``pts3D`` summed over the edge group), against the
    single-rank port's forward before any update, every point and camera;
    ``session.loss`` of them on the mesh, the scene's loss."""
    _, results, refs = runs.get(mesh)
    want = refs[name]["preds0"][0]
    for res in results:
        pred = res[name]["pred"]
        assert sorted(pred) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(pred[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(res[name]["pred_loss"], res[name]["loss"], rtol=1e-6)


@pytest.mark.parametrize("mesh, name", [(mesh, name) for mesh in sorted(MESHES)
                                        for name in sorted(CASES)]
                         + [("1x4", "jax_ts"), ("1x2", "2x1_True"), ("1x2", "2x1_False")])
def test_weights_bitwise_equal_across_ranks(runs, mesh, name):
    cases, results, _ = runs.get(mesh)
    digests = [res[name]["digests"] for res in results]
    assert len(digests[0]) == cases[name]["steps"]
    assert all(d == digests[0] for d in digests[1:])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_later_steps_match_single_rank(runs, mesh, name):
    """The later steps' losses (and, fused, our_repro and the gradient norm)
    against the single-rank port, rtol 2e-4."""
    _, results, refs = runs.get(mesh)
    want = refs[name]["steps"]
    for res in results:
        steps = res[name]["steps"]
        assert len(steps) == STEPS_TS - 1
        for got, (loss, repro, norm) in zip(steps, want[1:]):
            np.testing.assert_allclose(got[0], loss, rtol=2e-4)
            if len(got) > 1:
                np.testing.assert_allclose(got[1:], [repro, 1, norm], rtol=2e-4)


def test_table_sharding_true_on_a_data_mesh_is_bitwise_false(runs):
    """``parallel.table_sharding = true`` on [2, 1] (one edge shard, nothing
    to shard) runs bitwise the same as ``false``: the first step's loss and
    gradients, every later step and the weights after every update."""
    _, results, _ = runs.get("1x2")
    for res in results:
        on, off = res["2x1_True"], res["2x1_False"]
        assert on["loss"] == off["loss"] and on["steps"] == off["steps"]
        assert on["digests"] == off["digests"]
        for k, g in on["grads"].items():
            np.testing.assert_array_equal(g, off["grads"][k], err_msg=k)


def test_grouped_evaluation_agrees_on_a_scene_out_of_memory(runs):
    """``epoch_evaluation`` on [2, 1] (one group of two scenes) under
    ``crash_on_scene_exhausting_memory=False``, with the second scene's
    graph running out of memory on rank 1 alone: the ranks agree on it, it
    gets its row of NaNs, and the first scene, evaluated again as a group of
    one, its row of the run without the failure."""
    _, results, _ = runs.get("1x2")
    clean, failing = (dict(rows) for rows in results[0]["2x1_False"]["evaluation"])
    assert all(res["2x1_False"]["evaluation"] == (None, None) for res in results[1:])
    assert list(failing) == list(clean) == ["scene0", "scene1", "Mean"]
    cols = [c for c in clean["scene0"] if c != "Inference time"]
    assert np.isfinite([clean[s][c] for s in ("scene0", "scene1") for c in cols]).all()
    for c in cols:
        assert failing["scene0"][c] == clean["scene0"][c], c
        assert np.isnan(failing["scene1"][c]), c


def test_grouped_evaluation_agrees_on_a_forward_that_would_not_fit(runs):
    """``epoch_evaluation`` on [2, 1] of four scenes (two groups of two)
    under ``crash_on_scene_exhausting_memory=False``, with the reservation
    of the last scene's forward running out of memory on rank 1 alone: the
    ranks agree before the forward, the second group's scenes get their
    rows of NaNs, and the first group's rows are those of the run without
    the failure."""
    _, results, _ = runs.get("1x2")
    clean, failing = (dict(rows) for rows in results[0]["2x1_False"]["unfit"])
    assert all(res["2x1_False"]["unfit"] == (None, None) for res in results[1:])
    scenes = ["scene0", "scene1", "scene2", "scene3"]
    assert list(failing) == list(clean) == scenes + ["Mean"]
    cols = [c for c in clean["scene0"] if c != "Inference time"]
    assert np.isfinite([clean[s][c] for s in scenes for c in cols]).all()
    for c in cols:
        for s in scenes[:2]:
            assert failing[s][c] == clean[s][c], (s, c)
        for s in scenes[2:]:
            assert np.isnan(failing[s][c]), (s, c)


# ---------------------------------------------------------------------------
# multi-scene learning on a mesh
# ---------------------------------------------------------------------------


def test_cli_multi_scene_learning_on_a_mesh_writes_one_tree(runs):
    """``multi-scene-learning`` under [2, 1] on the synthetic GASFM conf for 2
    epochs in batches of two (run by ``runs``): rank 0 wrote the one tree,
    the single-rank CLI's, with finite errors."""
    assert runs.cli.result() == [0, 0]
    root = runs.cli_dir
    assert sorted(os.listdir(root)) == ["mesh", "single"]
    mesh, single = root / "mesh", root / "single"
    files = {p.relative_to(mesh).as_posix() for p in mesh.rglob("*") if "code" not in p.parts}
    want = {p.relative_to(single).as_posix() for p in single.rglob("*") if "code" not in p.parts}
    strip = {f for f in files | want if "tfevents" in f}
    assert files - strip == want - strip
    assert len(os.listdir(mesh / "tb")) == 1
    for name in ("final_val_errors", "best_test_errors", "final_train_errors_FINE_TUNE_from_best",
                 "final_train_errors_SHORT_OPTIMIZATION"):
        table = pd.read_csv(mesh / f"{name}.csv")
        errors = table[["our_repro", "t_err_mean", "R_err_mean"]].to_numpy(dtype=float)
        assert errors.shape[0] > 0 and np.isfinite(errors).all(), name
    stats = pd.read_csv(mesh / "train_stats.csv")
    assert np.isfinite(stats["best_validation_metric"].to_numpy(dtype=float)).all()


def test_cli_first_epoch_losses_match_single_rank(runs):
    """The first epoch's batch losses (each the sum over a batch of two
    sampled scenes: one group step on the mesh, two samples' gradients
    accumulated on one rank) and their our_repro of the [2, 1] CLI against
    the single-rank CLI's, rtol 2e-4."""
    runs.cli.result()
    got = scalars(runs.cli_dir / "mesh" / "tb")
    want = scalars(runs.cli_dir / "single" / "tb")
    n_batches = 2  # three training scenes in batches of two
    for tag in ("TRAINING-all-scenes/batch/loss", "TRAINING-all-scenes/batch/our_repro"):
        first = [v for _, v in sorted(want[tag])[:n_batches]]
        np.testing.assert_allclose([v for _, v in sorted(got[tag])[:n_batches]], first,
                                   rtol=2e-4, err_msg=tag)


@pytest.mark.parametrize("table", ["final_train_errors", "final_val_errors", "final_test_errors",
                                   "best_train_errors", "best_test_errors"])
def test_cli_grouped_evaluation_matches_single_rank(runs, table):
    """The [2, 1] CLI's evaluations (groups of two scenes through
    ``forward_group``, the last group padded) against the single-rank
    CLI's, row for row."""
    runs.cli.result()
    got = pd.read_csv(runs.cli_dir / "mesh" / f"{table}.csv").set_index("Scene")
    want = pd.read_csv(runs.cli_dir / "single" / f"{table}.csv").set_index("Scene")
    assert list(got.index) == list(want.index)
    for col in ("our_repro", "t_err_mean", "R_err_mean"):
        np.testing.assert_allclose(got[col].to_numpy(dtype=float),
                                   want[col].to_numpy(dtype=float), rtol=5e-3, atol=1e-3,
                                   err_msg=col)
