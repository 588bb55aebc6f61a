"""The port's mesh (``parallel.mesh_shape = [n_data, n_edge]``, replicated
tables: ``parallel.table_sharding = false``) on the CPU, against the JAX
package. Table sharding, the default on an edge axis, and multi-scene
learning on a mesh are held in tests/test_torch_port_table_sharding.py.

The ranks are gloo processes spawned by the port's own launcher
(``gasfm_tpu_torch.parallel.run_ranks``); they run
tests/torch_port_mesh_ranks.py, which imports no JAX, and return their
results to this process. The file spawns three times: two ranks (the
``[1, 2]`` mesh, and ``[2, 1]`` as another layout of the same ranks), four
ranks (the ``[2, 2]`` mesh) and the CLI under ``[1, 2]``.

- Edge-shard graphs: every edge in exactly one shard, the scene's counts and
  validity on each, a shard with no edge raises.
- Four models (the flagship-shaped merged GASFM at ``n_feat_proj = 32``,
  the unfused 16-wide GASFM, DPESFM, the depth head) under ``[1, 2]`` (one
  scene) and ``[2, 2]`` (a group of two): the first step's loss and every
  gradient against the JAX package's single-device step (the sum over the
  group's scenes; its composite XLA path), at tests/test_torch_port_train.py's
  tolerance (atol 5e-4 x max(2e-4, the leaf's max |grad|), rtol 2e-3; loss
  rtol 2e-5); the later steps' losses against the single-rank port at rtol
  2e-4; the weights bitwise equal across the ranks after every update; the
  predictions whole on every rank.
- Scene data parallelism alone: DPESFM on ``[2, 1]`` (a group of two), its
  first step against the JAX package's, the later steps against the
  single-rank port, the weights bitwise equal across the ranks.
- bf16 weights with an f32 master on ``[1, 2]``, the ranks starting from
  different weights: rank 0's reach every rank before the optimizer copies
  them, and the weights stay bitwise equal across the ranks.
- A padded group (one scene on the ``[2, 2]`` mesh, a slot of weight 0)
  through ``TrainingSession.from_conf`` and ``fused_group_step`` against the
  JAX package's ``make_sharded_fused_step`` on the conftest's 8-device CPU
  mesh (tests/test_parallel.py's tolerances).
- ``parallel.distributed`` read into this host's spec, a missing key or a
  mesh that ``num_processes`` does not divide raising (the launchers
  themselves run in tests/test_torch_port_multihost.py). What stays
  raising: a recorded mesh session, a
  mesh conf without the ranks. Table sharding null or true, which raised
  before the port ran it, now gives the mesh's shape
  (``test_mesh_shape_from_conf``); multi-scene learning on a mesh, which
  raised too, runs (tests/test_torch_port_table_sharding.py's CLI test).
- The CLI: ``single-scene-optim`` under ``[1, 2]`` for 2 epochs writes one
  tree.
"""

import concurrent.futures
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.config import ConfigFactory as JaxConfigFactory
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.losses import DirectDepthLoss as JaxDirectDepthLoss
from gasfm_tpu.losses import ESFMLoss as JaxESFMLoss
from gasfm_tpu.models import get_model as jax_get_model
from gasfm_tpu.models.convert import convert_reference_state_dict
from gasfm_tpu.models.gasfm import GraphAttnSfMNet as JaxGraphAttnSfMNet
from gasfm_tpu.models.set_of_set import SetOfSetNet as JaxSetOfSetNet

import torch_port_mesh_ranks as R
from gasfm_tpu_torch.config import ConfigFactory
from gasfm_tpu_torch.graph.view_graph import build_host_scene_graph, shard_host_graph, upload
from gasfm_tpu_torch.losses import DEPTH_LOSS, DPESFM_LOSS, FLAGSHIP_LOSS, ESFMLoss
from gasfm_tpu_torch.parallel import (Distributed, distributed_from_conf, mesh_shape_from_conf,
                                      pad_scene_group, run_ranks)

OPTIM = dict(lr=1e-3, main_scheduler="constant", grad_clip_mode=None)
STEPS = 4  # the first step, then three
# the later steps under bf16 weights against the single rank: one bf16 ulp
# (the gradients are bf16, and each rank's partial is rounded before the sum)
BF16_RTOL = 2.0 ** -7
DEPTH_ONLY = dict(depth_head_enabled=True, view_head_enabled=False,
                  scenepoint_head_enabled=False)
# name: (model, its keyword arguments, loss, its keyword arguments, JAX loss conf)
ESFM_CONF = """
model { view_head { enabled = true }, scenepoint_head { enabled = true } }
loss { infinity_pts_margin = 0.0001, pts_grad_equalization_pre_perspective_divide = true,
       normalize_grad_wrt_valid_projections_only = %s, hinge_loss = true,
       hinge_loss_weight = 1 }
"""
DEPTH_CONF = """
dataset { calibrated = true }
model { depth_head { enabled = true } }
loss { cost_fcn = "L1" }
"""
CASES = {
    "merged": ("gasfm", dict(num_layers=2, n_heads=4, n_feat_proj=32, n_feat_scenepoint=24,
                             n_feat_view=40, n_feat_global=48, stateful_global_features=True,
                             add_skipconn_from_init_projfeat=True),
               "esfm", FLAGSHIP_LOSS, ESFM_CONF % "true"),
    "unfused": ("gasfm", dict(num_layers=2, n_heads=2, n_feat_proj=16, n_feat_scenepoint=16,
                              n_feat_view=32, n_feat_global=32, stateful_global_features=True,
                              add_skipconn_from_init_projfeat=True),
                "esfm", FLAGSHIP_LOSS, ESFM_CONF % "true"),
    "dpesfm": ("dpesfm", dict(num_blocks=2, block_size=2, num_features=32),
               "esfm", DPESFM_LOSS, ESFM_CONF % "false"),
    "depth": ("gasfm", dict(num_layers=3, n_heads=2, n_feat_proj=32, n_feat_scenepoint=24,
                            n_feat_view=40, n_feat_global=48, depth_head_n_feat=32,
                            depth_head_n_hidden_layers=1, **DEPTH_ONLY),
              "depth", DEPTH_LOSS, DEPTH_CONF),
}
JAX_MODELS = {"gasfm": (JaxGraphAttnSfMNet, "graph_attn_sfm.GraphAttnSfMNet"),
              "dpesfm": (JaxSetOfSetNet, "set_of_set.SetOfSetNet")}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
# the two-rank spawn's cases beyond CASES, by the CASES model each runs:
# DPESFM's group of two on [2, 1], bf16 weights on [1, 2] from weights
# that differ between the ranks, and the merged GASFM under bf16 edge
# streams (compile.stream_dtype = bf16) on [1, 2]
EXTRA = {"dpesfm_2x1": "dpesfm", "bf16": "dpesfm", "stream_bf16": "merged"}

# tests/test_parallel.py's model, with the port's conf keys, for the padded group
PADDED_CONF = """
dataset { calibrated = true }
model {
  type = "graph_attn_sfm.GraphAttnSfMNet"
  n_heads = 2, stateful_global_features = true
  global2view_and_global2scenepoint_enabled = false
  n_feat_proj = 16, n_feat_scenepoint = 16, n_feat_view = 32, n_feat_global = 32
  num_layers = 2
  n_hidden_layers_scenepoint_update = 0, n_hidden_layers_view_update = 0
  n_hidden_layers_global_update = 0, n_hidden_layers_proj_update = 0
  use_norm_proj_update = true, add_residual_skipconn_proj_update = true
  add_skipconn_from_init_projfeat = true, pos_emb_n_freq = 0
  depth_head { enabled = false }
  view_head { enabled = true, n_hidden_layers = 1, rot_representation = "quat" }
  scenepoint_head { enabled = true, n_hidden_layers = 1 }
}
train { lr = 0.001, lr_schedule { lr_warmup_n_steps = 0, main_scheduler = "constant" } }
loss {
  func = "ESFMLoss", infinity_pts_margin = 0.0001
  pts_grad_equalization_pre_perspective_divide = true
  normalize_grad_wrt_valid_projections_only = true
  hinge_loss = true, hinge_loss_weight = 1
}
parallel { mesh_shape = [2, 2], table_sharding = false }
"""


def scene(seed, depth=False):
    d = jax_synthetic_scene(n_views=8, n_points=150, visibility=0.5, seed=seed,
                            store_depth_targets=depth)
    return dict(M=d.M, Ns=d.Ns, y=d.y, depths=d.depths if depth else None)


def case_of(name, n_scenes):
    kind, kw, loss, loss_kw, _ = CASES[name]
    model = R.MODELS[kind](**kw, generator=torch.Generator().manual_seed(0))
    depth = loss == "depth"
    return dict(model=(kind, kw), state={k: v.numpy() for k, v in model.state_dict().items()},
                loss=(loss, loss_kw), optim=OPTIM, steps=STEPS, fused=not depth,
                scenes=[scene(3 + i, depth) for i in range(n_scenes)], table_sharding=False)


def padded_case():
    """The padded group's case (its weights the port's initializer's) and
    the JAX side's conf, scene and the same weights as a flax tree."""
    from gasfm_tpu_torch.models import get_model

    conf = JaxConfigFactory.parse_string(PADDED_CONF)
    data = jax_synthetic_scene(n_views=6, n_points=48, seed=0)
    model = get_model(ConfigFactory.parse_string(PADDED_CONF),
                      generator=torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params = convert_reference_state_dict(state, "graph_attn_sfm.GraphAttnSfMNet")
    return dict(conf=PADDED_CONF, state=state, steps=1, fused="all",
                scenes=[dict(M=data.M, Ns=data.Ns, y=data.y)]), (conf, data, params)


class _Runs:
    """The file's three spawns (both meshes, then the CLI), run one after
    the other on a thread from the first test that asks, while the JAX
    package's steps run in this process: ``get(mesh)`` waits and returns
    (the cases by name, each rank's results by name, the single-rank
    references by name, the padded case's JAX inputs); ``cli`` is the CLI
    run's future (its results directory)."""

    def __init__(self, results_dir):
        self.cases, self.extra = {}, None
        for mesh, (n_data, _) in MESHES.items():
            self.cases[mesh] = {name: case_of(name, n_data) for name in CASES}
        self.cases["1x2"]["dpesfm_2x1"] = dict(case_of("dpesfm", 2), mesh=(2, 1))
        self.cases["1x2"]["bf16"] = dict(case_of("dpesfm", 1),
                                         optim=dict(OPTIM, param_dtype="bf16"), rank_noise=0.01)
        merged = case_of("merged", 1)
        self.cases["1x2"]["stream_bf16"] = dict(
            merged, model=("gasfm", dict(merged["model"][1], stream_dtype=torch.bfloat16)))
        self.cases["2x2"]["padded"], self.extra = padded_case()
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.futures = {mesh: self.pool.submit(self._spawn, mesh) for mesh in MESHES}
        self.cli_dir = results_dir
        self.cli = self.pool.submit(self._cli, results_dir)

    @staticmethod
    def _cli(results_dir):
        """``single-scene-optim`` under [1, 2] on the synthetic GASFM conf
        for 2 epochs, into ``results_dir``."""
        from gasfm_tpu_torch.main import main

        before = os.environ.get("GASFM_RESULTS_PATH")
        os.environ["GASFM_RESULTS_PATH"] = str(results_dir)
        try:
            return main(["single-scene-optim", "--conf", "synth/optim_synth_gasfm.conf",
                         "--device", "cpu", "--exp-dir", "mesh", "--external-params",
                         "train.n_epochs=2", "eval.eval_interval=1",
                         "parallel.mesh_shape=[1,2]", "parallel.table_sharding=false"])
        finally:
            if before is None:
                del os.environ["GASFM_RESULTS_PATH"]
            else:
                os.environ["GASFM_RESULTS_PATH"] = before

    def _spawn(self, mesh):
        cases = list(self.cases[mesh].values())
        refs = [i for i, name in enumerate(self.cases[mesh]) if name != "padded"]
        return run_ranks(R.run_cases, *MESHES[mesh], args=(cases, refs), device="cpu")

    def get(self, mesh):
        names = list(self.cases[mesh])
        ranks = self.futures[mesh].result()
        assert all(clean for _, _, clean in ranks), "a rank imported JAX"
        results = [dict(zip(names, res)) for res, _, _ in ranks]
        refs = {names[i]: ref for _, part, _ in ranks for i, ref in part.items()}
        return self.cases[mesh], results, refs, self.extra


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("mesh_cli"))
    yield r
    r.pool.shutdown()


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name):
    kind, kw, loss, _, conf = CASES[name]
    model = JAX_MODELS[kind][0](**kw)
    lconf = JaxConfigFactory.parse_string(conf)
    loss_func = JaxDirectDepthLoss(lconf) if loss == "depth" else JaxESFMLoss(lconf)
    return jax.jit(jax.value_and_grad(lambda p, sg: loss_func(model.apply(p, sg.graph), sg)))


def jax_step(name, case):
    """The JAX package's single-device loss and gradients (composite path,
    jitted once per model: the scenes share their padded capacities), summed
    over the case's scenes."""
    type_str = JAX_MODELS[CASES[name][0]][1]
    params = convert_reference_state_dict(case["state"], type_str)
    total, grads = 0.0, None
    for s in case["scenes"]:
        sg = jax_build_scene_graph(s["M"], s["Ns"], s["y"], gt_depths_dense=s["depths"])
        value, g = _jax_value_and_grad(name)(params, sg)
        total += float(value)
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add, grads, g)
    return total, grads, type_str


def assert_grads_close(got, want, type_str, what):
    """{port name: array} against the JAX tree: atol 5e-4 x max(2e-4, the
    leaf's max |value|), rtol 2e-3 (tests/test_torch_port_train.py's)."""
    tree = convert_reference_state_dict(got, type_str)
    pairs = zip(jax.tree_util.tree_leaves_with_path(tree),
                jax.tree_util.tree_leaves_with_path(want))
    for (path, g), (_, w) in pairs:
        g, w = np.asarray(g), np.asarray(w)
        scale = max(2e-4, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=5e-4 * scale, rtol=2e-3,
                                   err_msg=f"{what}: {path}")


# ---------------------------------------------------------------------------
# edge-shard graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_edge_shards_partition_the_scene(n_shards):
    s = scene(3)
    host = build_host_scene_graph(s["M"], s["Ns"], s["y"])
    E, n, m = host.cam_idx.shape[0], host.pt_valid.shape[0], host.cam_valid.shape[0]
    seen = []
    cams_per_shard = []
    for k in range(n_shards):
        sh = shard_host_graph(host, k, n_shards)
        g = upload(sh, "cpu").graph
        lo = sh.edge_offset
        seen.append(np.arange(lo, lo + g.num_edges))
        np.testing.assert_array_equal(g.cam_idx.numpy(), host.cam_idx[lo:lo + g.num_edges])
        np.testing.assert_array_equal(g.pt_idx.numpy(), host.pt_idx[lo:lo + g.num_edges])
        # CSR offsets over all points and cameras, in the shard's own edges
        assert g.pt_ptr.shape[0] == n + 1 and g.cam_ptr.shape[0] == m + 1
        ptr = g.pt_ptr.numpy()
        np.testing.assert_array_equal(np.repeat(np.arange(n), np.diff(ptr)), g.pt_idx.numpy())
        perm, cptr = g.cam_perm.numpy(), g.cam_ptr.numpy()
        np.testing.assert_array_equal(np.repeat(np.arange(m), np.diff(cptr)),
                                      g.cam_idx.numpy()[perm])
        np.testing.assert_array_equal(np.sort(perm), np.arange(g.num_edges))
        # the scene's counts and validity
        np.testing.assert_array_equal(g.pt_count.numpy(),
                                      np.maximum(np.diff(host.pt_ptr), 1).astype(np.float32))
        np.testing.assert_array_equal(g.cam_count.numpy(),
                                      np.maximum(np.diff(host.cam_ptr), 1).astype(np.float32))
        np.testing.assert_array_equal(g.pt_valid.numpy(), host.pt_valid)
        np.testing.assert_array_equal(g.cam_valid.numpy(), host.cam_valid)
        assert g.scene_edges == E
        cams_per_shard.append(np.unique(g.cam_idx.numpy()).size)
        # every split the kernels take, recomputed over the shard's offsets
        for (side, rows, above), parts in sh.splits.items():
            chunks = (g.pt_chunks if side == "pt" else g.cam_chunks)(rows, above)
            np.testing.assert_array_equal(chunks.long_seg, parts["long_seg"])
    np.testing.assert_array_equal(np.concatenate(seen), np.arange(E))
    # the hubs: a point cut by a shard boundary, cameras on every shard
    bounds = [a[0] for a in seen[1:]]
    assert any(host.pt_idx[b - 1] == host.pt_idx[b] for b in bounds)
    assert min(cams_per_shard) == m


def test_edge_shard_without_edges_raises():
    s = scene(3)
    host = build_host_scene_graph(s["M"], s["Ns"], s["y"])
    E = host.cam_idx.shape[0]
    with pytest.raises(ValueError, match="gets no edge"):
        shard_host_graph(host, E, E + 1)
    with pytest.raises(ValueError, match="whole scene"):
        shard_host_graph(shard_host_graph(host, 0, 2), 0, 2)


def test_pad_scene_group():
    assert pad_scene_group(["a"], 3) == (["a", "a", "a"], [1.0, 0.0, 0.0])
    assert pad_scene_group(["a", "b"], 2) == (["a", "b"], [1.0, 1.0])
    with pytest.raises(ValueError):
        pad_scene_group(["a", "b", "c"], 2)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


def first_step_matches_jax(runs, mesh, name):
    case = runs.cases[mesh][name]
    want_loss, want, type_str = jax_step(EXTRA.get(name, name), case)
    _, results, _, _ = runs.get(mesh)
    for rank, res in enumerate(results):
        got = res[name]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=2e-5, err_msg=f"rank {rank}")
        assert_grads_close(got["grads"], want, type_str, f"rank {rank}: grad of")


# the [1, 2] mesh's, then the padded group's, then the [2, 2] mesh's: each
# JAX compile runs while the spawns still run


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_step_matches_jax_1x2(runs, name):
    first_step_matches_jax(runs, "1x2", name)


def test_padded_group_matches_jax_sharded_step(runs):
    """One scene on the [2, 2] mesh (slot 1 of weight 0) through
    ``TrainingSession.from_conf`` and ``fused_group_step`` against the JAX
    package's ``make_sharded_fused_step`` (its TrainingSession on 4 of the 8
    CPU devices): the loss, our_repro and gradient norm (tests/test_parallel.py's
    tolerances), one scene counted, and Adam's first moment after the step,
    0.1 x the gradient, at the gradients' tolerance."""
    from gasfm_tpu.train.loop import TrainingSession as JaxTrainingSession

    conf, data, params = runs.extra
    session = JaxTrainingSession(conf, jax_get_model(conf))
    sg = session.bucketize(data)
    _, opt_state, loss, repro, norm = session.fused_step(
        jax.tree_util.tree_map(jnp.array, params), session.tx.init(params), sg)
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
               if hasattr(s, "mu")]
    _, results, _, _ = runs.get("2x2")
    for rank, res in enumerate(results):
        got = res["padded"]
        loss_g, repro_g, n_valid, norm_g = got["steps"][0]
        assert n_valid == 1.0
        assert loss_g == pytest.approx(float(loss), rel=1e-5)
        assert repro_g == pytest.approx(float(repro), rel=1e-4)
        assert norm_g == pytest.approx(float(norm), rel=1e-3)
        assert_grads_close(got["mu"], adam.mu, "graph_attn_sfm.GraphAttnSfMNet",
                           f"rank {rank}: first moment of")


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_step_matches_jax_2x2(runs, name):
    first_step_matches_jax(runs, "2x2", name)


def test_first_step_matches_jax_2x1(runs):
    """DPESFM's group of two on [2, 1]: each rank a whole scene, the
    gradients summed over the data group."""
    first_step_matches_jax(runs, "1x2", "dpesfm_2x1")


def forward_group_matches_single_rank(runs, mesh, name):
    _, results, refs, _ = runs.get(mesh)
    for res in results:
        got = res[name]["group_pred"]
        assert len(got) == len(refs[name]["preds0"]) == 2
        for pred, want in zip(got, refs[name]["preds0"]):
            assert sorted(pred) == sorted(want)
            for k, v in want.items():
                np.testing.assert_allclose(pred[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_group_matches_single_rank(runs, name):
    """``forward_group`` on the [2, 2] mesh (each data slot on its scene,
    shared over the data group) against the single-rank port's forward of
    each scene, on every rank."""
    forward_group_matches_single_rank(runs, "2x2", name)


def test_forward_group_matches_single_rank_2x1(runs):
    forward_group_matches_single_rank(runs, "1x2", "dpesfm_2x1")


def later_steps_match_single_rank(runs, mesh, name, rtol=2e-4):
    cases, results, refs, _ = runs.get(mesh)
    want = refs[name]["steps"]
    n_scenes = len(cases[name]["scenes"])
    for res in results:
        steps = res[name]["steps"]
        assert len(steps) == STEPS - 1
        for got, (loss, repro, norm) in zip(steps, want[1:]):
            np.testing.assert_allclose(got[0], loss, rtol=rtol)
            if len(got) > 1:
                np.testing.assert_allclose(got[1:], [repro, n_scenes, norm], rtol=rtol)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_later_steps_match_single_rank(runs, mesh, name):
    """The later steps against the single-rank port (its accumulate path for
    a group of two): loss, and for the fused steps our_repro, the number of
    scenes and the gradient norm, rtol 2e-4."""
    later_steps_match_single_rank(runs, mesh, name)


def test_later_steps_match_single_rank_2x1(runs):
    later_steps_match_single_rank(runs, "1x2", "dpesfm_2x1")


def test_bf16_mesh_starts_from_rank0_weights(runs):
    """bf16 weights with an f32 master on [1, 2], rank 1 starting from other
    weights than rank 0: rank 0's are broadcast before the optimizer copies
    the master, so the steps are those of the single-rank port from rank
    0's weights (the first loss rtol 2e-5, the later steps BF16_RTOL) and
    the weights stay bitwise equal across the ranks
    (test_weights_bitwise_equal_across_ranks[1x2-bf16])."""
    _, results, refs, _ = runs.get("1x2")
    want = refs["bf16"]["steps"]
    for res in results:
        np.testing.assert_allclose(res["bf16"]["loss"], want[0][0], rtol=2e-5)
    later_steps_match_single_rank(runs, "1x2", "bf16", rtol=BF16_RTOL)


def test_bf16_streams_mesh_matches_single_rank(runs):
    """The merged GASFM under bf16 edge streams on [1, 2] (each edge shard's
    streams bf16 through the same kernels' plain versions) against the
    single-rank port: the first loss rtol 2e-5, the later steps (loss,
    our_repro, scenes, gradient norm) BF16_RTOL: the shards sum the softmax
    and the tables in another order, and a stream value at a bf16 tie may
    round to the other neighbour."""
    _, results, refs, _ = runs.get("1x2")
    want = refs["stream_bf16"]["steps"]
    for res in results:
        np.testing.assert_allclose(res["stream_bf16"]["loss"], want[0][0], rtol=2e-5)
    later_steps_match_single_rank(runs, "1x2", "stream_bf16", rtol=BF16_RTOL)


@pytest.mark.parametrize("mesh, name", [(mesh, name) for mesh in sorted(MESHES)
                                        for name in sorted(CASES)]
                         + [("2x2", "padded"), ("1x2", "dpesfm_2x1"), ("1x2", "bf16"),
                            ("1x2", "stream_bf16")])
def test_weights_bitwise_equal_across_ranks(runs, mesh, name):
    cases, results, _, _ = runs.get(mesh)
    digests = [res[name]["digests"] for res in results]
    assert len(digests[0]) == cases[name]["steps"]
    assert all(d == digests[0] for d in digests[1:])


@pytest.mark.parametrize("name", sorted(CASES))
def test_predictions_whole_on_every_rank(runs, name):
    """The first step's predictions on the [1, 2] mesh (the depth head's
    per-edge depths put together over the edge group) against the
    single-rank port's forward before any update; ``session.loss`` of them
    on the mesh, the scene's loss."""
    _, results, refs, _ = runs.get("1x2")
    want = refs[name]["preds0"][0]
    for res in results:
        pred = res[name]["pred"]
        assert sorted(pred) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(pred[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(res[name]["pred_loss"], res[name]["loss"], rtol=1e-6)


# ---------------------------------------------------------------------------
# the conf's layouts, and what stays raising
# ---------------------------------------------------------------------------


def mesh_conf(extra):
    return ConfigFactory.parse_string(f"parallel {{ {extra} }}")


DISTRIBUTED = ('distributed { enabled = true, coordinator_address = "127.0.0.1:29500", '
               'num_processes = 2, process_id = 1 }')


@pytest.mark.parametrize("shape, block, want", [
    # a whole block: this host's spec
    ((1, 2), DISTRIBUTED, Distributed("127.0.0.1", 29500, 2, 1)),
    # each missing key, named (no cluster metadata to detect it from)
    *[((2, 2), DISTRIBUTED.replace(k, "unused_" + k), k)
      for k in ("coordinator_address", "num_processes", "process_id")],
    # num_processes must divide the mesh's ranks; a mesh of one position
    ((1, 3), DISTRIBUTED, "must divide"), ((1, 1), DISTRIBUTED, "must divide"),
    # disabled or absent: today's result
    ((1, 2), "distributed { enabled = false, process_id = 7 }", None), ((1, 2), "", None)])
def test_distributed_from_conf(shape, block, want):
    """``parallel.distributed`` read as the JAX package's
    ``initialize_distributed`` reads it (the launchers themselves run in
    tests/test_torch_port_multihost.py); the mesh's shape stands as it is."""
    conf = mesh_conf(f"mesh_shape = {list(shape)}, {block}")
    assert mesh_shape_from_conf(conf) == (shape if shape != (1, 1) else None)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            distributed_from_conf(conf)
    else:
        assert distributed_from_conf(conf) == want


@pytest.mark.parametrize("extra, want", [
    ("mesh_shape = [1, 2], table_sharding = false", (1, 2)),
    ("mesh_shape = [2, 1]", (2, 1)), ("mesh_shape = [1, 1]", None), ("", None),
    # table sharding null or true (raising before the port ran it)
    ("mesh_shape = [1, 2]", (1, 2)), ("mesh_shape = [2, 2]", (2, 2)),
    ("mesh_shape = [1, 2], table_sharding = true", (1, 2))])
def test_mesh_shape_from_conf(extra, want):
    assert mesh_shape_from_conf(mesh_conf(extra)) == want


def test_mesh_conf_needs_the_ranks_and_refuses_capture():
    """A mesh conf without the ranks, a recorded mesh session, a group of
    scenes without a mesh: each raises ValueError."""
    from gasfm_tpu_torch.parallel import Mesh
    from gasfm_tpu_torch.train.loop import TrainingSession

    conf = ConfigFactory.parse_string(PADDED_CONF)
    model = R.MODELS["gasfm"](**CASES["unfused"][1])
    with pytest.raises(ValueError, match="run_ranks"):
        TrainingSession.from_conf(conf, model, device="cpu")
    mesh = Mesh(n_data=1, n_edge=2, rank=0, device=torch.device("cpu"), edge_group=None,
                data_group=None)
    with pytest.raises(ValueError, match="eagerly"):
        TrainingSession(model, ESFMLoss(), device="cpu", capture=True, mesh=mesh)
    single = TrainingSession(model, ESFMLoss(), device="cpu")
    for call in (single.fused_group_step, single.group_loss_and_grads):
        with pytest.raises(ValueError, match="mesh session"):
            call([None])


def test_cli_single_scene_on_a_mesh_writes_one_tree(runs):
    """``single-scene-optim`` under [1, 2] on the synthetic GASFM conf for 2
    epochs (run by ``runs``): the ranks ran, rank 0 wrote the one tree, with
    a finite final our_repro."""
    assert runs.cli.result() == 0
    root = runs.cli_dir
    assert os.listdir(root) == ["mesh"]
    exp = root / "mesh"
    assert (exp / "final_train_errors_OPTIMIZATION.csv").exists()
    scenes = os.listdir(exp / "OPTIMIZATION")
    assert len(scenes) == 1
    assert (exp / "OPTIMIZATION" / scenes[0] / "models" / "final_model.npz").exists()
    assert len(os.listdir(exp / "tb")) == 1
    rows = (exp / "final_train_errors_OPTIMIZATION.csv").read_text().splitlines()
    header, row = rows[0].split(","), rows[1].split(",")
    assert np.isfinite(float(row[header.index("our_repro")]))
