"""Multi-scene learning in the port (``python -m gasfm_tpu_torch.main
multi-scene-learning``) on the CPU, against the JAX package's CLI and
training loop.

- The CLI: one JAX CLI run as the oracle (once for the module), on
  ``synth/learning_synth_gasfm.conf`` cut to 2 training scenes, 1 test
  scene, 1 epoch and 1 fine-tuning epoch, from a JAX init's weights
  (``--pretrained-model-path``) with ``train.lr = train.finetune_lr = 0``,
  so that the training, fine-tuning and both sets of weights leave the
  weights as loaded; the port's CLI the same. Held: the same artifact tree,
  the same ``train_stats`` columns, best epoch and metrics; the
  ``final_`` / ``best_`` train / val / test tables and the fine-tuning
  tables, value for value (rtol 1e-4, plus 1e-3 for the CSVs' 3 decimals;
  the wall times left out); ``triangulated_repro`` and ``t_err_med``, which
  the random weights' predictions make ill-conditioned (as in
  ``tests/test_torch_port_cli.py``), per scene as the JAX package's
  metric battery gives them on the port's dumped predictions, which agree
  with the JAX CLI's at ``tests/test_torch_port_model.py``'s forward
  tolerance. Then both CLIs with
  ``--skip-training --skip-fine-tuning --skip-short-optim`` and
  ``train.outlier_injection_rate = 0.1``: the evaluations inject the same
  outliers from the same generator, and the tables with outliers and the
  outlier-free ones agree the same way. A default run of the conf (10
  epochs, its own weights) through ``python -m`` writes the same tree.
- Gradient accumulation: one batch of 4 sampled, augmented scenes of a
  small DPESFM (``dpesfm/learning_euc_rhaug-15-20_outliers0.1_dpesfm.conf``
  at width 32) from a JAX init: the sum of the 4 samples' gradients
  (``loss_and_grads`` + ``accumulate``) against the JAX session's, and one
  epoch of that batch through ``epoch_train`` with outliers injected (the
  same draws in both) against the JAX package's ``epoch_train``: the
  parameters after the update. Tolerances of
  ``tests/test_torch_port_dpesfm.py`` (gradients |err| <= 2e-4 x the leaf's
  max |grad| + 1e-3 |ref|; leaves of rounding noise below 1e-6 x the
  largest gradient; parameters |err| <= 1e-6 + 1e-4 |ref|, the noise
  leaves within twice the learning rate).
- The session's memory, with ``tests/test_torch_port_capture.py``'s
  stand-in for a CUDA graph: over epochs of sampled scenes the session
  holds the fixed evaluation scenes' graphs and forward recordings only,
  the same after every epoch; a new ``SceneData`` never receives a dropped
  one's graph (CPython reuses ids); the single-scene view curriculum holds
  one stage's step recording at a time.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from test_torch_port_capture import ReplayStandIn
from test_torch_port_cli import ILL_CONDITIONED, WALL_TIMES, results_root, tree
from test_torch_port_model import assert_close

REPO = Path(__file__).resolve().parents[1]
SYNTH = "synth/learning_synth_gasfm.conf"
DPESFM = "dpesfm/learning_euc_rhaug-15-20_outliers0.1_dpesfm.conf"
CUT = ["train.n_epochs=1", "eval.eval_interval=1", "train.finetune_n_epochs=1",
       "train.finetune_eval_interval=1", 'dataset.test_set=["synth_test0"]',
       'dataset.train_set=["synth_train0","synth_train1"]', "train.lr=0", "train.finetune_lr=0"]
# the cut run's other phases are the same code as fine-tuning from the final
# weights (the shipped-conf run below writes them)
CUT_SKIP = ["--skip-fine-tuning-from-best", "--skip-short-optim"]
SKIP = ["--skip-training", "--skip-fine-tuning", "--skip-short-optim"]
OUTLIERS = ["train.outlier_injection_rate=0.1"]
NOISE = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One PyTorch intra-op thread for this module's small models: by default
    PyTorch takes one per core, and where the test workers share the cores
    their threads wait on each other (~7x slower here under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_init(conf_name, path, ext=()):
    """A JAX init (seed 5) of the conf's model, saved by the JAX package."""
    from gasfm_tpu.config import load_config as jax_load_config
    from gasfm_tpu.data.synthetic import generate_synthetic_scene
    from gasfm_tpu.models import get_model
    from gasfm_tpu.train.state import save_params

    model = get_model(jax_load_config(conf_name, external_params=list(ext)))
    probe = generate_synthetic_scene(n_views=8, n_points=64, seed=0).to_scene_graph().graph
    params = jax.jit(model.init)(jax.random.PRNGKey(5), probe)
    save_params(str(path), params)
    return params


def msl(package, root, exp, ext=(), extra=()):
    if package == "port":
        from gasfm_tpu_torch.main import main

        extra = ["--device", "cpu", *extra]
    else:
        from gasfm_tpu.main import main
    with results_root(root):
        assert main(["multi-scene-learning", "--conf", SYNTH, "--exp-dir", exp, *extra,
                     "--external-params", *ext]) == 0
    return Path(root) / exp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(package, kind): experiment directory}: the cut run with lr = 0 and
    the evaluation-only run with outliers, from the same JAX init."""
    tmp = tmp_path_factory.mktemp("msl")
    init = tmp / "init.npz"
    jax_init(SYNTH, init)
    extra = ["--pretrained-model-path", str(init)]
    out = {}
    for package in ("jax", "port"):
        out[package, "cut"] = msl(package, tmp / package, "cut", CUT, extra + CUT_SKIP)
        out[package, "outliers"] = msl(package, tmp / package, "outliers", OUTLIERS,
                                       extra + SKIP)
    return out


def test_cli_writes_the_jax_clis_tree(runs):
    for kind in ("cut", "outliers"):
        assert tree(runs["port", kind]) == tree(runs["jax", kind]), kind
    got = tree(runs["port", "cut"])
    for rel in ("models/final_model.npz", "models/best_model.npz",
                "models/model_epoch000001.npz", "train_stats.csv",
                "VALIDATION/synth_val0/predictions/best_predictions.npz",
                "final_val_errors.csv", "best_test_errors.xlsx",
                "FINE_TUNE_from_final/synth_test0/models/final_model.npz",
                "final_train_errors_FINE_TUNE_from_final.csv"):
        assert rel in got, rel


def test_cli_train_stats_match_jax(runs):
    want = pd.read_csv(runs["jax", "cut"] / "train_stats.csv", index_col=0)
    got = pd.read_csv(runs["port", "cut"] / "train_stats.csv", index_col=0)
    assert list(got.columns) == list(want.columns) == [
        "Convergence time", "best_epoch", "best_validation_metric", "final_validation_metric"]
    assert list(got.index) == list(want.index) == [0]
    assert got["best_epoch"].iloc[0] == want["best_epoch"].iloc[0] == 1
    for col in ("best_validation_metric", "final_validation_metric"):
        np.testing.assert_allclose(got[col], want[col], rtol=1e-4, atol=1e-3, err_msg=col)


SETS = {"train": "TRAINING", "val": "VALIDATION", "test": "TEST"}


def predictions_of(name):
    """(the phase directory, the predictions' file name) a table's rows were
    evaluated from."""
    stem = name[:-len(".csv")]
    if "_FINE_TUNE_" in stem:
        return stem.split("final_train_errors_")[1], "final_predictions.npz"
    which, subset, rest = stem.split("_", 2)
    suffix = rest[len("errors"):]
    return SETS[subset] + suffix, f"{which}_predictions.npz"


def jax_battery(conf_ext, scene, pred_path):
    """The JAX package's ``prepare_predictions`` + ``compute_errors`` on a
    scene's dumped predictions."""
    from gasfm_tpu.config import load_config as jax_load_config
    from gasfm_tpu.data.loaders import create_scene_data
    from gasfm_tpu.eval.metrics import compute_errors, prepare_predictions

    pred = np.load(pred_path)
    conf = jax_load_config(SYNTH, external_params=conf_ext)
    outputs = prepare_predictions(create_scene_data(conf, scene=scene), {
        "Ps_norm": pred["Ps_norm"], "pts3D": pred["pts3D_pred"]}, conf, False)
    return compute_errors(outputs, conf, False)


def assert_tables_match(port_exp, jax_exp, name, conf_ext):
    """The port's table against the JAX CLI's: the same columns and rows;
    every value within rtol 1e-4 (+ 1e-3, the CSV's rounding) but the wall
    times and the ill-conditioned metrics; those, per scene, the JAX
    battery's on the port's dumped predictions, which agree with the JAX
    CLI's at ``tests/test_torch_port_model.py``'s forward tolerance."""
    want = pd.read_csv(jax_exp / name, index_col=0)
    got = pd.read_csv(port_exp / name, index_col=0)
    assert list(got.columns) == list(want.columns)
    assert list(got.index) == list(want.index)
    scenes = [k for k in got.index if k != "Mean"]
    assert scenes
    for col in want.columns:
        if col in WALL_TIMES + ILL_CONDITIONED:
            continue
        np.testing.assert_allclose(got[col].to_numpy(float), want[col].to_numpy(float),
                                   rtol=1e-4, atol=1e-3 + 1e-9, equal_nan=True,
                                   err_msg=f"{name}: {col}")
    phase_dir, file_name = predictions_of(name)
    for scene in scenes:
        path = (phase_dir, scene, "predictions", file_name)
        mine, theirs = np.load(port_exp.joinpath(*path)), np.load(jax_exp.joinpath(*path))
        for key in ("Ps_norm", "pts3D_pred", "Ps", "Rs", "ts"):
            assert_close(mine[key], theirs[key], f"{name}: {scene} {key}")
        battery = jax_battery(conf_ext, scene, port_exp.joinpath(*path))
        for col in ILL_CONDITIONED:
            v = battery[col]
            assert abs(got.loc[scene, col] - round(v, 3)) <= 1e-3 + 1e-6 * abs(v), (
                name, scene, col, got.loc[scene, col], v)


@pytest.mark.parametrize("name", [f"{w}_{s}_errors.csv" for w in ("final", "best")
                                  for s in ("train", "val", "test")]
                         + ["final_train_errors_FINE_TUNE_from_final.csv"])
def test_carried_weights_tables_match_jax(runs, name):
    assert_tables_match(runs["port", "cut"], runs["jax", "cut"], name, CUT)


@pytest.mark.parametrize("name", [f"{w}_{s}_errors{o}.csv" for w in ("final", "best")
                                  for s in ("train", "val", "test")
                                  for o in ("_outlier_rate0.10", "")])
def test_outlier_evaluation_tables_match_jax(runs, name):
    assert_tables_match(runs["port", "outliers"], runs["jax", "outliers"], name, OUTLIERS)


def test_outliers_change_the_evaluation(runs):
    exp = runs["port", "outliers"]
    with_outliers = pd.read_csv(exp / "final_val_errors_outlier_rate0.10.csv", index_col=0)
    clean = pd.read_csv(exp / "final_val_errors.csv", index_col=0)
    assert (with_outliers["our_repro"] != clean["our_repro"]).all()


def test_cli_runs_the_synthetic_conf_as_shipped(tmp_path, runs):
    """``python -m gasfm_tpu_torch.main multi-scene-learning`` on the
    shipped synthetic conf (10 epochs, all phases) writes the cut run's
    tree, with the conf's 3 training and 2 test scenes, plus fine-tuning
    from the best weights and short optimization, each as fine-tuning from
    the final weights writes it."""
    env = dict(os.environ, GASFM_RESULTS_PATH=str(tmp_path), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "gasfm_tpu_torch.main", "multi-scene-learning", "--conf", SYNTH,
         "--device", "cpu", "--exp-dir", "e"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]

    def same(paths):  # one scene per set; the best epochs' weight files aside
        return {p.replace("synth_test1", "synth_test0").replace("synth_train2", "synth_train1")
                for p in paths if "model_epoch" not in p}

    got = tree(tmp_path / "e")
    cut = same(tree(runs["port", "cut"]))
    mirrored = {p.replace("FINE_TUNE_from_final", other) for p in cut
                for other in ("FINE_TUNE_from_best", "SHORT_OPTIMIZATION")
                if "FINE_TUNE_from_final" in p}
    assert same(got) == cut | mirrored
    assert any(p.startswith("models/model_epoch") for p in got)
    assert {"FINE_TUNE_from_best/synth_test1/models/final_model.npz",
            "TRAINING/synth_train2/predictions/best_predictions.npz"} <= got
    stats = pd.read_csv(tmp_path / "e" / "train_stats.csv", index_col=0)
    assert np.isfinite(stats["best_validation_metric"]).all()


# -- gradient accumulation over a batch ------------------------------------------------------


def dpesfm_conf(package):
    ext = ["model.num_features=32", "dataset.min_num_views_sampled=6",
           "dataset.max_num_views_sampled=12"]
    if package == "jax":
        from gasfm_tpu.config import load_config
    else:
        from gasfm_tpu_torch.config import load_config
    return load_config(DPESFM, external_params=ext)


@pytest.fixture(scope="module")
def batch_run(tmp_path_factory):
    """The JAX session's and the port's gradients of one batch of 4 sampled
    scenes, and the parameters after an epoch of that batch with outliers."""
    from gasfm_tpu.data.scene import SceneData as JaxSceneData
    from gasfm_tpu.models import get_model as jax_get_model
    from gasfm_tpu.train.loop import TrainingSession as JaxSession
    from gasfm_tpu.train.loop import epoch_train as jax_epoch_train
    from gasfm_tpu.utils.phases import Phases as JaxPhases

    from gasfm_tpu_torch.data.dataset import SceneLoader, ScenesDataSet
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.models import get_model
    from gasfm_tpu_torch.models.convert import params_from_jax
    from gasfm_tpu_torch.train.loop import TrainingSession, epoch_train
    from gasfm_tpu_torch.utils.phases import Phases

    jconf, pconf = dpesfm_conf("jax"), dpesfm_conf("port")
    params = jax_init(DPESFM, tmp_path_factory.mktemp("dp") / "init.npz",
                      ["model.num_features=32"])
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))  # before any donation
    scenes = [generate_synthetic_scene(n_views=16, n_points=150, visibility=0.6, seed=40 + i,
                                       calibrated=True) for i in range(4)]
    ds = ScenesDataSet(scenes, return_all=False, min_num_views_sampled=6,
                       max_num_views_sampled=12, inplane_rot_aug_max_angle=15.0,
                       tilt_rot_aug_max_angle=20.0)
    batch = next(iter(SceneLoader(ds, batch_size=4, shuffle=True,
                                  rng=np.random.default_rng(3))))
    assert len(batch) == 4 and len({d.num_views for d in batch}) > 1
    jbatch = [JaxSceneData(d.M, d.Ns, d.y, d.scene_name, calibrated=True) for d in batch]

    jsession = JaxSession(jconf, jax_get_model(jconf))
    jgrads = None
    for d in jbatch:
        _, _, g = jsession.loss_and_grads(params, jsession.bucketize(d))
        jgrads = g if jgrads is None else jsession.accumulate(jgrads, g)
    opt_state = jsession.tx.init(params)
    jparams, _, _, _, _, _ = jax_epoch_train(
        jconf, jsession, [jbatch], params, opt_state, 0, 0, JaxPhases.TRAINING, None,
        outlier_injection_rate=0.1, rng=np.random.default_rng(11))

    def port_session():
        model = get_model(pconf, generator=torch.Generator().manual_seed(0))
        model.load_state_dict(state)
        return TrainingSession.from_conf(pconf, model, device="cpu")

    session = port_session()
    pgrads = None
    for d in batch:
        _, _, g = session.loss_and_grads(session.scene_graph(d))
        pgrads = g if pgrads is None else session.accumulate(pgrads, g)
    trained = port_session()
    epoch_train(pconf, trained, [batch], 0, 0, Phases.TRAINING, None,
                outlier_injection_rate=0.1, rng=np.random.default_rng(11))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(session=session, jgrads=to_np(jgrads), pgrads=pgrads, jparams=to_np(jparams),
                trained=trained, lr=pconf.get_float("train.lr"))


def port_tree(session, tensors):
    from gasfm_tpu.models.convert import convert_reference_state_dict

    names = [k for k, p in session.model.named_parameters() if p.requires_grad]
    return convert_reference_state_dict(
        {k: t.detach().numpy() for k, t in zip(names, tensors)}, "SetOfSet.SetOfSetNet")


def leaf_pairs(got, want):
    g, w = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    ks = jax.tree_util.keystr
    assert [ks(k) for k, _ in g] == [ks(k) for k, _ in w]
    return [(ks(k), np.asarray(a), np.asarray(b)) for (k, a), (_, b) in zip(g, w)]


def test_accumulated_batch_gradients_match_jax(batch_run):
    pairs = leaf_pairs(port_tree(batch_run["session"], batch_run["pgrads"]), batch_run["jgrads"])
    G = max(float(np.abs(w).max()) for _, _, w in pairs)
    n_noise = 0
    for name, got, want in pairs:
        scale = float(np.abs(want).max())
        if scale < NOISE * G:
            n_noise += 1
            np.testing.assert_array_less(np.abs(got), NOISE * G, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=1e-3, err_msg=name)
    assert n_noise < len(pairs) // 2


def test_accumulate_returns_new_tensors(batch_run):
    session = batch_run["session"]
    a = [torch.ones(3), torch.zeros(2)]
    b = [torch.full((3,), 2.0), torch.ones(2)]
    out = session.accumulate(a, b)
    assert [t.tolist() for t in out] == [[3.0] * 3, [1.0] * 2]
    assert all(o is not x for o, x in zip(out, a + b))
    assert a[0].tolist() == [1.0] * 3


def test_batch_epoch_with_outliers_matches_jax_update(batch_run):
    trained = batch_run["trained"]
    params = [p for p in trained.model.parameters() if p.requires_grad]
    first = {name: w for name, _, w in leaf_pairs(batch_run["jgrads"], batch_run["jgrads"])}
    G = max(float(np.abs(w).max()) for w in first.values())
    moved = 0
    for name, got, want in leaf_pairs(port_tree(trained, params), batch_run["jparams"]):
        if float(np.abs(first[name]).max()) < NOISE * G:
            np.testing.assert_array_less(np.abs(got - want), 2.0 * 1.01 * batch_run["lr"],
                                         err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4, err_msg=name)
        moved += 1
    assert moved == len(first)
    assert trained.optimizer.schedule_count == 1
    assert float(trained.optimizer.adam.state[params[0]]["step"]) == 1


# -- the session's memory ---------------------------------------------------------------------


@pytest.fixture
def stand_in(monkeypatch):
    """Sessions take the recorded path on the CPU with the stand-in graph."""
    from gasfm_tpu_torch.train import loop

    monkeypatch.setattr(loop, "_Program", ReplayStandIn)
    monkeypatch.setattr(loop, "_eager_on", lambda stream, fn, *args: fn(*args))

    def make(conf):
        from gasfm_tpu_torch.models import get_model

        model = get_model(conf, generator=torch.Generator().manual_seed(0))
        session = loop.TrainingSession.from_conf(conf, model, device="cpu")
        session.capture = True
        return session

    return make


def held(session):
    """(scene graphs held, per-scene entries, recordings) of a session."""
    return (len(session._cache.graphs), len(session._cache.calls),
            sorted(kind for kind, _ in session.recordings()))


def test_sampled_epochs_keep_the_session_caches_bounded(tmp_path, stand_in, monkeypatch):
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.experiments import create_eval_dataloaders, train_model
    from gasfm_tpu_torch.train import loop
    from gasfm_tpu_torch.utils.phases import Phases

    conf = load_config(SYNTH, external_params=["train.n_epochs=6", "eval.eval_interval=2",
                                               "eval.eval_on_train_set=true"])
    conf.put("exp_dir", "mem")
    session = stand_in(conf)
    after = []
    inner = loop.epoch_train

    def probe(*args, **kwargs):
        out = inner(*args, **kwargs)
        after.append(held(session))
        return out

    monkeypatch.setattr(loop, "epoch_train", probe)
    datasets, loaders = create_eval_dataloaders(conf, rng=np.random.default_rng(0))
    fixed = [d for key in ("train_set_for_eval", "validation_set") for d in datasets[key].data_list]
    with results_root(tmp_path):
        train_model(conf, session, datasets["train_set"], loaders, Phases.TRAINING,
                    rng=np.random.default_rng(0))
    assert len(after) == 6
    n_fixed = len(fixed)
    # read after each epoch's training, before its evaluation: the first
    # evaluation (after epoch 1) warms the fixed scenes' forwards up, the
    # second (after epoch 2) records them; from then on the session holds
    # the fixed scenes' graphs and forward recordings, and nothing of the
    # 3 x 6 sampled scenes
    assert after[0] == (0, 0, [])
    assert after[1] == (n_fixed, n_fixed, [])
    assert after[2:] == [(n_fixed, n_fixed, ["forward"] * n_fixed)] * 4
    graphs = {id(session.scene_graph(d)) for d in fixed}
    assert {id(s) for _, s in session.recordings()} == graphs


def test_a_new_scene_never_receives_a_dropped_ones_graph(stand_in):
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene

    session = stand_in(load_config(SYNTH))
    for i in range(15):
        data = generate_synthetic_scene(n_views=5 + i % 4, n_points=30 + i, seed=i,
                                        calibrated=True)
        scene = session.scene_graph(data)
        np.testing.assert_array_equal(scene.graph.uv.numpy(), data.host_graph().uv)
        assert scene.graph.num_edges == int(data.valid_pts.sum())
        for _ in range(3 if i % 5 == 0 else 1):  # some scenes record their step
            session.fused_step(scene)
        if i % 5 == 0:
            assert ("fused_step", scene) in [(k, s) for k, s in session.recordings()]
        del data, scene  # freed by reference counting: no collection needed
        assert held(session) == (0, 0, [])
    # an entry left under a reused id (its graph dead) is never handed out
    import weakref

    from gasfm_tpu_torch.train import loop

    data = generate_synthetic_scene(n_views=6, n_points=40, seed=99, calibrated=True)
    scene = session.scene_graph(data)
    stale = loop._Calls(weakref.ref(data))  # a ref to another object
    stale.programs["fused_step"] = "a dead scene's recording"
    session._cache.calls[id(scene)] = stale
    fresh = session._cache.of(scene)
    assert fresh is not stale and fresh.ref() is scene and not fresh.programs


def test_view_curriculum_releases_each_stage(tmp_path, stand_in, monkeypatch):
    from gasfm_tpu.data.sampling import get_subset as jax_get_subset
    from gasfm_tpu.data.scene import SceneData as JaxSceneData

    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.data.dataset import SceneLoader, ScenesDataSet
    from gasfm_tpu_torch.data.loaders import create_scene_data
    from gasfm_tpu_torch.train import loop
    from gasfm_tpu_torch.utils.phases import Phases

    conf = load_config("synth/optim_synth_gasfm.conf", external_params=[
        "train.n_epochs=3", "eval.eval_interval=100", "train.sequentially_increment_views=true",
        "train.increment_views_interval=2", "train.lr_schedule.lr_warmup_n_steps=0"])
    conf.put("exp_dir", "curriculum")
    data = create_scene_data(conf)
    assert loop.curriculum_epochs(conf, Phases.OPTIMIZATION, data) == (data.num_views - 1) * 2
    assert loop.curriculum_epochs(conf, Phases.TRAINING, data) == 0
    session = stand_in(conf)
    stages = []
    inner = loop.epoch_train

    def probe(conf_, session_, loader, *args, **kwargs):
        out = inner(conf_, session_, loader, *args, **kwargs)
        stages.append((next(iter(loader))[0].num_views, held(session)))
        return out

    monkeypatch.setattr(loop, "epoch_train", probe)
    loader = SceneLoader(ScenesDataSet([data], return_all=True), batch_size=1, prefetch=0)
    with results_root(tmp_path):
        loop.train(conf, loader, session, Phases.OPTIMIZATION, rng=np.random.default_rng(0))
    n = data.num_views
    assert len(stages) == (n - 1) * 2 + 3
    assert [v for v, _ in stages] == [min(2 + k // 2, n) for k in range(len(stages))]
    for k, (views, (graphs, entries, kinds)) in enumerate(stages):
        # the full scene (evaluated) and the current stage, never an earlier one
        assert graphs <= 2 and entries <= 2, (k, views, graphs, entries)
        assert kinds.count("fused_step") <= 1, (k, kinds)
    # each stage's views are the JAX package's greedy subset
    jdata = JaxSceneData(data.M, data.Ns, data.y, data.scene_name, calibrated=True)
    from gasfm_tpu_torch.data.sampling import get_subset

    for views in range(2, n):
        np.testing.assert_array_equal(get_subset(data, views).M, jax_get_subset(jdata, views).M)
