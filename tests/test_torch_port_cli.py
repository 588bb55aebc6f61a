"""The port's CLI (``python -m gasfm_tpu_torch.main ... --device cpu``) on
the CPU, against the JAX package's CLI and pandas / tensorboard as oracles.

- Carried weights: a JAX init (``model.init``, ``save_params``) of
  ``synth/optim_synth_dpesfm.conf``, trained 150 epochs by the JAX CLI; its
  ``final_model.npz`` through ``--pretrained-model-path`` into both CLIs with
  ``train.lr = 0`` (3 epochs, evaluations at init and epochs 1 and 3,
  ``ba.num_threads = 1``). Then:
  - the same artifact tree (relative paths; the event file's name and the
    code snapshot's package directory normalized) and the same
    ``exp.conf.json``;
  - the same results columns and ``Scene`` index;
  - every value of the results row within float32 tolerance (rtol 1e-4,
    plus 1e-3 for the CSV's 3 decimals), ``repro_ba`` included, except the
    wall times (``Inference time``, ``ba_time``) and two metrics that these
    predictions (``our_repro`` ~40 px after 150 epochs) make ill-conditioned:
    ``triangulated_repro`` (the DLT re-triangulation with the predicted
    cameras, ~290 px) and ``t_err_med`` (the median after the sum-of-norms
    alignment's iterations) turn the two packages' float32 rounding of the
    predictions (~1e-7) into up to ~1e-3 and ~1e-4 of the metric. For them,
    and for every other metric, the JAX package's ``prepare_predictions`` +
    ``compute_errors`` run on the port's dumped predictions give the port's
    values (the CSV's rounding; the event file's float32), and the port's
    predictions equal the JAX CLI's within rtol 1e-4;
  - the same event tags and steps, values within rtol 1e-4 (the same two
    exceptions).
- The JAX end-to-end properties (``tests/test_e2e.py:69-137``) through the
  port's CLI: 150 epochs of the DPESFM synth conf at least halve
  ``our_repro`` from the initial evaluation's (read from the event file),
  with ``repro_ba <= our_repro + 1e-6``; the projective GASFM synth conf the
  same through ``proj_ba``.
- Each of the four single-scene synthetic confs runs a few epochs through
  the CLI and writes the tree (the GASFM one as ``python -m``), with
  checkpoints whose resume continues a run bitwise as if unbroken.
- The port's results CSV against pandas: parse-equal on the same rows with
  NaN, ints, the ``Mean`` row, ``round(3)`` and the append-merge by
  ``Scene`` (the JAX package's ``write_results`` as the oracle), both ways.
- The port's event file read by ``tensorboard``'s ``EventAccumulator``: the
  same tags, steps and values as the JAX package's writer records for the
  same logging calls.
"""

import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

REPO = Path(__file__).resolve().parents[1]
DPESFM = "synth/optim_synth_dpesfm.conf"
CARRY_EXT = ["train.lr=0", "train.n_epochs=3", "eval.eval_interval=2", "ba.num_threads=1",
             "ba.print_out=false"]
WALL_TIMES = ("Inference time", "ba_time")
ILL_CONDITIONED = ("triangulated_repro", "t_err_med")


class results_root:
    """GASFM_RESULTS_PATH set to ``path`` (both packages' results root) for
    the block; the process-wide event writers closed after it."""

    def __init__(self, path):
        self.path = str(path)

    def __enter__(self):
        self.old = os.environ.get("GASFM_RESULTS_PATH")
        os.environ["GASFM_RESULTS_PATH"] = self.path

    def __exit__(self, *exc):
        import gasfm_tpu.utils.observability as jax_obs
        import gasfm_tpu_torch.utils.observability as obs

        jax_obs.reset_tb_writer()
        obs.reset_tb_writer()
        if self.old is None:
            os.environ.pop("GASFM_RESULTS_PATH", None)
        else:
            os.environ["GASFM_RESULTS_PATH"] = self.old


def port_cli(root, conf, exp, ext=(), extra=()):
    from gasfm_tpu_torch.main import main

    with results_root(root):
        assert main(["single-scene-optim", "--conf", conf, "--exp-dir", exp, "--device", "cpu",
                     *extra, "--external-params", *ext]) == 0
    return Path(root) / exp


def jax_cli(root, conf, exp, ext=(), extra=()):
    from gasfm_tpu.main import main

    with results_root(root):
        assert main(["single-scene-optim", "--conf", conf, "--exp-dir", exp, *extra,
                     "--external-params", *ext]) == 0
    return Path(root) / exp


def tree(exp: Path):
    """The experiment's files, relative; the event file's name and the code
    snapshot's files normalized to their package's directory."""
    out = set()
    for p in exp.rglob("*"):
        rel = p.relative_to(exp).as_posix()
        parts = rel.split("/")
        if parts[0] == "code" and len(parts) > 1 and parts[1].startswith("gasfm_tpu"):
            out.add("code/<package>")
        elif parts[0] == "tb" and len(parts) == 2 and parts[1].startswith("events.out.tfevents."):
            out.add("tb/events.out.tfevents.<time>.<host>.<pid>.<n>")
        else:
            out.add(rel)
    return out


def scalars(tb_dir, runs=1):
    """{tag: [(step, value)]} of the event files of ``runs`` CLI runs in
    ``tb_dir`` (one file per run, read in order)."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    files = glob.glob(os.path.join(tb_dir, "events.out.tfevents.*"))
    assert len(files) == runs, files
    ea = EventAccumulator(str(tb_dir))
    ea.Reload()
    return {t: [(e.step, e.value) for e in ea.Scalars(t)] for t in ea.Tags()["scalars"]}


def results(exp: Path, name="final_train_errors_OPTIMIZATION.csv"):
    return pd.read_csv(exp / name).set_index("Scene")


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """Both CLIs from the same JAX-trained weights; returns their
    experiment directories and the weights file."""
    import jax

    from gasfm_tpu.config import load_config as jax_load_config
    from gasfm_tpu.data.synthetic import generate_synthetic_scene
    from gasfm_tpu.models import get_model
    from gasfm_tpu.train.state import save_params

    tmp = tmp_path_factory.mktemp("carried")
    model = get_model(jax_load_config(DPESFM))
    probe = generate_synthetic_scene(n_views=8, n_points=64, seed=0).to_scene_graph().graph
    init = tmp / "jax_init.npz"
    save_params(str(init), jax.jit(model.init)(jax.random.PRNGKey(5), probe))
    trained = jax_cli(tmp / "train", DPESFM, "e", ["train.n_epochs=150", "eval.eval_init=false",
                                                    "eval.eval_interval=1000", "ba.run_ba=false"],
                      ["--pretrained-model-path", str(init)])
    weights = trained / "OPTIMIZATION" / "synth0" / "models" / "final_model.npz"
    extra = ["--pretrained-model-path", str(weights)]
    return (jax_cli(tmp / "jax", DPESFM, "e", CARRY_EXT, extra),
            port_cli(tmp / "port", DPESFM, "e", CARRY_EXT, extra))


def test_carried_weights_same_artifact_tree(carried):
    jax_exp, port_exp = carried
    assert tree(port_exp) == tree(jax_exp)
    assert (port_exp / "code" / "gasfm_tpu_torch" / "main.py").exists()
    assert not list((port_exp / "code").rglob("*.so"))
    assert not (port_exp / "code" / "gasfm_tpu_torch" / "_build").exists()
    assert (json.loads((port_exp / "code" / "exp.conf.json").read_text())
            == json.loads((jax_exp / "code" / "exp.conf.json").read_text()))


def test_carried_weights_same_results_columns_and_values(carried):
    jax_exp, port_exp = carried
    want, got = results(jax_exp), results(port_exp)
    assert list(got.columns) == list(want.columns)
    assert list(got.index) == list(want.index) == ["synth0"]
    assert "repro_ba" in got.columns
    for col in want.columns:
        if col in WALL_TIMES + ILL_CONDITIONED:
            continue
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(), rtol=1e-4,
                                   atol=1e-3 + 1e-9, equal_nan=True, err_msg=col)


def jax_battery(exp: Path):
    """The JAX package's ``prepare_predictions`` + ``compute_errors`` (with
    bundle adjustment) on the final predictions an experiment dumped."""
    from gasfm_tpu.config import load_config as jax_load_config
    from gasfm_tpu.data.loaders import create_scene_data
    from gasfm_tpu.eval.metrics import compute_errors, prepare_predictions

    pred = np.load(exp / "OPTIMIZATION" / "synth0" / "predictions" / "final_predictions.npz")
    conf = jax_load_config(DPESFM, external_params=CARRY_EXT)
    outputs = prepare_predictions(create_scene_data(conf), {
        "Ps_norm": pred["Ps_norm"], "pts3D": pred["pts3D_pred"]}, conf, True)
    return compute_errors(outputs, conf, True)


def test_carried_weights_port_row_is_the_jax_battery_on_its_predictions(carried):
    jax_exp, port_exp = carried
    pred_path = ("OPTIMIZATION", "synth0", "predictions", "final_predictions.npz")
    port_pred = np.load(port_exp.joinpath(*pred_path))
    jax_pred = np.load(jax_exp.joinpath(*pred_path))
    for key in ("Ps_norm", "pts3D_pred", "Ps", "Rs", "ts"):
        np.testing.assert_allclose(port_pred[key], jax_pred[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    want = jax_battery(port_exp)
    got = results(port_exp).loc["synth0"]
    for col, v in want.items():
        if col not in WALL_TIMES:
            assert abs(got[col] - round(v, 3)) <= 1e-3 + 1e-6 * abs(v), (col, got[col], v)


def test_carried_weights_same_events(carried):
    """The same tags and steps; the values within rtol 1e-4 of the JAX CLI's
    (the ill-conditioned metrics excepted), and every evaluation's value the
    float32 of the JAX battery on the port's predictions (lr = 0: every
    evaluation sees the final predictions)."""
    jax_exp, port_exp = carried
    want, got = scalars(jax_exp / "tb"), scalars(port_exp / "tb")
    assert sorted(got) == sorted(want)
    assert len(got) == 18  # 14 eval metrics, 4 per-step signals
    battery = jax_battery(port_exp)
    for tag, rows in want.items():
        steps, values = zip(*rows)
        assert [s for s, _ in got[tag]] == list(steps), tag
        mine = [v for _, v in got[tag]]
        if not tag.endswith(ILL_CONDITIONED):
            np.testing.assert_allclose(mine, values, rtol=1e-4, atol=1e-7, err_msg=tag)
        metric = tag.split("/")[-1]
        if "-eval/" in tag:
            np.testing.assert_allclose(mine, np.float32(battery[metric]), rtol=1e-6, atol=1e-7,
                                       err_msg=tag)


def initial_our_repro(exp: Path) -> float:
    rows = scalars(exp / "tb")["OPTIMIZATION-eval/synth0/epoch/our_repro"]
    return dict(rows)[0]  # step 0: the evaluation before the first epoch


@pytest.mark.parametrize("conf", [DPESFM, "synth/optim_synth_proj_gasfm.conf"])
def test_cli_optimization_improves_and_ba_refines(tmp_path, conf):
    exp = port_cli(tmp_path, conf, "e2e", ["train.n_epochs=150", "eval.eval_interval=1000",
                                           "ba.print_out=false"])
    final = results(exp).loc["synth0"]
    assert np.isfinite(final["our_repro"])
    assert final["our_repro"] < 0.5 * initial_our_repro(exp)
    assert np.isfinite(final["repro_ba"])
    assert final["repro_ba"] <= final["our_repro"] + 1e-6
    if "proj" in conf:
        assert "R_err_mean" not in final.index  # uncalibrated: proj_ba, no rotations
    else:
        assert np.isfinite(final["R_err_mean"])


SYNTH = ["synth/optim_synth_gasfm.conf", DPESFM, "synth/optim_synth_proj_gasfm.conf",
         "synth/optim_synth_depth_gasfm.conf"]


@pytest.mark.parametrize("conf", SYNTH)
def test_cli_runs_each_synthetic_conf(tmp_path, conf):
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.main import init_model
    from gasfm_tpu_torch.train.state import load_params
    from gasfm_tpu_torch.utils.observability import eval_metric_columns

    ext = ["train.n_epochs=4", "eval.eval_interval=2", "ba.print_out=false"]
    if conf == SYNTH[0]:  # as a user runs it
        env = dict(os.environ, GASFM_RESULTS_PATH=str(tmp_path))
        proc = subprocess.run([sys.executable, "-m", "gasfm_tpu_torch.main", "--conf", conf,
                               "single-scene-optim", "--device", "cpu", "--exp-dir", "e",
                               "--external-params", *ext],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        exp = tmp_path / "e"
    else:
        exp = port_cli(tmp_path, conf, "e", ext)
    pconf = load_config(conf)
    scene = exp / "OPTIMIZATION" / "synth0"
    files = tree(exp)
    for f in ("final_train_errors_OPTIMIZATION.csv", "final_train_errors_OPTIMIZATION.xlsx",
              "code/exp.conf.json", "code/<package>",
              "tb/events.out.tfevents.<time>.<host>.<pid>.<n>",
              "OPTIMIZATION/synth0/models/final_model.npz",
              "OPTIMIZATION/synth0/predictions/final_predictions.npz"):
        assert f in files, (f, sorted(files))
    explicit = pconf.get_bool("model.view_head.enabled")
    has_plot = "OPTIMIZATION/synth0/plots/final_plots.html" in files
    assert has_plot == (explicit and pconf.get_bool("dataset.calibrated"))
    run_ba = pconf.get_bool("ba.run_ba")
    cols = eval_metric_columns(pconf, include_post_ba_metrics=run_ba)
    table = results(exp)
    assert set(cols) <= set(table.columns) and list(table.index) == ["synth0"]
    tags = scalars(exp / "tb")
    for col in eval_metric_columns(pconf, include_post_ba_metrics=False):
        assert [s for s, _ in tags[f"OPTIMIZATION-eval/synth0/epoch/{col}"]] == [0, 1, 2, 4]
    model, _ = init_model(pconf)
    load_params(str(scene / "models" / "final_model.npz"), model)


def test_cli_profiler_window_writes_a_trace(tmp_path, capsys):
    exp = port_cli(tmp_path, DPESFM, "prof", ["train.n_epochs=4", "eval.eval_interval=1000",
                                              "ba.run_ba=false",
                                              "observability.profile_start_epoch=1",
                                              "observability.profile_n_epochs=2"])
    assert "[profiler] epochs 2..3: wall" in capsys.readouterr().out
    trace = exp / "tb" / "profile" / "trace_epoch000002.json"
    assert json.loads(trace.read_text())["traceEvents"]


def test_cli_checkpoints_resume_as_an_unbroken_run(tmp_path):
    ckpt = ["checkpoint.enabled=true", "checkpoint.interval=2", "checkpoint.resume=true",
            "eval.eval_interval=1000", "ba.run_ba=false"]
    straight = port_cli(tmp_path, DPESFM, "straight", ["train.n_epochs=6"] + ckpt)
    first = port_cli(tmp_path, DPESFM, "resumed", ["train.n_epochs=4"] + ckpt)
    state = first / "OPTIMIZATION" / "synth0" / "models" / "train_state"
    assert sorted(p.name for p in state.iterdir()) == ["step_000000002.pt", "step_000000004.pt"]
    resumed = port_cli(tmp_path, DPESFM, "resumed", ["train.n_epochs=6"] + ckpt)
    weights = ("OPTIMIZATION", "synth0", "models", "final_model.npz")
    a, b = np.load(straight.joinpath(*weights)), np.load(resumed.joinpath(*weights))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the second run logged steps 5 and 6, at the straight run's values
    tag = "OPTIMIZATION-train/synth0/batch/loss"
    got = scalars(resumed / "tb", runs=2)[tag]
    assert [s for s, _ in got] == [1, 2, 3, 4, 5, 6]
    assert got == scalars(straight / "tb")[tag]


# -- the results table against pandas --------------------------------------------


def records():
    nan = float("nan")
    return [
        {"Scene": "a", "our_repro": 1.23456, "ba_converged1": 1, "n_pts": 100, "x": nan},
        {"Scene": "b b", "our_repro": 2.5, "ba_converged1": 0, "n_pts": 7, "x": 0.1 + 0.2,
         "late": 3.0004999},
        {"Scene": "c,d", "our_repro": nan, "ba_converged1": 1, "n_pts": 12, "x": 1e-7},
    ]


def test_table_csv_parses_as_pandas_writes_it(tmp_path):
    from gasfm_tpu_torch.utils.tables import Table

    table = Table.from_records(records())
    frame = pd.DataFrame(records()).set_index("Scene")
    for got, want in ((table, frame),
                      (table.with_mean(), pd.concat([frame, frame.mean(axis=0, numeric_only=True)
                                                     .to_frame(name="Mean").T])),
                      (table.with_mean().round(3),
                       pd.concat([frame, frame.mean(axis=0, numeric_only=True)
                                  .to_frame(name="Mean").T]).round(3))):
        want.index.name = "Scene"
        got.to_csv(tmp_path / "port.csv")
        want.to_csv(tmp_path / "pandas.csv", na_rep="NULL")
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port.csv"),
                                      pd.read_csv(tmp_path / "pandas.csv"))
        back = Table.read_csv(str(tmp_path / "pandas.csv"))
        assert back.columns == got.columns and back.index == got.index
        for c in got.columns:
            np.testing.assert_array_equal(np.asarray(back.column(c), dtype=float),
                                          np.asarray(got.column(c), dtype=float), err_msg=c)
    assert table.with_mean().loc("Mean", "n_pts") == pytest.approx(119 / 3)
    with pytest.raises(KeyError):
        table.loc("Mean", "our_repro")
    with pytest.raises(KeyError):
        table.loc("a", "missing")


def test_write_results_appends_as_the_jax_package_does(tmp_path):
    from gasfm_tpu.utils.observability import write_results as jax_write_results

    from gasfm_tpu_torch.config import ConfigFactory
    from gasfm_tpu_torch.utils.observability import write_results
    from gasfm_tpu_torch.utils.tables import Table

    rows = records()
    batches = [rows[:2], rows[2:] + [{"Scene": "a", "our_repro": 9.0, "new": 4}]]
    with results_root(tmp_path):
        for exp, write, make in (
                ("port", write_results, lambda r: Table.from_records(r).round(3)),
                ("jax", jax_write_results, lambda r: pd.DataFrame(r).set_index("Scene").round(3))):
            conf = ConfigFactory.from_dict({"exp_dir": exp})
            for batch in batches:
                path = write(conf, make(batch), file_name="final_train_errors_OPTIMIZATION",
                             additional_identifiers=["id"], append=True)
    name = "final_train_errors_OPTIMIZATION_id"
    got = pd.read_csv(tmp_path / "port" / f"{name}.csv")
    want = pd.read_csv(tmp_path / "jax" / f"{name}.csv")
    pd.testing.assert_frame_equal(got, want)
    assert list(got["Scene"]) == ["a", "b b", "c,d", "a"]
    assert (tmp_path / "port" / f"{name}.xlsx").exists()


# -- the event file against tensorboard's reader and the JAX package's writer --


def test_event_file_matches_the_jax_writer(tmp_path):
    import gasfm_tpu.utils.observability as jax_obs
    import gasfm_tpu_torch.utils.observability as obs
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.utils.phases import Phases
    from gasfm_tpu_torch.utils.tables import Table
    from gasfm_tpu.utils.phases import Phases as JaxPhases

    conf = load_config(DPESFM)
    cols = obs.eval_metric_columns(conf, include_post_ba_metrics=True)
    rng = np.random.default_rng(0)
    rows = [dict({c: float(v) for c, v in zip(cols[:-1], rng.normal(size=len(cols)) * 100)},
                 Scene="synth0")]  # the last metric missing: skipped by both
    rows[0]["our_repro"] = 1e40  # beyond float32: inf in both
    with results_root(tmp_path):
        for exp, module, phases, table in (
                ("port", obs, Phases, Table.from_records(rows).with_mean()),
                ("jax", jax_obs, JaxPhases, pd.concat([
                    pd.DataFrame(rows).set_index("Scene"),
                    pd.DataFrame(rows).set_index("Scene").mean(numeric_only=True)
                    .to_frame(name="Mean").T]))):
            c = conf.copy()
            c.put("exp_dir", exp)
            writer = module.get_tb_writer(c)
            for step in range(5):
                module.tb_log_train_step(writer, step, "loss", 0.5 ** step, phases.OPTIMIZATION,
                                         ["x"], scene="synth 0")
                module.tb_log_train_step(writer, step, "grad_norm", -3.25 * step,
                                         phases.OPTIMIZATION, [], scene="synth0")
            for epoch in (-1, 0, 9):
                module.tb_log_eval_step(c, writer, epoch, table, phase=phases.OPTIMIZATION,
                                        scene="synth0", include_post_ba_metrics=True)
            module.reset_tb_writer()
    got, want = scalars(tmp_path / "port" / "tb"), scalars(tmp_path / "jax" / "tb")
    assert sorted(got) == sorted(want)
    assert len(got) == 2 + len(cols) - 1
    assert "OPTIMIZATION-train/x/synth0/batch/loss" in got
    for tag in want:
        assert got[tag] == want[tag], tag


# -- what the port does not run yet raises -----------------------------------------


@pytest.mark.parametrize("what", ["multi-scene-learning", "sequential-views", "outliers",
                                  "training-phase", "view-sampling", "prefetch"])
def test_unported_options_raise_and_name_slice_5(tmp_path, what):
    from gasfm_tpu_torch.data.dataset import SceneLoader, ScenesDataSet
    from gasfm_tpu_torch.main import main
    from gasfm_tpu_torch.train.loop import train
    from gasfm_tpu_torch.utils.phases import Phases

    with pytest.raises(NotImplementedError, match="slice 5"):
        if what == "multi-scene-learning":
            main(["multi-scene-learning", "--conf", "synth/learning_synth_gasfm.conf",
                  "--device", "cpu"])
        elif what == "sequential-views":
            port_cli(tmp_path, DPESFM, "e", ["train.sequentially_increment_views=true",
                                             "train.increment_views_interval=2"])
        elif what == "outliers":
            port_cli(tmp_path, DPESFM, "e", ["train.outlier_injection_rate=0.1"])
        elif what == "training-phase":
            train(None, None, None, Phases.TRAINING)
        elif what == "view-sampling":
            ScenesDataSet([], return_all=False)
        else:
            SceneLoader(ScenesDataSet([], return_all=True), prefetch=2)
