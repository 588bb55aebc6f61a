"""The port's confs, conf reader and builders against the JAX package's, on
the CPU.

- The port's ``confs/`` is a byte-for-byte copy of the JAX package's; each
  of the 16 files parses in the port to the JAX parser's tree
  (``to_dict()``); external-param merges (scalars, lists, ``null``, nested
  paths and blocks) and the schema check's accepted and rejected keys
  equal the JAX package's on the same inputs.
- Every model conf builds a port model (``get_model``, on the meta device:
  no weights are made) whose ``state_dict`` maps key for key and shape for
  shape onto the JAX package's init tree for the same conf (from
  ``jax.eval_shape`` of its init, so the 109M-parameter confs cost no
  memory).
- The presets (``FLAGSHIP``, ``DPESFM``, ``FLAGSHIP_LOSS``, ``DPESFM_LOSS``,
  ``DEPTH_LOSS``, ``FLAGSHIP_OPTIM``, ``DPESFM_OPTIM``) equal what the
  builders return for their shipped confs.
- The learning rate at steps 0, 1, the warm-up's end and a milestone
  against the JAX package's ``schedule_from_conf`` for every model conf
  (rtol 1e-6, as tests/test_torch_port_train.py's schedule test); each
  clipping mode read from the conf, an unknown one an ``AssertionError``
  in both packages; the options the port has not ported raise, the TPU
  devices are accepted.
- Scenes: ``synthetic_scene_from_conf`` and ``create_scene_data`` give the
  JAX package's M, Ns and Ps_gt exactly (numpy on both sides), for each
  synthetic conf and for ``.npz`` archives written under ``Euclidean/``
  and ``Projective/`` (one of them ``PantheonParis``, with points seen in
  no view), with ``use_gt`` true and false, one by one and as a list.
- ``init_exp`` and ``init_model``; a weight file with another model's
  heads loads with those keys ignored and printed, as the JAX package's
  ``load_params`` does; a shape that differs raises in both.
"""

import argparse
import functools
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from gasfm_tpu.config import load_config as jax_load_config
from gasfm_tpu.config import load_ref_schema as jax_load_ref_schema
from gasfm_tpu.config.hocon import ConfigFactory as JaxConfigFactory
from gasfm_tpu.config.hocon import detect_schema_discrepancies as jax_schema
from gasfm_tpu.data.loaders import create_scene_data as jax_create_scene_data
from gasfm_tpu.data.loaders import create_scene_data_from_list as jax_create_scene_data_from_list
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.data.synthetic import synthetic_scene_from_conf as jax_scene_from_conf
from gasfm_tpu.models import get_model as jax_get_model
from gasfm_tpu.train.schedules import schedule_from_conf as jax_schedule_from_conf
from gasfm_tpu.train.state import build_optimizer as jax_build_optimizer
from gasfm_tpu.train.state import load_params as jax_load_params

from gasfm_tpu_torch.config import ConfigFactory, confs_dir, load_config, load_ref_schema
from gasfm_tpu_torch.config.hocon import detect_schema_discrepancies
from gasfm_tpu_torch.data.loaders import create_scene_data, create_scene_data_from_list
from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene, synthetic_scene_from_conf
from gasfm_tpu_torch.losses import (DEPTH_LOSS, DPESFM_LOSS, FLAGSHIP_LOSS, DirectDepthLoss,
                                    ESFMLoss, get_loss_func)
from gasfm_tpu_torch.main import init_exp, init_model
from gasfm_tpu_torch.models import get_model
from gasfm_tpu_torch.models.convert import _flax_path, _torch_key
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
from gasfm_tpu_torch.tools.profile_forward import DPESFM, FLAGSHIP
from gasfm_tpu_torch.train.loop import TrainingSession
from gasfm_tpu_torch.train.schedules import schedule_from_conf
from gasfm_tpu_torch.train.state import (DPESFM_OPTIM, FLAGSHIP_OPTIM, Optimizer,
                                         load_params, optim_from_conf, save_params)

REPO = Path(__file__).resolve().parents[1]
JAX_CONFS = REPO / "gasfm_tpu" / "confs"
CONF_FILES = sorted(str(p.relative_to(JAX_CONFS)) for p in JAX_CONFS.rglob("*.conf"))
MODEL_CONFS = [c for c in CONF_FILES if c != "ref.conf"]
SYNTH_SCENES = {"synth/optim_synth_gasfm.conf": None, "synth/optim_synth_dpesfm.conf": None,
                "synth/optim_synth_depth_gasfm.conf": None,
                "synth/optim_synth_proj_gasfm.conf": None,
                "synth/learning_synth_gasfm.conf": "synth_train1"}


def both(name, external_params=None):
    """(the port's conf, the JAX package's conf) of a shipped conf."""
    return (load_config(name, external_params=external_params),
            jax_load_config(str(JAX_CONFS / name), external_params=external_params))


def test_conf_copy_is_byte_identical():
    ours = Path(confs_dir())
    assert ours != JAX_CONFS and ours.is_relative_to(REPO / "gasfm_tpu_torch")
    files = sorted(str(p.relative_to(ours)) for p in ours.rglob("*") if p.is_file())
    assert files == CONF_FILES and len(files) == 16
    for name in files:
        assert (ours / name).read_bytes() == (JAX_CONFS / name).read_bytes(), name


@pytest.mark.parametrize("name", CONF_FILES)
def test_parse_matches_jax(name):
    got = ConfigFactory.parse_file(os.path.join(confs_dir(), name))
    want = JaxConfigFactory.parse_file(str(JAX_CONFS / name))
    assert got.to_dict() == want.to_dict()
    assert got.flatten() == want.flatten()


OVERRIDES = ["train.lr=0.5", 'dataset.test_set=["a", "b"]', "loss.grad_clip_mode=null",
             "model { view_head { n_hidden_layers = 5 } }", "model.depth_head.enabled=true",
             "train.lr_schedule.multistep_milestones=[10, 20]", "dataset.scene=Other"]


def test_external_params_merge_like_jax():
    got, want = both("dpesfm/learning_proj_noaug_dpesfm.conf", OVERRIDES)
    assert got.to_dict() == want.to_dict()
    assert got.get_float("train.lr") == 0.5 and got.get("loss.grad_clip_mode") is None
    assert got.get_list("dataset.test_set") == ["a", "b"]
    assert got.get_int("model.view_head.n_hidden_layers") == 5
    assert got.get_string("model.view_head.normalize_output") == "Differentiable Chirality"


def test_schema_check_like_jax():
    extra = ["train.bogus=1", "model.view_head.typo=2", "compile.chunk=512",
             "parallel.mesh_shape=[1, 1]"]
    for validate in (False, True):
        if validate:
            with pytest.raises(ValueError, match="train.bogus"):
                load_config("gasfm/optim_euc_gasfm.conf", external_params=extra)
            with pytest.raises(ValueError, match="train.bogus"):
                jax_load_config(str(JAX_CONFS / "gasfm/optim_euc_gasfm.conf"),
                                external_params=extra)
            continue
        got = load_config("gasfm/optim_euc_gasfm.conf", external_params=extra, validate=False)
        want = jax_load_config(str(JAX_CONFS / "gasfm/optim_euc_gasfm.conf"),
                               external_params=extra, validate=False)
        bad = detect_schema_discrepancies(got, load_ref_schema())
        assert bad == jax_schema(want, jax_load_ref_schema()) == ["model.view_head.typo",
                                                                  "train.bogus"]
    for name in MODEL_CONFS:  # every shipped conf passes the check in both
        both(name)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def port_flax_shapes(model):
    """{flax key path: shape in flax's layout} of the port's state_dict,
    through the port's own key mapping both ways (models/convert.py)."""
    out = {}
    for key, t in model.state_dict().items():
        path = _flax_path(key, t.dim())
        back, transpose = _torch_key(path)
        assert back == key, (key, path, back)
        shape = tuple(t.shape)[::-1] if transpose else tuple(t.shape)
        out["/".join(path)] = shape[1:] if path[-1] == "att" else shape
    return out


def jax_init_shapes(conf):
    """{flax key path: shape} of the JAX package's init of ``conf``'s model
    (``jax.eval_shape``: no weights are made), on init_model's probe graph."""
    return dict(_jax_init_shapes(json.dumps(conf.get_config("model").to_dict(), sort_keys=True),
                                 conf.get_bool("dataset.calibrated")))


@functools.lru_cache(maxsize=None)
def _jax_init_shapes(model_block, calibrated):
    """Cached by the conf's model block and calibration (the confs that
    differ only in data and training share a tree)."""
    conf = JaxConfigFactory.from_dict({"model": json.loads(model_block),
                                       "dataset": {"calibrated": calibrated}})
    probe = jax_synthetic_scene(n_views=8, n_points=64, seed=0, calibrated=calibrated)
    tree = jax.eval_shape(jax_get_model(conf).init, jax.random.PRNGKey(0),
                          probe.to_scene_graph().graph)["params"]
    return tuple(("/".join(str(k.key) for k in path), tuple(leaf.shape))
                 for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("name", MODEL_CONFS)
def test_model_maps_onto_the_jax_init_tree(name):
    conf, jconf = both(name)
    with torch.device("meta"):
        model = get_model(conf)
    assert type(model) is {"graph_attn_sfm.GraphAttnSfMNet": GraphAttnSfMNet,
                           "SetOfSet.SetOfSetNet": SetOfSetNet}[conf.get_string("model.type")]
    got, want = port_flax_shapes(model), jax_init_shapes(jconf)
    assert sorted(got) == sorted(want)
    assert got == want


def test_unknown_model_type_raises_like_jax():
    conf, jconf = both("synth/optim_synth_gasfm.conf", ['model.type="Nope"'])
    with pytest.raises(ValueError, match="Unknown model.type"):
        jax_get_model(jconf)
    with pytest.raises(ValueError, match="Unknown model.type"):
        get_model(conf)


def filled(cls, kwargs):
    """Every constructor argument of ``cls``, the defaults filled in."""
    import inspect

    bound = inspect.signature(cls).bind(**kwargs)
    bound.apply_defaults()
    return dict(bound.arguments)


def test_presets_equal_the_builders():
    flagship, dpesfm, depth = (load_config(n) for n in (
        "gasfm/optim_euc_gasfm.conf", "dpesfm/learning_euc_noaug_dpesfm.conf",
        "synth/optim_synth_depth_gasfm.conf"))
    assert filled(GraphAttnSfMNet, FLAGSHIP) == filled(GraphAttnSfMNet,
                                                       GraphAttnSfMNet.conf_kwargs(flagship))
    assert filled(SetOfSetNet, DPESFM) == filled(SetOfSetNet, SetOfSetNet.conf_kwargs(dpesfm))
    assert vars(ESFMLoss(**FLAGSHIP_LOSS)) == vars(get_loss_func(flagship))
    assert vars(ESFMLoss(**DPESFM_LOSS)) == vars(get_loss_func(dpesfm))
    assert vars(DirectDepthLoss(**DEPTH_LOSS)) == vars(get_loss_func(depth))
    for optim, conf in ((FLAGSHIP_OPTIM, flagship), (DPESFM_OPTIM, dpesfm)):
        assert filled(Optimizer, dict(params=[], **optim)) == filled(
            Optimizer, dict(params=[], **optim_from_conf(conf)))


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODEL_CONFS)
def test_schedule_from_conf_matches_jax(name):
    conf, jconf = both(name)
    W = conf.get_int("train.lr_schedule.lr_warmup_n_steps", default=0)
    milestones = conf.get_list("train.lr_schedule.multistep_milestones", default=None) or [7000]
    steps = sorted({0, 1, max(W - 1, 0), W, W + 1, W + milestones[0], W + milestones[0] + 1})
    for shift in (0, 3):
        want = jax_schedule_from_conf(jconf, milestone_shift=shift)
        got = schedule_from_conf(conf, milestone_shift=shift)
        np.testing.assert_allclose([float(got(s)) for s in steps],
                                   [float(want(s)) for s in steps], rtol=1e-6, err_msg=name)
    opt = Optimizer([torch.nn.Parameter(torch.zeros(2))], **optim_from_conf(conf))
    np.testing.assert_allclose([opt.lr_at(s) for s in steps],
                               [float(jax_schedule_from_conf(jconf)(s)) for s in steps],
                               rtol=1e-6)


@pytest.mark.parametrize("mode,th", [("norm", 0.5), ("value", 0.25), ("null", None),
                                     ("bogus", 1.0)])
def test_clip_mode_from_conf(mode, th):
    params = [f"loss.grad_clip_mode={mode}"] + ([f"loss.grad_clip_th={th}"] if th else [])
    conf, jconf = both("gasfm/optim_euc_gasfm.conf", params)
    if mode == "bogus":
        with pytest.raises(AssertionError, match="gradient clipping mode"):
            jax_build_optimizer(jconf)
        with pytest.raises(AssertionError, match="gradient clipping mode"):
            optim_from_conf(conf)
        return
    jax_build_optimizer(jconf)
    kw = optim_from_conf(conf)
    assert (kw["grad_clip_mode"], kw["grad_clip_th"]) == (None if mode == "null" else mode, th)
    opt = Optimizer([torch.nn.Parameter(torch.zeros(2))], **kw)
    assert (opt.grad_clip_mode, opt.grad_clip_th) == (kw["grad_clip_mode"], th)


@pytest.mark.parametrize("option", ["parallel.mesh_shape=[1, 2]"])
def test_options_not_ported_raise(option):
    """A mesh conf (table-sharded by default, ported) makes its session on
    its rank's mesh only: without one ``from_conf`` raises ValueError naming
    the launcher. So does one with multi-host ``parallel.distributed``
    (ported too: one launcher per host makes the ranks)."""
    conf = load_config("synth/optim_synth_gasfm.conf", external_params=[option], validate=False)
    model, _ = init_model(conf)
    with pytest.raises(ValueError, match="run_ranks"):
        TrainingSession.from_conf(conf, model, device="cpu")
    conf = load_config("synth/optim_synth_gasfm.conf", validate=False,
                       external_params=[option, "parallel.distributed.enabled=true"])
    with pytest.raises(ValueError, match="run_ranks"):
        TrainingSession.from_conf(conf, model, device="cpu")


def test_tpu_devices_are_accepted_and_ignored():
    """The TPU layout keys of compile.*: the session is the one without
    them; f32 dtypes and a one-device mesh are accepted."""
    extra = ["compile.chunk=512", "compile.kernel_precision=bf16",
             "compile.donate_state=true", "compile.view_bucket_multiple=16",
             "train.adam_mu_dtype=f32", "parallel.mesh_shape=[1, 1]"]
    plain = load_config("synth/optim_synth_gasfm.conf")
    conf = load_config("synth/optim_synth_gasfm.conf", external_params=extra)
    assert GraphAttnSfMNet.conf_kwargs(conf) == GraphAttnSfMNet.conf_kwargs(plain)
    assert optim_from_conf(conf) == optim_from_conf(plain)
    session = TrainingSession.from_conf(conf, init_model(conf)[0], device="cpu")
    assert isinstance(session.loss_func, ESFMLoss) and not session.capture


@pytest.mark.parametrize("extra, want", [
    ([], (torch.float32, False)),
    (["compile.stream_dtype=f32"], (torch.float32, False)),
    (["compile.stream_dtype=bf16", "model.remat_layers=true"], (torch.bfloat16, True)),
])
def test_memory_options_reach_the_model(extra, want):
    """compile.stream_dtype and model.remat_layers: read into the model by
    conf_kwargs and init_model, through the session built from the conf."""
    conf = load_config("synth/optim_synth_gasfm.conf", external_params=extra)
    kw = GraphAttnSfMNet.conf_kwargs(conf)
    assert (kw["stream_dtype"], kw["remat_layers"]) == want
    session = TrainingSession.from_conf(conf, init_model(conf)[0], device="cpu")
    assert (session.model.stream_dtype, session.model.remat_layers) == want


def test_unknown_stream_dtype_raises():
    conf = load_config("synth/optim_synth_gasfm.conf",
                       external_params=["compile.stream_dtype=fp16"])
    with pytest.raises(ValueError, match="stream_dtype"):
        GraphAttnSfMNet.conf_kwargs(conf)


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------


def assert_same_scene(got, want):
    for key in ("M", "Ns", "y"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert got.scene_name == want.scene_name and got.calibrated == want.calibrated
    if want.depths is None:
        assert got.depths is None
    else:
        np.testing.assert_array_equal(got.depths, want.depths)


@pytest.mark.parametrize("name", sorted(SYNTH_SCENES))
def test_synthetic_scenes_from_conf_match_jax(name):
    conf, jconf = both(name)
    scene = SYNTH_SCENES[name]
    assert_same_scene(synthetic_scene_from_conf(conf, scene_name="s"),
                      jax_scene_from_conf(jconf, scene_name="s"))
    got = create_scene_data(conf, scene=scene)
    assert_same_scene(got, jax_create_scene_data(jconf, scene=scene))
    assert got.is_valid_sample() and got.num_views == got.y.shape[0]


def test_synthetic_defaults_match_jax():
    conf = ConfigFactory.parse_string("dataset { calibrated = false }")
    jconf = JaxConfigFactory.parse_string("dataset { calibrated = false }")
    got = synthetic_scene_from_conf(conf)
    assert (got.num_views, got.num_points) == (12, 200)
    assert_same_scene(got, jax_scene_from_conf(jconf))


def write_archives(root):
    """A calibrated and a projective synthetic scene as the loaders'
    archives; PantheonParis also gets 5 points seen in no view."""
    euc = generate_synthetic_scene(n_views=9, n_points=120, visibility=0.7, seed=4,
                                   noise_px=0.5)
    proj = generate_synthetic_scene(n_views=9, n_points=120, visibility=0.7, seed=5,
                                    calibrated=False, noise_px=0.5)
    for sub, name, data in (("Euclidean", "Alpha", euc), ("Euclidean", "PantheonParis", euc),
                            ("Projective", "Alpha", proj), ("Projective", "PantheonParis", proj)):
        M = data.M
        if name == "PantheonParis":
            M = np.concatenate([M[:, :60], np.zeros((M.shape[0], 5), M.dtype), M[:, 60:]], 1)
        os.makedirs(root / sub, exist_ok=True)
        extra = ({"K_gt": np.linalg.inv(data.Ns.astype(np.float64))} if sub == "Euclidean"
                 else {"Ns": data.Ns.astype(np.float64)})
        np.savez(root / sub / f"{name}.npz", M=M.astype(np.float64),
                 Ps_gt=data.y.astype(np.float64), **extra)


@pytest.mark.parametrize("calibrated", [True, False])
def test_create_scene_data_from_archives_matches_jax(tmp_path, calibrated):
    write_archives(tmp_path)
    for scene in ("Alpha", "PantheonParis"):
        for use_gt in (False, True):
            params = [f'dataset.datasets_path="{tmp_path}"', f"dataset.scene={scene}",
                      f"dataset.use_gt={str(use_gt).lower()}",
                      f"dataset.calibrated={str(calibrated).lower()}",
                      f"model.depth_head.enabled={str(calibrated and use_gt).lower()}"]
            conf, jconf = both("gasfm/optim_euc_gasfm.conf", params)
            got, want = create_scene_data(conf), jax_create_scene_data(jconf)
            assert_same_scene(got, want)
            assert got.num_points == 120 and got.is_valid_sample()
            if use_gt:  # the measurements were replaced by reprojections
                raw = create_scene_data(conf, use_gt=False)
                assert not np.array_equal(got.M, raw.M)
    names = ["PantheonParis", "Alpha"]
    for got, want in zip(create_scene_data_from_list(names, conf),
                         jax_create_scene_data_from_list(names, jconf)):
        assert_same_scene(got, want)


# ---------------------------------------------------------------------------
# init_exp, init_model, weight files
# ---------------------------------------------------------------------------


def test_init_exp_and_init_model(tmp_path, capsys):
    args = argparse.Namespace(conf="synth/optim_synth_dpesfm.conf", external_params=[
        "random_seed=3"], scene="synthX", exp_dir=str(tmp_path), scene_name_exp_subdir=True)
    conf, rng = init_exp(args)
    assert conf.get_string("dataset.scene") == "synthX"
    assert conf.get_string("exp_dir") == os.path.join(str(tmp_path), "synthX")
    assert rng.integers(1 << 30) == np.random.default_rng(3).integers(1 << 30)
    assert np.random.randint(1 << 30) == np.random.RandomState(3).randint(1 << 30)
    model, n = init_model(conf)
    assert f"#Trainable parameters: {n}" in capsys.readouterr().out
    twin = SetOfSetNet(**SetOfSetNet.conf_kwargs(conf), generator=torch.Generator().manual_seed(3))
    for (k, a), (_, b) in zip(model.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(a, b), k
    path = str(tmp_path / "w.npz")
    save_params(path, twin)
    loaded, _ = init_model(load_config("synth/optim_synth_dpesfm.conf"), path)
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                 twin.state_dict().values()))


WIDTHS = dict(num_layers=2, n_heads=2, n_feat_proj=16, n_feat_scenepoint=16, n_feat_view=24,
              n_feat_global=32)
DEPTH = dict(depth_head_enabled=True, view_head_enabled=False, scenepoint_head_enabled=False,
             depth_head_n_feat=16, depth_head_n_hidden_layers=1)


def test_load_params_ignores_keys_the_model_lacks(tmp_path, capsys):
    """A view-head model's file into a depth-head model of the same widths:
    the heads the depth model lacks are ignored and printed, its depth head
    keeps its init, every other key is the file's; the JAX package's
    load_params takes the same file into its depth template with the same
    keys. A width that differs raises in both."""
    src = GraphAttnSfMNet(**WIDTHS, generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "view.npz")
    save_params(path, src)
    dst = GraphAttnSfMNet(**WIDTHS, **DEPTH, generator=torch.Generator().manual_seed(2))
    init = {k: v.clone() for k, v in dst.state_dict().items()}
    load_params(path, dst)
    out = capsys.readouterr().out
    assert "ignoring" in out and "keeping init values" in out
    for k, v in dst.state_dict().items():
        want = init[k] if k.startswith("depth_head") else src.state_dict()[k]
        assert torch.equal(v, want), k
    conf = JaxConfigFactory.parse_string("""
        dataset { calibrated = true }
        model { type = "graph_attn_sfm.GraphAttnSfMNet", num_layers = 2, n_heads = 2,
                n_feat_proj = 16, n_feat_scenepoint = 16, n_feat_view = 24, n_feat_global = 32,
                n_hidden_layers_scenepoint_update = 0, n_hidden_layers_view_update = 0,
                n_hidden_layers_global_update = 0, n_hidden_layers_proj_update = 0,
                pos_emb_n_freq = 0, use_norm_proj_update = true,
                add_residual_skipconn_proj_update = true, add_skipconn_from_init_projfeat = true,
                stateful_global_features = true, global2view_and_global2scenepoint_enabled = false,
                depth_head { enabled = true, n_feat = 16, n_hidden_layers = 1 } }""")
    probe = jax_synthetic_scene(n_views=8, n_points=64, seed=0).to_scene_graph().graph
    template = jax.eval_shape(jax_get_model(conf).init, jax.random.PRNGKey(0), probe)
    loaded = jax_load_params(path, template)
    jax_kept = {"/".join(str(k.key) for k in p) for p, leaf in
                jax.tree_util.tree_flatten_with_path(loaded)[0]
                if isinstance(leaf, jax.ShapeDtypeStruct)}
    assert jax_kept and all("depth_head" in k for k in jax_kept)
    assert sum(not k.startswith("depth_head") for k in dst.state_dict()) == \
        len(jax.tree_util.tree_leaves(template)) - len(jax_kept)

    wider = GraphAttnSfMNet(**dict(WIDTHS, n_feat_view=32), **DEPTH,
                            generator=torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_params(path, wider)
    conf.put("model.n_feat_view", 32)
    template = jax.eval_shape(jax_get_model(conf).init, jax.random.PRNGKey(0), probe)
    with pytest.raises(AssertionError, match="shape mismatch"):
        jax_load_params(path, template)
