"""Sessions built from the shipped confs, the two losses the port added, and
the recorded evaluation forward's bookkeeping, against the JAX package on
the CPU.

- ``matrix_to_quaternion`` on seeded rotations, near 0° and near 180° about
  each axis and about random axes (each of its four branches taken): atol
  1e-6 (float32 on both sides; the branch is the same, so the sign is).
- ``ExpDepthRegularizedOSELoss`` and ``GTLoss``, calibrated and projective,
  on random predictions over a synthetic scene: the value rtol 1e-5 and
  the gradients with respect to ``Ps_norm`` and ``pts3D`` atol 1e-5 x their
  scale, rtol 1e-4 (float32 sums and 3x3 inverses in another order); the
  JAX package runs both in XLA with no kernel, and so does the port.
- ``get_loss_func`` raises ``AssertionError`` where the JAX package's does,
  for every loss and every head combination.
- The four single-scene synthetic confs (3 layers; GASFM's 16 wide, the
  unfused path in both packages) on the scene ``create_scene_data`` makes
  of each: the JAX init
  loaded through ``params_from_jax`` (strict) into ``get_model``'s model,
  the forward (tests/test_torch_port_model.py's tolerance: rtol 1e-3, atol
  1e-4 x scale; the depths per (camera, point)) and the conf's loss (rtol
  1e-5) against the JAX package's with its Pallas kernels in interpret mode.
- Projective scenes end to end: the widths of
  ``confs/synth/optim_synth_proj_gasfm.conf`` at 2 layers and of
  ``confs/dpesfm/learning_proj_noaug_dpesfm.conf`` at 32 features (both
  narrowed through external params) on the synthetic projective conf's
  10-view scene: forward, ``ESFMLoss`` and every parameter gradient within
  tests/test_torch_port_train.py's tolerances (loss rtol 1e-5; gradients
  atol 5e-4 x max(2e-4, the leaf's max |grad|), rtol 2e-3).
- The recorded forward, with tests/test_torch_port_capture.py's stand-in
  for a CUDA graph: a replay's predictions are copies; the forward sees the
  weights each ``fused_step`` updated (forward, step, forward, ...
  against an eager twin, bitwise); and with ``loop._Program`` itself over
  a stand-in of ``torch.cuda``'s graph calls, the kernel wrappers run at
  the warm-up and at the recording, under ``no_grad``, and not at a
  replay. ``capture=True`` on a CPU session raises.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.config import ConfigFactory as JaxConfigFactory
from gasfm_tpu.data.loaders import create_scene_data as jax_create_scene_data
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.geometry.rotations import matrix_to_quaternion as jax_m2q
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.losses import get_loss_func as jax_get_loss_func
from gasfm_tpu.models import get_model as jax_get_model
from gasfm_tpu.models.convert import convert_reference_state_dict
from gasfm_tpu.ops.segment import set_kernel_mode

from gasfm_tpu_torch.config import ConfigFactory, load_config
from gasfm_tpu_torch.data.loaders import create_scene_data
from gasfm_tpu_torch.geometry.rotations import matrix_to_quaternion
from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.losses import FLAGSHIP_LOSS, ESFMLoss, get_loss_func
from gasfm_tpu_torch.models import get_model
from gasfm_tpu_torch.models.convert import params_from_jax
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.ops.kernels import fused_dual_attn, fused_layer_step, fused_loss
from gasfm_tpu_torch.train import loop
from gasfm_tpu_torch.train.loop import TrainingSession

from test_torch_port_capture import ReplayStandIn
from test_torch_port_model import CONFIGS, assert_close
from test_torch_port_train import OPTIM

JAX_CONFS = "gasfm_tpu/confs/"


def both(name, external_params=None):
    return (load_config(name, external_params=external_params),
            load_jax_conf(name, external_params))


def load_jax_conf(name, external_params=None):
    from gasfm_tpu.config import load_config as jax_load_config

    return jax_load_config(JAX_CONFS + name, external_params=external_params)


# ---------------------------------------------------------------------------
# matrix_to_quaternion
# ---------------------------------------------------------------------------


def rotation(axis, angle):
    """Rodrigues' rotation in float64."""
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def test_matrix_to_quaternion_matches_jax():
    rng = np.random.default_rng(0)
    axes = [np.eye(3)[i] for i in range(3)] + list(rng.standard_normal((3, 3)))
    angles = [0.0, 1e-4, -1e-4, np.pi, np.pi - 1e-4, -(np.pi - 1e-4), np.pi - 3e-3]
    Rs = [rotation(a, t) for a in axes for t in angles]
    Rs += [rotation(a, t) for a, t in zip(rng.standard_normal((24, 3)),
                                          rng.uniform(-np.pi, np.pi, 24))]
    R = np.stack(Rs).astype(np.float32)
    tw = 1 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    tx = 1 + R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2]
    ty = 1 - R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2]
    tz = 1 - R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2]
    branches = np.argmax(np.stack([tw, tx, ty, tz], -1), -1)
    assert set(branches.tolist()) == {0, 1, 2, 3}
    want = np.asarray(jax_m2q(jnp.asarray(R)))
    got = matrix_to_quaternion(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[:, 0] >= 0).all()


# ---------------------------------------------------------------------------
# ExpDepthRegularizedOSELoss and GTLoss
# ---------------------------------------------------------------------------


def random_predictions(m, n, seed):
    """Cameras near [I | t] with positive depths in front, and points."""
    rng = np.random.default_rng(seed)
    Ps = np.concatenate([np.eye(3)[None] + 0.2 * rng.standard_normal((m, 3, 3)),
                         0.3 * rng.standard_normal((m, 3, 1)) + [[[0.0], [0.0], [3.0]]]], 2)
    pts = np.concatenate([rng.standard_normal((3, n)), np.ones((1, n))])
    return Ps.astype(np.float32), pts.astype(np.float32)


@pytest.mark.parametrize("loss_name", ["ExpDepthRegularizedOSELoss", "GTLoss"])
@pytest.mark.parametrize("calibrated", [True, False])
def test_added_losses_match_jax(loss_name, calibrated):
    conf_text = f"""
        dataset {{ calibrated = {str(calibrated).lower()} }}
        model {{ view_head {{ enabled = true }}, scenepoint_head {{ enabled = true }},
                depth_head {{ enabled = false }} }}
        loss {{ func = {loss_name}, depth_regul_weight = 0.3 }}"""
    data = jax_synthetic_scene(n_views=8, n_points=300, visibility=0.5, seed=3,
                               calibrated=calibrated)
    loss = get_loss_func(ConfigFactory.parse_string(conf_text))
    jloss = jax_get_loss_func(JaxConfigFactory.parse_string(conf_text))
    assert type(loss).__name__ == type(jloss).__name__ == loss_name
    scene = build_scene_graph(data.M, data.Ns, data.y, device="cpu")
    jscene = jax_build_scene_graph(data.M, data.Ns, data.y)
    m, n = scene.graph.num_cams, scene.graph.num_pts
    jm, jn = jscene.graph.num_cams, jscene.graph.num_pts
    Ps, pts = random_predictions(m, n, seed=5)
    # the JAX graph's padded cameras get [I | 0] (invertible; masked out)
    Ps_pad = np.concatenate([Ps, np.tile(np.eye(3, 4, dtype=np.float32), (jm - m, 1, 1))])
    pts_pad = np.pad(pts, ((0, 0), (0, jn - n)))

    def jfn(P, X):
        return jloss({"Ps_norm": P, "pts3D": X}, jscene)

    want, (wP, wX) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(jnp.asarray(Ps_pad),
                                                                    jnp.asarray(pts_pad))
    P_t = torch.from_numpy(Ps).requires_grad_()
    X_t = torch.from_numpy(pts).requires_grad_()
    got = loss({"Ps_norm": P_t, "pts3D": X_t}, scene)
    gP, gX = (torch.zeros_like(t) if g is None else g for t, g in zip(
        (P_t, X_t), torch.autograd.grad(got, (P_t, X_t), allow_unused=True)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for name, g, w in (("d Ps_norm", gP, np.asarray(wP)[:m]),
                       ("d pts3D", gX, np.asarray(wX)[:, :n])):
        scale = max(1e-6, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * scale, rtol=1e-4, err_msg=name)


LOSSES = ["ESFMLoss", "ExpDepthRegularizedOSELoss", "GTLoss", "DirectDepthLoss", "Nope"]


@pytest.mark.parametrize("func", LOSSES)
def test_get_loss_func_raises_where_jax_does(func):
    for heads in range(8):
        depth, view, point = (bool(heads & b) for b in (1, 2, 4))
        text = f"""
            dataset {{ calibrated = true }}
            model {{ depth_head {{ enabled = {str(depth).lower()} }},
                    view_head {{ enabled = {str(view).lower()} }},
                    scenepoint_head {{ enabled = {str(point).lower()} }} }}
            loss {{ func = {func}, cost_fcn = L1, depth_regul_weight = 1.0,
                   infinity_pts_margin = 0.0001, hinge_loss = true, hinge_loss_weight = 1,
                   pts_grad_equalization_pre_perspective_divide = true,
                   normalize_grad_wrt_valid_projections_only = true }}"""
        try:
            want = type(jax_get_loss_func(JaxConfigFactory.parse_string(text))).__name__
        except AssertionError:
            with pytest.raises(AssertionError):
                get_loss_func(ConfigFactory.parse_string(text))
            continue
        assert type(get_loss_func(ConfigFactory.parse_string(text))).__name__ == want == func


# ---------------------------------------------------------------------------
# Sessions from the confs against the JAX package
# ---------------------------------------------------------------------------


def grad_close(g, w, name):
    """tests/test_torch_port_train.py's gradient rule."""
    scale = max(2e-4, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, atol=5e-4 * scale, rtol=2e-3, err_msg=f"grad of {name}")


def dense_by_pair(values, cam, pt, shape):
    out = np.full(shape, np.nan, np.float64)
    out[cam, pt] = values
    return out


@functools.lru_cache(maxsize=None)
def conf_run(name, external_params=(), scene_conf=None, grads=False):
    """The conf's model in both packages from the JAX init (loaded into the
    port through params_from_jax, strict), on the scene create_scene_data
    makes of ``scene_conf`` (default: the conf itself): the predictions and
    the conf's loss, with ``grads`` every parameter gradient; the JAX side
    with its Pallas kernels in interpret mode, the port's plain versions."""
    conf, jconf = both(name, list(external_params))
    sconf, jsconf = both(scene_conf or name)
    data, jdata = create_scene_data(sconf), jax_create_scene_data(jsconf)
    np.testing.assert_array_equal(data.M, jdata.M)
    set_kernel_mode("interpret")
    try:
        jscene = jax_build_scene_graph(jdata.M, jdata.Ns, jdata.y, gt_depths_dense=jdata.depths)
        jmodel, jloss = jax_get_model(jconf), jax_get_loss_func(jconf)
        params = jmodel.init(jax.random.PRNGKey(0), jscene.graph)

        def loss_fn(p):
            pred = jmodel.apply(p, jscene.graph)
            return jloss(pred, jscene), pred

        if grads:  # jitted: its compile costs less than the eager backward's
            (want_loss, want_pred), want_grads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(params)
        else:
            want_loss, want_pred = loss_fn(params)
            want_grads = None
    finally:
        set_kernel_mode("auto")
    model = get_model(conf)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    session = TrainingSession.from_conf(conf, model, device="cpu")
    scene = build_scene_graph(data.M, data.Ns, data.y, device="cpu",
                              gt_depths_dense=data.depths)
    if grads:
        loss, pred, g = session.loss_and_grads(scene)
        names = [k for k, p in model.named_parameters() if p.requires_grad]
        got_grads = convert_reference_state_dict(
            {k: t.numpy() for k, t in zip(names, g)}, conf.get_string("model.type"))
    else:
        pred = session.forward(scene)
        loss, got_grads = session.loss(pred, scene), None
    return dict(conf=conf, scene=scene, jscene=jscene, pred=pred, loss=float(loss),
                want_pred={k: np.asarray(v) for k, v in want_pred.items()},
                want_loss=float(want_loss), grads=got_grads, want_grads=want_grads)


def assert_forward_and_loss(run):
    g, jg = run["scene"].graph, run["jscene"].graph
    pred, want = run["pred"], run["want_pred"]
    assert sorted(pred) == sorted(want)
    if "depths" in pred:
        mask = np.asarray(jg.edge_mask)
        shape = (g.num_cams, g.num_pts)
        got = dense_by_pair(pred["depths"].numpy(), g.cam_idx.numpy(), g.pt_idx.numpy(), shape)
        ref = dense_by_pair(want["depths"][mask], np.asarray(jg.cam_idx)[mask],
                            np.asarray(jg.pt_idx)[mask], shape)
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        assert_close(got[~np.isnan(got)], ref[~np.isnan(ref)], "depths")
    else:
        assert_close(pred["Ps_norm"], want["Ps_norm"][:g.num_cams], "Ps_norm")
        assert_close(pred["pts3D"], want["pts3D"][:, :g.num_pts], "pts3D")
    assert np.isfinite(run["loss"])
    np.testing.assert_allclose(run["loss"], run["want_loss"], rtol=1e-5)


SYNTH_CONFS = ["synth/optim_synth_gasfm.conf", "synth/optim_synth_dpesfm.conf",
               "synth/optim_synth_depth_gasfm.conf", "synth/optim_synth_proj_gasfm.conf"]


@pytest.mark.parametrize("name", SYNTH_CONFS)
def test_synthetic_conf_sessions_match_jax(name):
    run = conf_run(name)
    depth = run["conf"].get_int("model.num_layers", default=None) or run["conf"].get_int(
        "model.block_size")
    assert depth == 3
    assert_forward_and_loss(run)


PROJECTIVE = {
    "gasfm": ("synth/optim_synth_proj_gasfm.conf", ("model.num_layers=2",)),
    "dpesfm": ("dpesfm/learning_proj_noaug_dpesfm.conf", ("model.num_features=32",)),
}


@pytest.mark.parametrize("kind", sorted(PROJECTIVE))
def test_projective_sessions_match_jax(kind):
    name, params = PROJECTIVE[kind]
    run = conf_run(name, params, scene_conf="synth/optim_synth_proj_gasfm.conf", grads=True)
    conf = run["conf"]
    assert not conf.get_bool("dataset.calibrated")
    assert conf.get_string("model.view_head.normalize_output") == "Differentiable Chirality"
    assert run["scene"].graph.num_cams == 10 and isinstance(
        TrainingSession.from_conf(conf, get_model(conf), device="cpu").loss_func, ESFMLoss)
    assert_forward_and_loss(run)
    want = jax.tree_util.tree_leaves_with_path(run["want_grads"])
    got = jax.tree_util.tree_leaves_with_path(run["grads"])
    assert [jax.tree_util.keystr(k) for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (path, w), (_, g) in zip(want, got):
        grad_close(np.asarray(g), np.asarray(w), jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# The recorded evaluation forward
# ---------------------------------------------------------------------------

WIDTHS = CONFIGS["stateless_broadcast"]  # 2 layers, merged


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.fixture(scope="module")
def small_scene():
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene

    return generate_synthetic_scene(n_views=8, n_points=600, visibility=0.5,
                                    seed=9).to_scene_graph(device="cpu")


def session_of(capture=None):
    model = GraphAttnSfMNet(**WIDTHS, generator=torch.Generator().manual_seed(0))
    return TrainingSession(model, ESFMLoss(**FLAGSHIP_LOSS), device="cpu", optim=OPTIM,
                           capture=capture)


def test_recorded_forward_follows_the_weights(small_scene, monkeypatch, deterministic):
    """forward, step, forward, step, ...: the forward's warm-up, recording
    and replays against an eager twin's, bitwise, each after the same
    steps; every prediction kept is a copy the next replay leaves alone."""
    with pytest.raises(ValueError, match="records CUDA graphs"):
        session_of(capture=True)
    eager = session_of()
    rec = session_of()
    monkeypatch.setattr(loop, "_Program", ReplayStandIn)
    rec.capture = True
    kept = []
    for k in range(4):
        want = eager.forward(small_scene)
        got = rec.forward(small_scene)
        for key in want:
            assert torch.equal(got[key], want[key]), (k, key)
        kept.append({key: (v, v.clone()) for key, v in got.items()})
        assert torch.equal(rec.loss(got, small_scene), eager.loss(want, small_scene))
        for a, b in zip(rec.fused_step(small_scene), eager.fused_step(small_scene)):
            assert torch.equal(a, b)
    static = rec._programs[("forward", id(small_scene))].out
    assert all(v is not static[key] for pred in kept for key, (v, _) in pred.items())
    assert all(torch.equal(v, copy) for pred in kept for v, copy in pred.values())
    assert not torch.equal(kept[0]["Ps_norm"][0], kept[3]["Ps_norm"][0])  # the weights moved
    assert rec._programs[("forward", id(small_scene))].calls == 4
    assert rec._programs[("fused_step", id(small_scene))].calls == 4
    plain = rec.forward(small_scene, plain=True)  # eager, no program call
    assert rec._programs[("forward", id(small_scene))].calls == 4
    assert all(torch.equal(plain[k], eager.forward(small_scene)[k]) for k in plain)


class _Stream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


class _Graph:
    """``torch.cuda.CUDAGraph``'s stand-in: replays count, and run nothing
    (as a real replay runs no Python)."""

    replays = 0

    def replay(self):
        _Graph.replays += 1


def test_recorded_forward_runs_the_wrappers_at_warmup_and_recording_only(small_scene,
                                                                         monkeypatch):
    """``loop._Program`` itself, with ``torch.cuda``'s stream and graph
    calls stood in for: the port's kernel wrappers run once per forward at
    the warm-up and at the recording, each under no_grad (the kernels'
    variants without residuals), and not at all at the replays, which
    return copies of the recording's outputs."""
    calls = []
    for mod, name in ((fused_dual_attn, "fused_frontend"), (fused_dual_attn, "fused_dual_attend"),
                      (fused_layer_step, "fused_layer_step"), (fused_loss, "fused_esfm_terms")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls.append((_name, torch.is_grad_enabled()))
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, stream=None: contextlib.nullcontext())
    _Graph.replays = 0
    session = session_of()
    session.capture, session._stream = True, _Stream()
    per_call, outs = [], []
    for _ in range(4):
        before = len(calls)
        outs.append(session.forward(small_scene))
        per_call.append(len(calls) - before)
    L = WIDTHS["num_layers"]
    assert per_call == [L + 1, L + 1, 0, 0]  # frontend + layer steps, then replays
    assert {n for n, _ in calls} == {"fused_frontend", "fused_layer_step"}
    assert not any(grad for _, grad in calls)
    assert _Graph.replays == 3  # the recording's own replay, then one per call
    prog = session._programs[("forward", id(small_scene))]
    for pred in outs[1:]:
        assert all(pred[k] is not prog.out[k] and torch.equal(pred[k], prog.out[k])
                   for k in pred)
