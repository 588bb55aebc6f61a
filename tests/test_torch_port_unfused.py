"""The port's unfused GASFM layer against the JAX package's, on the CPU.

The JAX package's model code takes its merged (packed) path only with
``use_norm_proj_update``, no projection-update MLP and at most 1024 cameras
(``gasfm_tpu/models/gasfm.py:93-100``); otherwise every layer runs its
composite layer. Three configurations reach that layer:

- ``wide``: the flagship's structure at narrow widths (2 layers, 2 heads,
  n_feat_proj 32) on a power-law scene of 1040 views and 1300 points, ~8k
  edges. Above 1024 cameras the JAX side turns off its merged kernels: the
  point direction runs the single-direction kernel ``fused_attend_h`` (in
  interpret mode here), the camera direction the composite with its segment
  max; a spy checks that ``fused_attend_h`` ran and the dual, frontend and
  layer-step kernels did not. Compared: ``Ps_norm``, ``pts3D``, the loss,
  every parameter gradient and three Adam steps.
- ``no_norm``: ``use_norm_proj_update = false`` with a one-layer
  projection-update MLP, and ``proj_mlp``: the edge LayerNorm with that MLP,
  both on tests/test_torch_port_train.py's 8-view scene, where the JAX side
  runs its dual (and, with the LayerNorm, frontend) kernels on the unfused
  layer. Compared: the forward, the loss and every parameter gradient.

The port runs its kernels' plain versions (CPU tensors). Its weights are
drawn with its own initializer and carried to the JAX tree by the JAX
package's reference-checkpoint converter. A spy on the port's wrappers
checks that it took the JAX package's path on each scene, with one model
object for both.

Tolerances. The loss: rtol 1e-5. ``Ps_norm`` and ``pts3D``: rtol 1e-5,
atol 2e-5 x the output's scale, and the port's float32 error against its
own float64 run at most twice the JAX package's plus 1e-6 x scale. Both
float32 runs sit ~1.6e-5 x scale from the float64 one on the wide scene's
``Ps_norm`` (port 1.69e-5, JAX 1.59e-5): the layer-0 edge LayerNorm over
two features (flax form in both packages) loses digits on edges whose
features nearly coincide, and the two packages round its inputs
differently. Gradients: tests/test_torch_port_train.py's, atol 5e-4 x
max(2e-4, the leaf's max |grad|), rtol 2e-3, except on leaves whose max
|grad| is below 1e-6 x the model's largest gradient G, which are 0 in exact
arithmetic (tests/test_torch_port_train.py, NOISE) and rounding noise in
both packages: there the port's must be below 1e-6 x G too
(tests/test_torch_port_dpesfm.py's rule). Adam steps: loss, ``our_repro``
and gradient norm as tests/test_torch_port_train.py's (rtol 1e-5 at the
first step, 2e-4 after); parameters 1e-6 + 1e-4 |ref|, except on entries
whose first-step |grad| is below 1e-6 x G. Those are noise, and Adam moves
them by up to ~lr in directions their noise sets (on the wide scene they
include lin_r and query-adapter entries of leaves that also carry signal,
which the train test's per-leaf rule misses); they are held within twice
the sum of the three learning rates. That divergence perturbs every later
gradient, and an entry whose own gradient is small can then take an Adam
step of the other sign: at most one in 1,000 of the other entries may
exceed their bound, and only within the learning-rate bound (on the wide
scene 24,750 of the 62,264 entries are noise, and 5 of the other 37,514
exceed their bound, by at most 2.7e-6 against 1.06e-6).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import optax

from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.eval.metrics import core_errors_device as jax_core_errors
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.graph.view_graph import build_view_graph as jax_build_view_graph
from gasfm_tpu.losses import ESFMLoss as JaxESFMLoss
from gasfm_tpu.models.convert import convert_reference_state_dict
from gasfm_tpu.models.gasfm import GraphAttnSfMNet as JaxGraphAttnSfMNet
from gasfm_tpu.ops.pallas import fused_attn as jax_fused_attn
from gasfm_tpu.ops.pallas import fused_dual_attn as jax_fused_dual_attn
from gasfm_tpu.ops.pallas import fused_layer_step as jax_fused_layer_step
from gasfm_tpu.ops.segment import set_kernel_mode
from gasfm_tpu.train.state import build_optimizer as jax_build_optimizer

from gasfm_tpu_torch.eval.metrics import core_errors_device
from gasfm_tpu_torch.graph.view_graph import build_scene_graph, build_view_graph
from gasfm_tpu_torch.losses import ESFMLoss, FLAGSHIP_LOSS
from gasfm_tpu_torch.models.convert import params_from_jax
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.ops.kernels import fused_attn, fused_dual_attn, fused_layer_step
from gasfm_tpu_torch.ops.kernels import segment_kernels
from gasfm_tpu_torch.train.loop import TrainingSession
from gasfm_tpu_torch.train.schedules import build_lr_schedule

from test_torch_port_model import CONFIGS as MERGED_CONFIGS
from test_torch_port_train import NOISE, OPTIM, conf, leaves, port_tree

FLAGSHIP_SHAPE = MERGED_CONFIGS["flagship_shape"]
WIDE = dict(n_views=1040, n_points=1300, track_length_dist="powerlaw", seed=0)
SMALL = dict(n_views=8, n_points=600, visibility=0.5, seed=9)
CONFIGS = {
    "wide": (dict(FLAGSHIP_SHAPE, num_layers=2, n_heads=2), WIDE),
    "no_norm": (dict(FLAGSHIP_SHAPE, num_layers=2, use_norm_proj_update=False,
                     n_hidden_layers_proj_update=1), SMALL),
    "proj_mlp": (dict(FLAGSHIP_SHAPE, num_layers=2, n_hidden_layers_proj_update=1), SMALL),
}
JAX_KERNELS = ((jax_fused_attn, "fused_attend_h"), (jax_fused_dual_attn, "fused_dual_attend"),
               (jax_fused_dual_attn, "fused_frontend"), (jax_fused_layer_step, "fused_layer_step"))


def port_model(widths, seed=0):
    return GraphAttnSfMNet(**widths, generator=torch.Generator().manual_seed(seed))


def jax_params(model):
    return convert_reference_state_dict(
        {k: v.numpy().copy() for k, v in model.state_dict().items()},
        "graph_attn_sfm.GraphAttnSfMNet")


def jax_runs(widths, data, params, steps):
    """``steps`` Adam steps of the JAX model under the Adam test's optimizer,
    its Pallas kernels in interpret mode: [(loss, our_repro, grad_norm)],
    the first step's predictions and gradients, the final parameters, and
    the calls of each JAX kernel entry (a spy)."""
    calls = {name: 0 for _, name in JAX_KERNELS}
    mp = pytest.MonkeyPatch()
    for mod, name in JAX_KERNELS:
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        mp.setattr(mod, name, counted)
    set_kernel_mode("interpret")
    try:
        scene = jax_build_scene_graph(data.M, data.Ns, data.y)
        model = JaxGraphAttnSfMNet(**widths)
        loss = JaxESFMLoss(conf())

        def loss_fn(p):
            pred = model.apply(p, scene.graph)
            return loss(pred, scene), pred

        tx, _ = jax_build_optimizer(conf())
        opt_state = tx.init(params)
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        metrics, first, p = [], None, params
        for _ in range(steps):
            (value, pred), grads = step(p)
            first = first or (jax.tree_util.tree_map(np.asarray, pred), grads)
            norm = optax.global_norm(grads)
            updates, opt_state = tx.update(grads, opt_state, p)
            p = optax.apply_updates(p, updates)
            metrics.append((float(value), float(jax_core_errors(pred, scene)["our_repro"]),
                            float(norm)))
        return metrics, first, p, calls
    finally:
        set_kernel_mode("auto")
        mp.undo()


@functools.lru_cache(maxsize=None)
def run(name):
    """Both packages from the same weights: the JAX runs (3 Adam steps for
    ``wide``, one gradient otherwise), and the port's step-1 loss,
    predictions and gradients, then (``wide``) its 3 Adam steps."""
    widths, scene_kw = CONFIGS[name]
    data = jax_synthetic_scene(**scene_kw)
    model = port_model(widths)
    params = jax_params(model)
    steps = 3 if name == "wide" else 1
    want = jax_runs(widths, data, params, steps)
    session = TrainingSession(model, ESFMLoss(**FLAGSHIP_LOSS), device="cpu", optim=OPTIM)
    scene = build_scene_graph(data.M, data.Ns, data.y, device="cpu")
    ref64 = port_model(widths).double()
    with torch.no_grad():
        pred64 = ref64(dataclasses.replace(scene.graph, uv=scene.graph.uv.double()), plain=True)
    loss, pred, grads = session.loss_and_grads(scene)
    got = dict(loss=float(loss), pred=pred, grads=port_tree(session, grads), scene=scene,
               pred64=pred64)
    if steps > 1:
        norm = session.update(grads)
        repro = core_errors_device(pred, scene)["our_repro"]
        got["metrics"] = [(float(loss), float(repro), float(norm))]
        got["metrics"] += [tuple(float(v) for v in session.fused_step(scene)) for _ in range(2)]
        got["final"] = port_tree(session, [q for q in session.model.parameters()
                                           if q.requires_grad])
    return name, widths, params, want, got


@pytest.fixture(params=sorted(CONFIGS))
def runs(request):
    return run(request.param)


def test_params_from_jax_maps_every_leaf(runs):
    """The JAX tree of the port's weights (no edge LayerNorm without
    use_norm_proj_update; the projection-update MLP's leaves) loads back
    strictly, value for value."""
    _, widths, params, _, _ = runs
    model = GraphAttnSfMNet(**widths)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    want = port_model(widths).state_dict()
    assert sorted(model.state_dict()) == sorted(want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_jax_took_the_unfused_path(runs):
    """The wide scene's JAX run reached the single-direction kernel and no
    merged kernel; the small scenes' unfused layers reached the dual kernel
    (through the frontend kernel with the edge LayerNorm), no layer step."""
    name, _, _, (_, _, _, calls), _ = runs
    if name == "wide":
        assert calls["fused_attend_h"] >= 1
        assert calls["fused_dual_attend"] == calls["fused_frontend"] == 0
    else:
        assert calls["fused_attend_h"] == 0
        assert calls["fused_dual_attend"] + calls["fused_frontend"] >= 1
        assert (calls["fused_frontend"] >= 1) == (name == "proj_mlp")
    assert calls["fused_layer_step"] == 0


@pytest.mark.parametrize("key", ["Ps_norm", "pts3D", "loss"])
def test_forward_and_loss_match_jax(runs, key):
    _, _, _, (metrics, (pred, _), _, _), got = runs
    g = got["scene"].graph
    if key == "loss":
        np.testing.assert_allclose(got["loss"], metrics[0][0], rtol=1e-5)
        return
    rows = (slice(0, g.num_cams),) if key == "Ps_norm" else (slice(None), slice(0, g.num_pts))
    got_v, want_v, ref = got["pred"][key].numpy(), pred[key][rows], got["pred64"][key].numpy()
    assert got_v.shape == want_v.shape and np.isfinite(got_v).all()
    scale = max(1e-30, float(np.abs(ref).max()))
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=2e-5 * scale, err_msg=key)
    err, jax_err = np.abs(got_v - ref).max(), np.abs(want_v - ref).max()
    assert err <= 2.0 * jax_err + 1e-6 * scale, (key, err, jax_err)


def test_parameter_grads_match_jax(runs):
    _, _, _, (_, (_, want), _, _), got = runs
    want_leaves, got_leaves = leaves(want), leaves(got["grads"])
    assert [jax.tree_util.keystr(k) for k, _ in got_leaves] == \
        [jax.tree_util.keystr(k) for k, _ in want_leaves]
    G = max(float(np.abs(np.asarray(w)).max()) for _, w in want_leaves)
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        w, g, name = np.asarray(w), np.asarray(g), f"grad of {jax.tree_util.keystr(path)}"
        if float(np.abs(w).max()) < NOISE * G:
            assert float(np.abs(g).max()) < NOISE * G, name
            continue
        scale = max(2e-4, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=5e-4 * scale, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_wide_adam_steps_match_jax_metrics(step):
    """Loss, our_repro and the gradient norm at each step."""
    _, _, _, (want, _, _, _), got = run("wide")
    rtol = 1e-5 if step == 0 else 2e-4
    for k, (g, w) in enumerate(zip(got["metrics"][step], want[step])):
        np.testing.assert_allclose(g, w, rtol=max(rtol, 1e-4) if k == 2 else rtol,
                                   err_msg=("loss", "our_repro", "grad_norm")[k])


def test_wide_adam_parameters_match_jax():
    """Parameters after three steps, under the module docstring's rule."""
    _, _, _, (_, (_, first), final, _), got = run("wide")
    lr_sum = sum(float(build_lr_schedule(
        OPTIM["lr"], OPTIM["main_scheduler"], OPTIM["lr_warmup_n_steps"],
        OPTIM["exp_gamma_after_n_steps"], OPTIM["exp_n_steps"])(k)) for k in range(3))
    G = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(first))
    n_noise = n_over = n_signal = 0
    for (path, w), (_, g), (_, g0) in zip(leaves(final), leaves(got["final"]), leaves(first)):
        w, g, g0 = np.asarray(w), np.asarray(g), np.asarray(g0)
        noise = np.abs(g0) < NOISE * G
        err = np.abs(g - w)
        np.testing.assert_array_less(err, 2.0 * 1.01 * lr_sum, err_msg=jax.tree_util.keystr(path))
        n_over += int((~noise & (err > 1e-6 + 1e-4 * np.abs(w))).sum())
        n_noise, n_signal = n_noise + int(noise.sum()), n_signal + int((~noise).sum())
    assert n_noise > 0 and n_over <= n_signal // 1000, (n_noise, n_over, n_signal)


def test_one_model_takes_each_scenes_path(monkeypatch):
    """The port's dispatch on the CPU, counted at its kernel wrappers: the
    same model object runs the merged path on an 8-view scene (frontend 1,
    layer step L) and the unfused one on a 1040-view scene (per aggregation,
    L + 1 of them, the single-direction attention, the segment max, two
    gathers and one segment sum; per layer one edge combine), as
    chip_smoke.py's ``unfused_step_launches`` counts the launches."""
    from gasfm_tpu_torch.ops.kernels import fused_update

    calls = {}
    for mod, name in ((fused_attn, "fused_attend"), (fused_dual_attn, "fused_dual_attend"),
                      (fused_dual_attn, "fused_frontend"),
                      (fused_layer_step, "fused_layer_step"),
                      (segment_kernels, "segment_max"), (segment_kernels, "gather_rows"),
                      (segment_kernels, "segment_sum"), (fused_update, "fused_edge_combine")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    widths = dict(FLAGSHIP_SHAPE, num_layers=2, n_heads=2)
    session = TrainingSession(port_model(widths), ESFMLoss(**FLAGSHIP_LOSS), device="cpu")
    for scene_kw, want in ((SMALL, {"fused_frontend": 1, "fused_layer_step": 2}),
                           (WIDE, {"fused_attend": 3, "segment_max": 3, "gather_rows": 6,
                                   "segment_sum": 3, "fused_edge_combine": 2})):
        data = jax_synthetic_scene(**scene_kw)
        scene = build_scene_graph(data.M, data.Ns, data.y, device="cpu")
        calls.clear()
        pred = session.forward(scene)
        assert calls == want
        assert torch.isfinite(pred["Ps_norm"]).all() and torch.isfinite(pred["pts3D"]).all()


@pytest.mark.parametrize("m", [1000, 1017, 1024, 1025])
def test_camera_gate_agrees_with_jax_padded_count(m):
    """The JAX package's 1024-camera gate reads its padded camera count
    (``num_cams`` is ``cam_mask.shape[0]``), the port's ``merged_path`` the
    real one. Under the default caps the padding is
    ``min(bucket_size(m, ...), round_up(m, 128))``, so the padded count is at
    most 1024 exactly when m is: on a scene of m cameras (16 points, each in
    every view) the two gates agree."""
    rng = np.random.default_rng(m)
    M = rng.uniform(100.0, 900.0, (2 * m, 16)).astype(np.float32)
    Ns = np.tile(np.eye(3, dtype=np.float32), (m, 1, 1))
    jax_gate = jax_build_view_graph(M, Ns).num_cams <= 1024
    assert jax_gate == (m <= 1024)
    model = port_model(dict(FLAGSHIP_SHAPE, num_layers=2))
    assert model.merged_path(build_view_graph(M, Ns, device="cpu")) == jax_gate
