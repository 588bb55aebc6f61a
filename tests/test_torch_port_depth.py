"""The port's depth head (GASFM and DPESFM, ``DirectDepthLoss``, GT depths,
the projection-update kernel's plain version) against the JAX package, on
the CPU.

- ``projection_update_plain`` against ``packed_edge_update`` (the TPU
  kernels #9/#10, interpret mode), forward and ``jax.vjp`` gradients of every
  input, with skip2 and the residual, with neither, and with skip2 alone, on
  tests/test_torch_port_kernels.py's scene (inputs drawn per real edge and
  scattered into the JAX layout, packed for the call and unpacked to
  compare). Tolerance as there: atol 1e-5 x the reference's scale, rtol 1e-4.
- The model as a whole, three GASFM depth configurations and one DPESFM:
  ``depth3``, 3 layers, 2 heads, n_feat_proj 32, depth head 64 wide with 1
  hidden layer, on tests/test_torch_port_train.py's 8-view scene, the
  smallest model whose JAX plan runs the standalone update: layer 0 defers,
  layer 1 runs the layer step and then ``packed_edge_update`` (a spy counts
  one call of each per forward, and the port's spies count one
  ``projection_update`` and one ``fused_layer_step``), layer 2 runs unfused
  and widens the stream to 64 with the init skip; ``synth_depth``, the
  widths of confs/synth/optim_synth_depth_gasfm.conf (n_feat_proj 16, 3
  layers, depth 32) on its own scene (10 views, 100 points), which both
  packages run unfused throughout (the merged path takes exactly 32
  features, the JAX package's ``packable`` width); ``no_norm_depth``,
  ``depth3`` without ``use_norm_proj_update`` (unfused everywhere, the last
  layer's ``skip_projection`` without its LayerNorm); ``dpesfm_depth``, the
  DPESFM conf's structure at width 32 with a 16-wide depth head. Compared:
  ``depths`` per (camera, point), the ``DirectDepthLoss`` (L1) value, every
  parameter gradient, and for ``depth3`` three Adam steps through
  ``loss_and_grads`` + ``update`` (the JAX package's ``epoch_train`` loop for
  a depth-only model), under tests/test_torch_port_train.py's optimizer.
- The per-layer plan over layer counts and depth widths, traced with
  ``jax.eval_shape`` against the port's counted dispatch.
- GT depths per (camera, point) against ``gasfm_tpu.data.scene.SceneData``,
  dense and per edge; ``params_from_jax`` strict on every depth tree.

The seeded weights (the port's initializer; seed 0, and seed 2 for
``dpesfm_depth``, whose seed 0 gives s_pred = -0.0485) give mean predicted
depths s_pred of -0.1327 (``depth3``), -0.2093 (``synth_depth``), -0.2434
(``no_norm_depth``) and -0.2225 (``dpesfm_depth``): the loss and every
gradient scale with 1 / s_pred, and none of these is small enough to cost
float32 digits (``test_depth_scale_and_ties`` holds |s_pred| >= 0.05). The
edge nearest an L1 tie (|d / s_pred - d_gt / s_gt|, where the sign of the
L1 gradient could differ between the packages) is 3.3e-5 away in
``depth3``, 2.4e-4 to 3.4e-4 in the others; the same test holds every edge
at least 1e-5 away.

Tolerances. ``depths``: rtol 1e-4, atol 2e-5 x the output's scale (three
layers of float32 sums in another order; measured at most 1.6e-6 x scale,
``synth_depth``). The depth layer's residual LayerNorm, over 32 features per
edge, is torch's two-pass ``nn.LayerNorm`` in the port and flax's
E[x^2] - mean^2 in the JAX package: on ``depth3``'s stream the two differ
by 4.8e-7 (each ~5e-7 from float64), held to atol 1e-5 x scale, rtol 1e-4.
The loss: rtol 1e-5 (measured 3.2e-7). Gradients:
tests/test_torch_port_train.py's rule, atol 5e-4 x max(2e-4, the leaf's max
|grad|), rtol 2e-3, on every leaf: the largest gradient G is 5.2e-5 to 2.9e-2
here (the depth loss's gradients are small at init), so the absolute floor
(1e-7) also covers the leaves that are 0 in exact arithmetic and rounding
noise in both packages (tests/test_torch_port_train.py, NOISE; DPESFM's
mean-centred biases). Adam: loss and gradient norm rtol 1e-5 at the first
step, 2e-4 after; parameters: every entry within twice the sum of the three
learning rates (measured 0.13 of the sum), and every entry whose first-step
gradient is above 1e-6 x G within a tenth of it (measured 0.024). Adam
normalizes each entry's step, so with G = 1.9e-3 many entries' steps are set
by gradients whose float32 rounding differs between the packages by a
visible fraction, and the two runs part by a fraction of a step there
rather than by the 1e-6 + 1e-4 |ref| of the ESFM tests.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gasfm_tpu.config import ConfigFactory
from gasfm_tpu.data.scene import SceneData as JaxSceneData
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import WINDOW
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.losses import DirectDepthLoss as JaxDirectDepthLoss
from gasfm_tpu.models.convert import convert_reference_state_dict
from gasfm_tpu.models.gasfm import GraphAttnSfMNet as JaxGraphAttnSfMNet
from gasfm_tpu.models.set_of_set import SetOfSetNet as JaxSetOfSetNet
from gasfm_tpu.ops.pallas import fused_dual_attn as jax_fused_dual_attn
from gasfm_tpu.ops.pallas import fused_layer_step as jax_fused_layer_step
from gasfm_tpu.ops.pallas import fused_proj_update as jax_fused_proj_update
from gasfm_tpu.ops.pallas.packing import pack_edges, unpack_edges
from gasfm_tpu.ops.segment import set_kernel_mode
from gasfm_tpu.train.state import build_optimizer as jax_build_optimizer

from gasfm_tpu_torch.data.scene import SceneData
from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.losses import DEPTH_LOSS, DirectDepthLoss
from gasfm_tpu_torch.models.convert import params_from_jax
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
from gasfm_tpu_torch.ops.kernels import fused_dual_attn, fused_layer_step, fused_proj_update
from gasfm_tpu_torch.ops.kernels import fused_update
from gasfm_tpu_torch.ops.kernels.fused_proj_update import projection_update_plain
from gasfm_tpu_torch.train.loop import TrainingSession
from gasfm_tpu_torch.train.schedules import build_lr_schedule

from test_torch_port_kernels import Draw, assert_close, make_graphs, port_grads
from test_torch_port_train import NOISE, OPTIM, leaves

SMALL = dict(n_views=8, n_points=600, visibility=0.5, seed=9)
SYNTH = dict(n_views=10, n_points=100, visibility=0.8, seed=0)  # optim_synth_depth_gasfm.conf
DEPTH_ONLY = dict(depth_head_enabled=True, view_head_enabled=False,
                  scenepoint_head_enabled=False)
DEPTH3 = dict(num_layers=3, n_heads=2, n_feat_proj=32, n_feat_scenepoint=24, n_feat_view=40,
              n_feat_global=48, depth_head_n_feat=64, depth_head_n_hidden_layers=1, **DEPTH_ONLY)
# name: (model, widths, scene, weight seed)
CONFIGS = {
    "depth3": ("gasfm", DEPTH3, SMALL, 0),
    "synth_depth": ("gasfm", dict(num_layers=3, n_heads=2, n_feat_proj=16, n_feat_scenepoint=32,
                                  n_feat_view=64, n_feat_global=128, depth_head_n_feat=32,
                                  depth_head_n_hidden_layers=1, **DEPTH_ONLY), SYNTH, 0),
    "no_norm_depth": ("gasfm", dict(DEPTH3, use_norm_proj_update=False), SMALL, 0),
    "dpesfm_depth": ("dpesfm", dict(num_blocks=1, block_size=3, num_features=32,
                                    add_skipconn_for_residual_blocks=False,
                                    depth_head_n_feat=16, depth_head_n_hidden_layers=1,
                                    **DEPTH_ONLY), SMALL, 2),
}
MODELS = {"gasfm": (GraphAttnSfMNet, JaxGraphAttnSfMNet, "graph_attn_sfm.GraphAttnSfMNet"),
          "dpesfm": (SetOfSetNet, JaxSetOfSetNet, "set_of_set.SetOfSetNet")}
CONF = """
dataset { calibrated = true }
model { depth_head { enabled = true }, view_head { enabled = false },
        scenepoint_head { enabled = false } }
loss { func = "DirectDepthLoss", cost_fcn = "L1", grad_clip_mode = null }
train {
  lr = 0.001
  lr_schedule {
    lr_warmup_n_steps = 2
    main_scheduler = "exponential"
    exp_n_steps = 10
    exp_gamma_after_n_steps = 0.1
  }
}
"""
JAX_KERNELS = ((jax_fused_proj_update, "packed_edge_update"),
               (jax_fused_layer_step, "fused_layer_step"),
               (jax_fused_dual_attn, "fused_frontend"))
PORT_KERNELS = ((fused_proj_update, "projection_update"), (fused_layer_step, "fused_layer_step"),
                (fused_dual_attn, "fused_frontend"), (fused_update, "fused_edge_combine"))


def conf():
    return ConfigFactory.parse_string(CONF)


def spy(mp, calls, modules):
    """Count the calls of each (module, function) into ``calls``."""
    for mod, name in modules:
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        mp.setattr(mod, name, counted)


@pytest.fixture(autouse=True)
def _restore_kernel_mode():
    yield
    set_kernel_mode("auto")


# ---------------------------------------------------------------------------
# #9/#10: the projection update's plain version against packed_edge_update
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    return make_graphs()


UPDATE_KEYS = ("en", "skip2", "res", "w_e", "b", "w_uv", "ps", "pv", "pg")


@pytest.mark.parametrize("has_skip,has_res", [(True, True), (False, False), (True, False)])
def test_projection_update_matches_packed_edge_update(graphs, has_skip, has_res):
    """Forward and the gradient of every input (d res = the cotangent; d b =
    d pg the column sum; the point and camera sums on real rows)."""
    draw = Draw(graphs, seed=21)
    jg, pg, mask = graphs
    De, d2, chunk = 32, 2, jg.chunk
    en, en_t = draw.edges(De)
    skip2, skip2_t = draw.edges(d2)
    res, res_t = draw.edges(De)
    w_e, w_uv = draw.arr(De, De, scale=0.3), draw.arr(d2, De, scale=0.3)
    b, pgl = draw.arr(De, scale=0.1), draw.arr(1, De)
    ps, ps_t = draw.pt_table(De)
    pv, pv_t = draw.cam_table(De)
    g = draw.arr(pg.num_edges, De)
    keys = tuple(k for k in UPDATE_KEYS
                 if (has_skip or k not in ("skip2", "w_uv")) and (has_res or k != "res"))
    vals = dict(en=en, skip2=skip2, res=res, w_e=w_e, b=b, w_uv=w_uv, ps=ps, pv=pv, pg=pgl)
    window = jg.pt_segment_windows()

    def f(*a):
        u = dict(zip(keys, a))
        out = jax_fused_proj_update.packed_edge_update(
            pack_edges(u["en"], chunk), pack_edges(u["skip2"], chunk) if has_skip else None,
            pack_edges(u["res"], chunk) if has_res else None, u["w_e"], u["b"], u.get("w_uv"),
            u["ps"], u["pv"], u["pg"], jg.pt_idx.reshape(-1, chunk),
            jg.cam_idx.reshape(-1, chunk), window.block, jg.num_pts, jg.num_cams, WINDOW,
            interpret=True, nlive=window.nlive)
        return unpack_edges(out, chunk)

    set_kernel_mode("interpret")
    out, vjp = jax.vjp(f, *(jnp.asarray(vals[k]) for k in keys))
    g_pad = np.zeros(out.shape, np.float32)
    g_pad[mask] = g
    want = dict(zip(keys, map(np.asarray, vjp(jnp.asarray(g_pad)))))

    w = np.concatenate([w_e, w_uv]) if has_skip else w_e
    leaves_t = dict(en=en_t, w=torch.from_numpy(w.T.copy()), b=torch.from_numpy(b), ps=ps_t,
                    pv=pv_t, pg=torch.from_numpy(pgl))
    if has_skip:
        leaves_t["skip2"] = skip2_t
    if has_res:
        leaves_t["res"] = res_t

    def port(**a):
        return (projection_update_plain(a["en"], a.get("skip2"), a.get("res"), a["w"], a["b"],
                                        a["ps"], a["pv"], a["pg"], pg),)

    with torch.no_grad():
        assert_close(port(**leaves_t)[0], np.asarray(out)[mask], "e")
    got = port_grads(port, leaves_t, (g,))
    pairs = [("d en", got["en"], want["en"][mask]),
             ("d w_e", got["w"][:, :De].T, want["w_e"]), ("d b", got["b"], want["b"]),
             ("d pg", got["pg"], want["pg"]), ("d ps", got["ps"], want["ps"][: pg.num_pts]),
             ("d pv", got["pv"], want["pv"][: pg.num_cams])]
    if has_skip:
        pairs += [("d skip2", got["skip2"], want["skip2"][mask]),
                  ("d w_uv", got["w"][:, De:].T, want["w_uv"])]
    if has_res:
        pairs.append(("d res", got["res"], want["res"][mask]))
    for name, a, b_ in pairs:
        assert_close(a, b_, name)


# ---------------------------------------------------------------------------
# The model as a whole
# ---------------------------------------------------------------------------


def port_model(kind, widths, seed=0):
    return MODELS[kind][0](**widths, generator=torch.Generator().manual_seed(seed))


def to_jax_tree(kind, named):
    """{port parameter name: array} -> the flax tree (the JAX package's
    reference-checkpoint converter)."""
    return convert_reference_state_dict(named, MODELS[kind][2])


def dense_by_pair(values, cam, pt, shape):
    """Per-edge values -> an (m, n) array by (camera, point), NaN elsewhere."""
    out = np.full(shape, np.nan, np.float64)
    out[cam, pt] = values
    return out


@functools.lru_cache(maxsize=None)
def run(name):
    """Both packages from the same weights: the JAX loss, predictions and
    gradients (``depth3``: then 3 Adam steps) with its Pallas kernels in
    interpret mode and a spy on its kernel entries; the port's (plain path)
    with a spy on its wrappers."""
    kind, widths, scene_kw, seed = CONFIGS[name]
    data = jax_synthetic_scene(store_depth_targets=True, **scene_kw)
    model = port_model(kind, widths, seed)
    params = to_jax_tree(kind, {k: v.numpy().copy() for k, v in model.state_dict().items()})
    steps = 3 if name == "depth3" else 1

    jax_calls, port_calls = {}, {}
    mp = pytest.MonkeyPatch()
    spy(mp, jax_calls, JAX_KERNELS)
    set_kernel_mode("interpret")
    try:
        scene = jax_build_scene_graph(data.M, data.Ns, data.y, gt_depths_dense=data.depths)
        jmodel, loss = MODELS[kind][1](**widths), JaxDirectDepthLoss(conf())

        def loss_fn(p):
            pred = jmodel.apply(p, scene.graph)
            return loss(pred, scene), pred

        tx, _ = jax_build_optimizer(conf())
        opt_state = tx.init(params)
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        metrics, first, p = [], None, params
        for _ in range(steps):
            (value, pred), grads = step(p)
            first = first or (np.asarray(pred["depths"]), grads)
            metrics.append((float(value), float(optax.global_norm(grads))))
            updates, opt_state = tx.update(grads, opt_state, p)
            p = optax.apply_updates(p, updates)
        jg = scene.graph
        mask = np.asarray(jg.edge_mask)
        shape = (data.y.shape[0], data.M.shape[1])
        want_depths = dense_by_pair(first[0][mask], np.asarray(jg.cam_idx)[mask],
                                    np.asarray(jg.pt_idx)[mask], shape)
    finally:
        set_kernel_mode("auto")
        mp.undo()

    spy(mp, port_calls, PORT_KERNELS)
    try:
        session = TrainingSession(model, DirectDepthLoss(**DEPTH_LOSS), device="cpu",
                                  optim=OPTIM)
        pscene = build_scene_graph(data.M, data.Ns, data.y, device="cpu",
                                   gt_depths_dense=data.depths)
        loss_v, pred, grads = session.loss_and_grads(pscene)
        calls_per_forward = dict(port_calls)
    finally:
        mp.undo()
    g = pscene.graph
    names = [k for k, q in session.model.named_parameters() if q.requires_grad]
    got = dict(loss=float(loss_v), grads=to_jax_tree(kind, {k: t.numpy() for k, t in
                                                            zip(names, grads)}),
               depths=pred["depths"].numpy(), scene=pscene,
               dense_depths=dense_by_pair(pred["depths"].numpy(), g.cam_idx.numpy(),
                                          g.pt_idx.numpy(), shape))
    if steps > 1:
        got["metrics"] = [(float(loss_v), float(session.update(grads)))]
        for _ in range(steps - 1):
            loss_k, _, grads_k = session.loss_and_grads(pscene)
            got["metrics"].append((float(loss_k), float(session.update(grads_k))))
        got["final"] = to_jax_tree(kind, {k: q.detach().numpy() for k, q in
                                          session.model.named_parameters() if q.requires_grad})
    return dict(name=name, kind=kind, widths=widths, seed=seed, params=params, metrics=metrics,
                first_grads=first[1], final=p, want_depths=want_depths, jax_calls=jax_calls,
                port_calls=calls_per_forward, got=got)


@pytest.fixture(params=sorted(CONFIGS))
def runs(request):
    return run(request.param)


def test_paths_match_jax(runs):
    """The JAX side's kernel entries (a spy, one trace of the forward and
    its gradient) and the port's wrappers on one forward + backward: the
    standalone update runs once in ``depth3`` in both packages and never
    elsewhere; at n_feat_proj = 16 (``synth_depth``) both packages take the
    same entries, the frontend per layer and no layer step or update, as
    neither packs a 16-wide stream."""
    name, jc, pc = runs["name"], runs["jax_calls"], runs["port_calls"]
    if name == "depth3":
        assert jc == {"fused_frontend": 2, "fused_layer_step": 1, "packed_edge_update": 1}
        assert pc == {"fused_frontend": 2, "fused_layer_step": 1, "projection_update": 1,
                      "fused_edge_combine": 1}
    elif name == "synth_depth":  # each layer's frontend, then its unfused update
        assert jc == {"fused_frontend": 3}
        assert pc == {"fused_frontend": 3, "fused_edge_combine": 3}
    elif name == "no_norm_depth":
        assert jc.get("packed_edge_update", 0) == jc.get("fused_frontend", 0) == 0
        assert pc == {"fused_edge_combine": 3}
    else:
        assert jc == {} and pc == {"fused_edge_combine": 3}


def test_params_from_jax_maps_every_leaf(runs):
    """The depth trees (no final update, view or scenepoint head; the last
    layer's or block's width adapter at the depth width) load back strictly,
    value for value."""
    kind, widths = runs["kind"], runs["widths"]
    model = MODELS[kind][0](**widths)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, runs["params"])),
                          strict=True)
    want = port_model(kind, widths, runs["seed"]).state_dict()
    assert sorted(model.state_dict()) == sorted(want)
    assert not any(k.startswith(("final_global_update", "view_head", "scenepoint_head"))
                   for k in want)
    assert any(k.startswith("depth_head") for k in want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_depths_and_loss_match_jax(runs):
    got, want = runs["got"], runs["want_depths"]
    dense = got["dense_depths"]
    assert np.array_equal(np.isnan(dense), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.isfinite(got["depths"]).all() and ok.sum() == got["depths"].shape[0]
    scale = float(np.abs(want[ok]).max())
    np.testing.assert_allclose(dense[ok], want[ok], rtol=1e-4, atol=2e-5 * scale)
    np.testing.assert_allclose(got["loss"], runs["metrics"][0][0], rtol=1e-5)


def test_depth_scale_and_ties(runs):
    """|s_pred| (the mean predicted depth, whose inverse scales the loss and
    every gradient) is not small, and no edge sits within 1e-5 of an L1 tie."""
    got = runs["got"]
    d, d_gt = got["depths"].astype(np.float64), got["scene"].gt_depths.numpy().astype(np.float64)
    s_pred = d.mean()
    assert abs(s_pred) >= 0.05, s_pred
    gap = np.abs(d / s_pred - d_gt / d_gt.mean())
    assert int((gap < 1e-5).sum()) == 0, gap.min()


def test_parameter_grads_match_jax(runs):
    want_leaves, got_leaves = leaves(runs["first_grads"]), leaves(runs["got"]["grads"])
    assert [jax.tree_util.keystr(k) for k, _ in got_leaves] == \
        [jax.tree_util.keystr(k) for k, _ in want_leaves]
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        w, g = np.asarray(w), np.asarray(g)
        scale = max(2e-4, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=5e-4 * scale, rtol=2e-3,
                                   err_msg=f"grad of {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("step", [0, 1, 2])
def test_depth3_adam_steps_match_jax_metrics(step):
    """Loss and gradient norm at each of three loss_and_grads + update steps."""
    r = run("depth3")
    rtol = 1e-5 if step == 0 else 2e-4
    for k, (g, w) in enumerate(zip(r["got"]["metrics"][step], r["metrics"][step])):
        np.testing.assert_allclose(g, w, rtol=rtol, err_msg=("loss", "grad_norm")[k])


def test_depth3_adam_parameters_match_jax():
    """Parameters after three steps: every entry within twice the summed
    learning rates, and every entry whose first-step gradient is above
    rounding noise (1e-6 x G) within a tenth of them (module docstring)."""
    r = run("depth3")
    lr_sum = sum(float(build_lr_schedule(
        OPTIM["lr"], OPTIM["main_scheduler"], OPTIM["lr_warmup_n_steps"],
        OPTIM["exp_gamma_after_n_steps"], OPTIM["exp_n_steps"])(k)) for k in range(3))
    first = r["first_grads"]
    G = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(first))
    for (path, w), (_, g), (_, g0) in zip(leaves(r["final"]), leaves(r["got"]["final"]),
                                          leaves(first)):
        w, g, g0 = np.asarray(w), np.asarray(g), np.asarray(g0)
        err, name = np.abs(g - w), jax.tree_util.keystr(path)
        np.testing.assert_array_less(err, 2.0 * 1.01 * lr_sum, err_msg=name)
        np.testing.assert_array_less(err[np.abs(g0) >= NOISE * G], 0.1 * lr_sum, err_msg=name)


def test_depth_layer_residual_layernorm_matches_flax_form():
    """The depth layer's residual LayerNorm (32 features per edge) on the
    stream that reaches it in ``depth3``: torch's two-pass ``nn.LayerNorm``
    against the JAX package's flax form, E[x^2] - mean^2, both float32."""
    kind, widths, scene_kw, seed = CONFIGS["depth3"]
    model = port_model(kind, widths, seed)
    scene = generate_synthetic_scene(store_depth_targets=True, **scene_kw).to_scene_graph(
        device="cpu")
    seen = []
    norm = model.equivariant_blocks[2].residual_skipconn_proj_norm_layer
    norm.register_forward_hook(lambda mod, args, out: seen.append((args[0], out)))
    with torch.no_grad():
        model(scene.graph)
    (x, got), = seen
    xj = jnp.asarray(x.numpy())
    mean = xj.mean(-1, keepdims=True)
    var = (xj * xj).mean(-1, keepdims=True) - mean * mean
    want = (xj - mean) * jax.lax.rsqrt(var + norm.eps) * norm.weight.detach().numpy() \
        + norm.bias.detach().numpy()
    assert_close(got, want, "residual LayerNorm")


# ---------------------------------------------------------------------------
# The per-layer plan, GT depths, the heads the models accept
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_layers,depth_feat,n_feat_proj",
                         [(2, 64, 32), (3, 32, 32), (4, 64, 32), (4, 32, 32), (3, 32, 16),
                          (4, 16, 16)])
def test_layer_plan_matches_jax(monkeypatch, num_layers, depth_feat, n_feat_proj):
    """Which kernel entry each package takes per forward, over layer counts,
    depth widths and both shipped stream widths (the JAX side traced with
    ``jax.eval_shape``): with 2 layers nothing is packed and the standalone
    update never runs; with the depth width equal to n_feat_proj every layer
    but the first is packed and the LAST layer runs the standalone update;
    at n_feat_proj = 16 nothing is packed in either package."""
    widths = dict(DEPTH3, num_layers=num_layers, depth_head_n_feat=depth_feat,
                  n_feat_proj=n_feat_proj)
    data = jax_synthetic_scene(store_depth_targets=True, **SMALL)
    jax_calls, port_calls = {}, {}
    spy(monkeypatch, jax_calls, JAX_KERNELS)
    spy(monkeypatch, port_calls, PORT_KERNELS)
    set_kernel_mode("interpret")
    scene = jax_build_scene_graph(data.M, data.Ns, data.y)
    jmodel = JaxGraphAttnSfMNet(**widths)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), scene.graph)
    jax_calls.clear()
    jax.eval_shape(jmodel.apply, params, scene.graph)
    model = port_model("gasfm", widths)
    pscene = build_scene_graph(data.M, data.Ns, data.y, device="cpu")
    with torch.no_grad():
        model(pscene.graph)
    L = num_layers
    packable = n_feat_proj == 32
    packed_tail = depth_feat == n_feat_proj
    want_update = int(packable and (L >= 3 or packed_tail))
    assert jax_calls.get("packed_edge_update", 0) == port_calls.get("projection_update", 0) \
        == want_update
    assert jax_calls.get("fused_layer_step", 0) == port_calls.get("fused_layer_step", 0) \
        == (0 if not packable else L - 1 if packed_tail else max(L - 2, 0))
    plan = model.layer_plan(pscene.graph)
    assert [defer for _, defer in plan].count(False) == \
        (L if not packable else 1 if packed_tail else 2 if L >= 3 else L)


def test_gt_depths_match_jax_scene_data():
    """The port's triangulated GT depths, dense (m, n) and per edge by
    (camera, point), against the JAX package's ``SceneData`` on both small
    scenes; set-up raises for an uncalibrated scene, as there."""
    for kw in (SMALL, SYNTH):
        jdata = jax_synthetic_scene(**kw)
        want = JaxSceneData(jdata.M, jdata.Ns, jdata.y, "s", calibrated=True,
                            store_depth_targets=True)
        got = SceneData(jdata.M, jdata.Ns, jdata.y, "s", calibrated=True,
                        store_depth_targets=True)
        ok = want.valid_pts
        np.testing.assert_allclose(got.depths[ok], want.depths[ok], rtol=1e-6, atol=0)
        assert np.array_equal(got.depths, generate_synthetic_scene(
            store_depth_targets=True, **kw).depths)
        pscene = got.to_scene_graph(device="cpu")
        jscene = jax_build_scene_graph(jdata.M, jdata.Ns, jdata.y, gt_depths_dense=want.depths)
        mask = np.asarray(jscene.graph.edge_mask)
        shape = want.depths.shape
        g = pscene.graph
        np.testing.assert_allclose(
            dense_by_pair(pscene.gt_depths.numpy(), g.cam_idx.numpy(), g.pt_idx.numpy(), shape),
            dense_by_pair(np.asarray(jscene.gt_depths)[mask],
                          np.asarray(jscene.graph.cam_idx)[mask],
                          np.asarray(jscene.graph.pt_idx)[mask], shape),
            rtol=1e-6, atol=0)
    with pytest.raises(NotImplementedError):
        SceneData(jdata.M, jdata.Ns, jdata.y, "s", calibrated=False, store_depth_targets=True)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_head_combinations_no_loss_accepts_raise(kind):
    """The depth head beside another head, exactly one explicit head, or no
    head at all: no loss of the JAX package accepts them."""
    widths = DEPTH3 if kind == "gasfm" else CONFIGS["dpesfm_depth"][1]
    for depth, view, pts in ((True, True, True), (True, True, False), (False, True, False),
                             (False, False, True), (False, False, False)):
        with pytest.raises(NotImplementedError, match="losses.py:344-359"):
            MODELS[kind][0](**dict(widths, depth_head_enabled=depth, view_head_enabled=view,
                                   scenepoint_head_enabled=pts))


def test_fused_step_raises_for_a_depth_model():
    session = TrainingSession(port_model("gasfm", DEPTH3), DirectDepthLoss(**DEPTH_LOSS),
                              device="cpu")
    scene = generate_synthetic_scene(store_depth_targets=True, **SMALL).to_scene_graph(
        device="cpu")
    with pytest.raises(ValueError, match="loss_and_grads"):
        session.fused_step(scene)
    with pytest.raises(NotImplementedError):
        DirectDepthLoss("L1", calibrated=False)
