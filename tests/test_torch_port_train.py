"""The port's training step against the JAX package, on the CPU.

- Gradients: every parameter gradient of the 4-layer ``flagship_shape``
  model (tests/test_torch_port_model.py) through the ESFM loss with the
  flagship conf's valid-only gradient equalization, against
  ``jax.value_and_grad`` through the JAX ``ESFMLoss`` with the packed and
  merged Pallas kernels in interpret mode; the port runs its kernels' plain
  versions under autograd. Tolerance: tests/test_packed.py's between two JAX
  kernel paths, atol 5e-4 x max(2e-4, the leaf's max |grad|), rtol 2e-3.
- Three Adam steps against the JAX ``build_optimizer`` chain (composite XLA
  path, a 2-step warm-up then exponential decay so that the steps cover both
  phases of the schedule): loss, ``our_repro`` and the global gradient norm
  at each step, and the parameters after the three steps.
- The LR schedules, ``advance_schedule`` and both clip modes against the
  JAX package and optax; ``our_repro`` against ``core_errors_device``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gasfm_tpu.config import ConfigFactory
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.eval.metrics import core_errors_device as jax_core_errors
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.losses import ESFMLoss as JaxESFMLoss
from gasfm_tpu.models.convert import convert_reference_state_dict
from gasfm_tpu.models.gasfm import GraphAttnSfMNet as JaxGraphAttnSfMNet
from gasfm_tpu.ops.segment import set_kernel_mode
from gasfm_tpu.train.schedules import build_lr_schedule as jax_schedule
from gasfm_tpu.train.state import advance_schedule_count
from gasfm_tpu.train.state import build_optimizer as jax_build_optimizer

from gasfm_tpu_torch.eval.metrics import core_errors_device
from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.losses import ESFMLoss, FLAGSHIP_LOSS
from gasfm_tpu_torch.models.convert import params_from_jax
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.train.schedules import build_lr_schedule
from gasfm_tpu_torch.train.state import build_optimizer, clip_grads, global_norm
from gasfm_tpu_torch.train.loop import TrainingSession

from test_torch_port_model import CONFIGS

FLAGSHIP_SHAPE = CONFIGS["flagship_shape"]
# The optimizer of the Adam-steps test: the flagship's chain with a 2-step
# warm-up and a short decay, and a learning rate that moves the parameters.
OPTIM = dict(lr=1e-3, main_scheduler="exponential", lr_warmup_n_steps=2, exp_n_steps=10,
             exp_gamma_after_n_steps=0.1, grad_clip_mode=None)
CONF = """
model { view_head { enabled = true }, scenepoint_head { enabled = true } }
loss {
  infinity_pts_margin = 0.0001
  pts_grad_equalization_pre_perspective_divide = true
  normalize_grad_wrt_valid_projections_only = true
  hinge_loss = true
  hinge_loss_weight = 1
  grad_clip_mode = %(clip)s
  grad_clip_th = %(th)s
}
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


def conf(clip="null", th="null"):
    return ConfigFactory.parse_string(CONF % dict(clip=clip, th=th))


def scene_data():
    return jax_synthetic_scene(n_views=8, n_points=600, visibility=0.5, seed=9)


def jax_setup(data):
    scene = jax_build_scene_graph(data.M, data.Ns, data.y)
    model = JaxGraphAttnSfMNet(**FLAGSHIP_SHAPE)
    params = model.init(jax.random.PRNGKey(0), scene.graph)
    loss = JaxESFMLoss(conf())

    def loss_fn(p):
        pred = model.apply(p, scene.graph)
        return loss(pred, scene), pred

    return scene, params, loss_fn


def port_session(params, data, optim=None):
    model = GraphAttnSfMNet(**FLAGSHIP_SHAPE)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    session = TrainingSession(model, ESFMLoss(**FLAGSHIP_LOSS), device="cpu", optim=optim)
    return session, build_scene_graph(data.M, data.Ns, data.y, device="cpu")


def port_tree(session, tensors):
    """One tensor per parameter of the port -> the flax tree of the JAX
    model (the JAX package's reference-checkpoint converter)."""
    names = [k for k, p in session.model.named_parameters() if p.requires_grad]
    return convert_reference_state_dict(
        {k: t.detach().numpy() for k, t in zip(names, tensors)}, "graph_attn_sfm.GraphAttnSfMNet")


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def model_grad_pairs():
    """[(leaf path, port gradient, JAX gradient)] of the 4-layer model, and
    the loss first: port plain path under autograd against
    jax.value_and_grad with the Pallas kernels in interpret mode (the
    environment of tests/test_packed.py)."""
    data = scene_data()
    mp = pytest.MonkeyPatch()
    mp.setenv("GASFM_PACKED", "1")
    mp.setenv("GASFM_MERGED", "1")
    set_kernel_mode("interpret")
    try:
        scene, params, loss_fn = jax_setup(data)
        (want_loss, _), want = jax.value_and_grad(loss_fn, has_aux=True)(params)
    finally:
        set_kernel_mode("auto")
        mp.undo()
    session, port_scene = port_session(params, data)
    loss, _, grads = session.loss_and_grads(port_scene)
    got = port_tree(session, grads)
    want_leaves, got_leaves = leaves(want), leaves(got)
    assert [jax.tree_util.keystr(k) for k, _ in got_leaves] == \
        [jax.tree_util.keystr(k) for k, _ in want_leaves]
    return [("loss", float(loss), float(want_loss))] + [
        (jax.tree_util.keystr(path), np.asarray(g), np.asarray(w))
        for (path, w), (_, g) in zip(want_leaves, got_leaves)]


def test_model_parameter_grads_match_jax():
    (_, loss, want_loss), *pairs = model_grad_pairs()
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for path, g, w in pairs:
        scale = max(2e-4, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=5e-4 * scale, rtol=2e-3, err_msg=f"grad of {path}")


@pytest.fixture(scope="module")
def adam_runs():
    """Three steps of each side from the same initial parameters:
    [(loss, our_repro, grad_norm)] per step, the JAX side's first-step
    gradients, the initial and both final parameter trees."""
    data = scene_data()
    scene, params, loss_fn = jax_setup(data)
    tx, _ = jax_build_optimizer(conf())
    opt_state = tx.init(params)
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    want, p, first_grads = [], params, None
    for _ in range(3):
        (loss, pred), grads = step(p)
        first_grads = grads if first_grads is None else first_grads
        norm = optax.global_norm(grads)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        repro = jax_core_errors(pred, scene)["our_repro"]
        want.append((float(loss), float(repro), float(norm)))
    session, port_scene = port_session(params, data, optim=OPTIM)
    got = [tuple(float(v) for v in session.fused_step(port_scene)) for _ in range(3)]
    final = port_tree(session, [q for q in session.model.parameters() if q.requires_grad])
    return want, got, first_grads, params, p, final


# Some gradients of this model are 0 in exact arithmetic: a segment's
# softmax-logit gradients sum to 0, so the query's gradient is 0 wherever all
# of the segment's edges take the same LeakyReLU branch, and with it those of
# the query adapters, lin_r and, for the global pools, att. In float32 both
# packages return rounding noise there (<= 3e-8 against a largest gradient
# of ~1 on this scene), and Adam, which normalizes each entry's step, moves
# such entries by up to ~lr in a direction set by the noise.
NOISE = 1e-6  # leaves whose first-step max |grad| is below NOISE x the largest


@pytest.mark.parametrize("step", [0, 1, 2])
def test_adam_steps_match_jax_metrics(adam_runs, step):
    """Loss, our_repro and the global gradient norm at each step. Step 0
    (the same weights): rtol 1e-5 for loss and our_repro, 1e-4 for the norm
    (a norm over every gradient, whose near-cancelling entries carry
    relative rounding ~1e-5). Later steps: rtol 2e-4 — the weights then
    differ in the noise-gradient entries by up to ~lr (see NOISE), which
    moves the loss by ~6e-5 relative on this scene."""
    want, got = adam_runs[:2]
    rtol = 1e-5 if step == 0 else 2e-4
    (wl, wr, wn), (gl, gr, gn) = want[step], got[step]
    np.testing.assert_allclose(gl, wl, rtol=rtol, err_msg="loss")
    np.testing.assert_allclose(gr, wr, rtol=rtol, err_msg="our_repro")
    np.testing.assert_allclose(gn, wn, rtol=max(rtol, 1e-4), err_msg="grad_norm")


def test_adam_steps_match_jax_parameters(adam_runs):
    """Parameters after three steps. Leaves with a gradient signal:
    |err| <= 1e-6 + 1e-4 |ref|. Noise-gradient leaves (see NOISE): each
    entry within twice the sum of the three learning rates of the other
    side, the most two Adam trajectories can part in three steps (an Adam
    step moves an entry by at most ~lr while the moments are this young)."""
    _, _, first_grads, _, want, got = adam_runs
    lr_sum = sum(float(build_lr_schedule(
        OPTIM["lr"], OPTIM["main_scheduler"], OPTIM["lr_warmup_n_steps"],
        OPTIM["exp_gamma_after_n_steps"], OPTIM["exp_n_steps"])(k)) for k in range(3))
    G = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(first_grads))
    n_noise = 0
    for (path, w), (_, g), (_, g0) in zip(leaves(want), leaves(got), leaves(first_grads)):
        w, g, name = np.asarray(w), np.asarray(g), jax.tree_util.keystr(path)
        if float(np.abs(np.asarray(g0)).max()) < NOISE * G:
            n_noise += 1
            np.testing.assert_array_less(np.abs(g - w), 2.0 * 1.01 * lr_sum, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4, err_msg=name)
    assert 0 < n_noise < len(leaves(want)) // 2  # 110 of 318 leaves on this scene


@pytest.mark.parametrize("kind", ["exponential", "multistep", "constant", "no_warmup"])
def test_lr_schedule_matches_jax(kind):
    kw = dict(base_lr=1e-4, main_scheduler=kind, lr_warmup_n_steps=2500)
    if kind in ("exponential", "no_warmup"):
        kw.update(main_scheduler="exponential", exp_gamma_after_n_steps=0.1, exp_n_steps=35000)
    if kind == "multistep":
        kw.update(multistep_milestones=[100, 1000, 30000], multistep_gamma=0.3, milestone_shift=7)
    if kind == "no_warmup":
        kw["lr_warmup_n_steps"] = 0
    steps = np.array([0, 1, 2, 99, 1250, 2499, 2500, 2501, 2607, 3507, 10000, 37500, 100000])
    want = np.asarray(jax_schedule(**kw)(jnp.asarray(steps)))
    got = build_lr_schedule(**kw)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    scalar = build_lr_schedule(**kw)
    assert [float(scalar(int(s))) for s in steps] == pytest.approx(list(want), rel=1e-6)


def test_advance_schedule_steps_the_schedule_not_adams_count():
    """update, a batch without one (advance_schedule), update: the second
    update uses lr(2) and Adam's bias correction of its second step, as the
    JAX chain with advance_schedule_count does."""
    g1 = np.array([0.5, -2.0, 1e-3], np.float32)
    g2 = np.array([-0.25, 1.0, 3.0], np.float32)
    x0 = np.array([1.0, 2.0, -3.0], np.float32)
    tx, _ = jax_build_optimizer(conf())
    params = {"x": jnp.asarray(x0)}
    state = tx.init(params)
    for k, g in enumerate((g1, g2)):
        updates, state = tx.update({"x": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        if k == 0:
            state = advance_schedule_count(state)
    counted = (optax.ScaleByAdamState, optax.ScaleByScheduleState)
    counts = {type(s).__name__: int(s.count) for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: isinstance(s, counted)) if isinstance(s, counted)}
    x = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    opt = build_optimizer([x], **OPTIM)
    opt.step([torch.from_numpy(g1)])
    opt.advance_schedule()
    opt.step([torch.from_numpy(g2)])
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(params["x"]), rtol=1e-6)
    assert opt.schedule_count == 3 and int(opt.adam.state[x]["step"]) == 2
    assert counts == {"ScaleByAdamState": 2, "ScaleByScheduleState": 3}


@pytest.mark.parametrize("mode,threshold", [("norm", 0.5), ("norm", 100.0), ("value", 0.3)])
def test_clip_modes_match_optax(mode, threshold):
    """clip_by_global_norm (active and inactive) and clip, exactly optax's
    formulas: rtol 1e-6."""
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    tx = optax.clip_by_global_norm(threshold) if mode == "norm" else optax.clip(threshold)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    got = clip_grads([torch.from_numpy(g) for g in grads], mode, threshold)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(global_norm([torch.from_numpy(g) for g in grads])),
                               float(optax.global_norm([jnp.asarray(g) for g in grads])),
                               rtol=1e-6)


def test_our_repro_matches_jax_core_errors():
    """Random predictions on the small scene: rtol 1e-5 (float32 sums over
    the edges in another order)."""
    data = scene_data()
    rng = np.random.default_rng(1)
    m, n = data.y.shape[0], data.M.shape[1]
    Ps = rng.standard_normal((m, 3, 4)).astype(np.float32)
    Ps[:, :, 3] += np.array([0.0, 0.0, 4.0], np.float32)
    pts = np.concatenate([rng.standard_normal((3, n)), np.ones((1, n))]).astype(np.float32)
    jscene = jax_build_scene_graph(data.M, data.Ns, data.y)
    jm, jn = jscene.graph.num_cams, jscene.graph.num_pts
    want = jax_core_errors(
        {"Ps_norm": jnp.asarray(np.concatenate([Ps, np.zeros((jm - m, 3, 4), np.float32)])),
         "pts3D": jnp.asarray(np.pad(pts, ((0, 0), (0, jn - n))))}, jscene)["our_repro"]
    scene = build_scene_graph(data.M, data.Ns, data.y, device="cpu")
    got = core_errors_device({"Ps_norm": torch.from_numpy(Ps), "pts3D": torch.from_numpy(pts)},
                             scene)["our_repro"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module



@pytest.fixture(scope="module")
def tie_runs():
    """The 4-layer model's plain forward in float32 with chip_smoke.py's
    activation branches recorded, and in float64 compared with them."""
    import copy

    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene

    cs = _chip_smoke()
    scene = generate_synthetic_scene(n_views=8, n_points=600, visibility=0.5,
                                     seed=9).to_scene_graph(device="cpu")
    model = GraphAttnSfMNet(**FLAGSHIP_SHAPE, generator=torch.Generator().manual_seed(0))
    ref64 = copy.deepcopy(model).double()
    scene64 = cs.float64_scene(scene)
    acts = cs.ActivationBranches()
    with torch.no_grad():
        with acts.watch("record"):
            pred32 = model(scene.graph, plain=True)
        with acts.watch("compare"):
            pred64 = ref64(scene64.graph, plain=True)
    return dict(cs=cs, scene=scene, scene64=scene64, model=model, ref64=ref64, pred32=pred32,
                pred64=pred64, acts=acts)


def test_margin_tie_allowance_is_the_float64_jump_of_the_flipped_edge(tie_runs):
    """chip_smoke.py's step-1 rule allows, per parameter, the most that the
    branches the kernel path took otherwise than float64 move its gradient
    (``branch_ties``); the ESFM loss's branch is its margin test. With the
    margin set between one edge's float32 and float64 depth, so that
    exactly that edge flips, the allowance must be the difference of the
    float64 gradients of ``ESFMLoss`` at that margin and at one just past
    the edge's float64 depth (which moves that edge alone across it; the
    margin enters no gradient otherwise), to 1e-9 of the largest; with no
    flip it is 0."""
    t = tie_runs
    cs, g, scene64, ref64 = t["cs"], t["scene"].graph, t["scene64"], t["ref64"]
    assert not t["acts"].flips  # no activation sits within a rounding of 0 here
    cam, pt = g.cam_idx.long(), g.pt_idx.long()

    def depth(pred):
        P = pred["Ps_norm"].reshape(g.num_cams, 12)[cam].reshape(-1, 3, 4)
        return (P[:, 2] * pred["pts3D"].T[pt]).sum(-1).double().numpy()

    d32, d64 = depth(t["pred32"]), depth(t["pred64"])
    both = np.concatenate([d32, d64])
    for j in np.argsort(-np.abs(d32 - d64)):
        margin = 0.5 * (d32[j] + d64[j])
        past = np.nextafter(d64[j], np.inf) if d64[j] >= margin else d64[j]
        lo, hi = min(margin, past), max(margin, past)
        if d64[j] > 1e-3 and ((both >= lo) & (both <= hi)).sum() == 1 + (lo <= d32[j] <= hi):
            break  # only edge j's depths lie between the two margins
    else:
        pytest.fail("no edge whose float32 and float64 depths straddle a margin alone")

    def session(m):
        loss = ESFMLoss(**{**FLAGSHIP_LOSS, "infinity_pts_margin": float(m)})
        return TrainingSession(ref64, loss, device="cpu")

    at = session(margin).loss_and_grads(scene64, plain=True)[2]
    want = [float((a - b).abs().max())
            for a, b in zip(session(past).loss_and_grads(scene64, plain=True)[2], at)]
    info, ties = cs.branch_ties(session(margin), scene64, t["pred32"], t["pred64"], at, t["acts"])
    assert (info["act_flips"], info["loss_flips"]) == (0, 1)
    assert info["loss_nearest"] == float(np.abs(d64 - margin).min())
    assert max(want) > 0
    np.testing.assert_allclose(ties, want, rtol=0, atol=1e-9 * max(want))
    assert cs.branch_ties(session(margin), scene64, t["pred64"], t["pred64"], at,
                          t["acts"])[1] == [0.0] * len(at)



@pytest.mark.parametrize("kind", ["relu", "leaky_relu"])
def test_activation_tie_allowance_is_the_float64_jump_of_the_flipped_element(tie_runs, kind,
                                                                            monkeypatch):
    """``branch_ties``'s activation branches: an activation recorded in
    float32 (the view head's first hidden ReLU; the first LeakyReLU of the
    single-segment pools, ``ops.gatv2.leaky_relu``) is given the other
    branch on the element whose float64 input lies nearest 0, as if the
    float32 path had rounded it across. ``ActivationBranches`` must find
    that element in the float64 run, and the allowance must be the
    difference of the float64 gradients with and without that element
    taking the float32 branch, the latter forced here by other means (a
    forward hook on the ReLU module; a wrapper of ``leaky_relu`` at its
    first call), to 1e-9 of the largest."""
    from gasfm_tpu_torch.ops import gatv2

    t = tie_runs
    cs, scene64, model, ref64 = t["cs"], t["scene64"], t["model"], t["ref64"]
    seen, force, calls = {}, {}, []
    if kind == "relu":
        first = [k for k, m in model.view_head.named_children() if isinstance(m, torch.nn.ReLU)][0]

        def keep(tag):
            return lambda mod, inp, out: seen.__setitem__(tag, inp[0].detach())

        def forced(mod, inp, out):
            return torch.where(force["mask"], inp[0], torch.zeros_like(inp[0])) \
                if "mask" in force else out

        hooks = [getattr(model.view_head, first).register_forward_hook(keep(torch.float32)),
                 getattr(ref64.view_head, first).register_forward_hook(keep(torch.float64)),
                 getattr(ref64.view_head, first).register_forward_hook(forced)]
        branch = (lambda z: z > 0)
    else:
        leaky = gatv2.leaky_relu

        def first_call(z, negative_slope=gatv2.NEGATIVE_SLOPE):
            calls.append(None)
            if len(calls) > 1:
                return leaky(z, negative_slope)
            seen.setdefault(z.dtype, z.detach())
            if "mask" in force:
                return torch.where(force["mask"], z, negative_slope * z)
            return leaky(z, negative_slope)

        monkeypatch.setattr(gatv2, "leaky_relu", first_call)
        hooks = []
        branch = (lambda z: z >= 0)
    acts = cs.ActivationBranches()
    with torch.no_grad():
        with acts.watch("record"):
            model(t["scene"].graph, plain=True)
        calls.clear()
        with acts.watch("compare"):
            ref64(scene64.graph, plain=True)
    assert not acts.flips
    z32, z64 = seen[torch.float32], seen[torch.float64]
    keys = [k for k, b in acts.signs.items() if b.shape == z32.shape and torch.equal(b, branch(z32))]
    assert len(keys) == 1, keys
    e = int(z64.abs().argmin())
    taken = acts.signs[keys[0]].clone()
    taken.view(-1)[e] = ~taken.view(-1)[e]
    acts.signs[keys[0]] = taken
    with torch.no_grad(), acts.watch("compare"):
        pred64 = ref64(scene64.graph, plain=True)
    session = TrainingSession(ref64, ESFMLoss(**FLAGSHIP_LOSS), device="cpu")
    at = session.loss_and_grads(scene64, plain=True)[2]
    info, ties = cs.branch_ties(session, scene64, pred64, pred64, at, acts)
    assert (info["act_flips"], info["loss_flips"]) == (1, 0)
    assert info["act_far"] == float(z64.abs().min())
    force["mask"] = taken
    calls.clear()
    try:
        along = session.loss_and_grads(scene64, plain=True)[2]
    finally:
        for h in hooks:
            h.remove()
    want = [float((a - b).abs().max()) for a, b in zip(along, at)]
    assert max(want) > 0
    np.testing.assert_allclose(ties, want, rtol=0, atol=1e-9 * max(want))
