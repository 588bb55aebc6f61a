"""The port's DPESFM slice (``SetOfSetNet``, its ESFM loss and training
step) against the JAX package, on the CPU.

- Weight carrying: ``params_from_jax`` maps a flax init of the JAX
  ``SetOfSetNet`` onto the port with every leaf used (strict load), and the
  JAX package's reference-checkpoint converter maps the port's
  ``state_dict`` back onto the same flax tree, leaf for leaf.
- The slice as a whole, in two configurations: the DPESFM conf's structure
  (one block of three layers, no block residual) at width 32, and two
  blocks of two layers at width 24 with the block residual (the first
  block's through ``skip_projection``) and 6d rotations. On the scene of
  tests/test_kernel_dispatch.py (9 views, 700 points) the JAX side runs its
  windowed / dense segment kernels and the fused edge combine in interpret
  mode; the port runs its kernels' plain versions (CPU tensors). Compared:
  ``Ps_norm``, ``pts3D``, the loss with the DPESFM conf's equalization over
  all edges, every parameter gradient, and three Adam steps under
  ``DPESFM_OPTIM`` (the JAX chain from the same conf values).

Tolerances. Forward: rtol 1e-4, atol 1e-5 x the output's scale (three or
four layers of float32 segment means and 32-wide linears summed in another
order). Loss: rtol 1e-5. Gradients: |err| <= 2e-4 x the leaf's max |grad|
+ 1e-3 x |ref| (tests/test_kernel_dispatch.py's bounds between two JAX
kernel paths), except on leaves whose max |grad| is below 1e-6 x the
model's largest gradient G: the mean-centering after every layer but a
block's last removes any per-column constant, so the gradients of those
layers' biases and global linears (and of a block's skip_projection bias)
are 0 in exact arithmetic, and both packages return float32 rounding noise
there (~1e-9 x G); the port's must then be below 1e-6 x G too. Adam: loss,
``our_repro`` and the gradient norm rtol 1e-5 at the first step, 2e-4 after
(as in tests/test_torch_port_train.py); parameters |err| <= 1e-6 + 1e-4
|ref|, except on the noise-gradient leaves, where Adam, which normalizes
each entry's step, moves entries by up to ~lr in a direction the noise
sets: there each entry within twice the sum of the three learning rates.
"""

import numpy as np
import pytest

import jax
import optax

from gasfm_tpu.config import ConfigFactory
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.eval.metrics import core_errors_device as jax_core_errors
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.losses import ESFMLoss as JaxESFMLoss
from gasfm_tpu.models.convert import convert_reference_state_dict
from gasfm_tpu.models.set_of_set import SetOfSetNet as JaxSetOfSetNet
from gasfm_tpu.ops.segment import set_kernel_mode
from gasfm_tpu.train.state import build_optimizer as jax_build_optimizer

from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.losses import DPESFM_LOSS, ESFMLoss
from gasfm_tpu_torch.models.convert import params_from_jax
from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
from gasfm_tpu_torch.train.loop import TrainingSession
from gasfm_tpu_torch.train.schedules import build_lr_schedule
from gasfm_tpu_torch.train.state import DPESFM_OPTIM

CONFIGS = {
    # The DPESFM conf's structure (confs/dpesfm/learning_euc_noaug_dpesfm.conf)
    # at width 32.
    "dpesfm_shape": dict(num_blocks=1, block_size=3, num_features=32,
                         add_skipconn_for_residual_blocks=False),
    # Two blocks with the residual: the first through skip_projection (2 ->
    # 24, then mean-centered), the second the identity; 6d rotations.
    "residual_6d": dict(num_blocks=2, block_size=2, num_features=24,
                        add_skipconn_for_residual_blocks=True, rot_representation="6d"),
}
# The DPESFM conf's loss and optimizer, in conf form for the JAX package.
CONF = """
model { view_head { enabled = true }, scenepoint_head { enabled = true } }
loss {
  infinity_pts_margin = 0.0001
  pts_grad_equalization_pre_perspective_divide = true
  normalize_grad_wrt_valid_projections_only = false
  hinge_loss = true
  hinge_loss_weight = 1
  grad_clip_mode = null
}
train {
  lr = 0.001
  lr_schedule {
    lr_warmup_n_steps = 0
    main_scheduler = "multistep"
    multistep_milestones = [60000]
    multistep_gamma = 0.5
  }
}
"""
NOISE = 1e-6  # leaves whose max |grad| is below NOISE x the largest: rounding noise


def conf():
    return ConfigFactory.parse_string(CONF)


def scene_data():
    return jax_synthetic_scene(n_views=9, n_points=700, visibility=0.35, seed=3)


def keystr(path):
    return jax.tree_util.keystr(path)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request):
    """The JAX forward, loss and gradients with the Pallas kernels in
    interpret mode, then three Adam steps (XLA path) from the same init."""
    widths = CONFIGS[request.param]
    data = scene_data()
    scene = jax_build_scene_graph(data.M, data.Ns, data.y)
    model = JaxSetOfSetNet(**widths)
    loss_obj = JaxESFMLoss(conf())

    def loss_fn(p):
        pred = model.apply(p, scene.graph)
        return loss_obj(pred, scene), pred

    set_kernel_mode("interpret")
    try:
        params = model.init(jax.random.PRNGKey(0), scene.graph)
        (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    finally:
        set_kernel_mode("auto")
    tx, _ = jax_build_optimizer(conf())
    opt_state = tx.init(params)
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    steps, p = [], params
    for _ in range(3):
        (l, pr), g = step(p)
        norm = optax.global_norm(g)
        updates, opt_state = tx.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        steps.append((float(l), float(jax_core_errors(pr, scene)["our_repro"]), float(norm)))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(widths=widths, data=data, params=to_np(params), grads=to_np(grads),
                pred={k: np.asarray(v) for k, v in pred.items()}, loss=float(loss),
                steps=steps, final=to_np(p))


def port_session(run):
    model = SetOfSetNet(**run["widths"])
    model.load_state_dict(params_from_jax(run["params"]), strict=True)
    session = TrainingSession(model, ESFMLoss(**DPESFM_LOSS), device="cpu", optim=DPESFM_OPTIM)
    data = run["data"]
    return session, build_scene_graph(data.M, data.Ns, data.y, device="cpu")


def port_tree(session, tensors):
    names = [k for k, p in session.model.named_parameters() if p.requires_grad]
    return convert_reference_state_dict(
        {k: t.detach().numpy() for k, t in zip(names, tensors)}, "SetOfSet.SetOfSetNet")


def leaf_pairs(got, want):
    g, w = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert [keystr(k) for k, _ in g] == [keystr(k) for k, _ in w]
    return [(keystr(k), np.asarray(a), np.asarray(b)) for (k, a), (_, b) in zip(g, w)]


@pytest.fixture(scope="module")
def port_grads(jax_run):
    session, scene = port_session(jax_run)
    loss, pred, grads = session.loss_and_grads(scene)
    return scene, pred, float(loss), port_tree(session, grads)


def test_params_from_jax_uses_every_leaf_both_ways(jax_run):
    model = SetOfSetNet(**jax_run["widths"])
    model.load_state_dict(params_from_jax(jax_run["params"]), strict=True)
    back = convert_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, "SetOfSet.SetOfSetNet")
    for name, got, want in leaf_pairs(back, jax_run["params"]):
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("key", ["Ps_norm", "pts3D"])
def test_forward_matches_jax(jax_run, port_grads, key):
    scene, pred, _, _ = port_grads
    m, n = scene.graph.num_cams, scene.graph.num_pts
    want = jax_run["pred"][key]
    want = want[:m] if key == "Ps_norm" else want[:, :n]
    got = pred[key].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1e-3, float(np.abs(want).max())), err_msg=key)


def test_loss_matches_jax(jax_run, port_grads):
    np.testing.assert_allclose(port_grads[2], jax_run["loss"], rtol=1e-5)


def test_parameter_grads_match_jax(jax_run, port_grads):
    pairs = leaf_pairs(port_grads[3], jax_run["grads"])
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


@pytest.fixture(scope="module")
def port_steps(jax_run):
    session, scene = port_session(jax_run)
    steps = [tuple(float(v) for v in session.fused_step(scene)) for _ in range(3)]
    final = port_tree(session, [q for q in session.model.parameters() if q.requires_grad])
    return steps, final


@pytest.mark.parametrize("step", [0, 1, 2])
def test_adam_steps_match_jax_metrics(jax_run, port_steps, step):
    rtol = 1e-5 if step == 0 else 2e-4
    (wl, wr, wn), (gl, gr, gn) = jax_run["steps"][step], port_steps[0][step]
    np.testing.assert_allclose(gl, wl, rtol=rtol, err_msg="loss")
    np.testing.assert_allclose(gr, wr, rtol=rtol, err_msg="our_repro")
    np.testing.assert_allclose(gn, wn, rtol=max(rtol, 1e-4), err_msg="grad_norm")


def test_adam_steps_match_jax_parameters(jax_run, port_steps):
    lr_sum = sum(float(build_lr_schedule(
        DPESFM_OPTIM["lr"], DPESFM_OPTIM["main_scheduler"], DPESFM_OPTIM["lr_warmup_n_steps"],
        multistep_milestones=DPESFM_OPTIM["multistep_milestones"],
        multistep_gamma=DPESFM_OPTIM["multistep_gamma"])(k)) for k in range(3))
    first = {name: w for name, _, w in leaf_pairs(jax_run["grads"], jax_run["grads"])}
    G = max(float(np.abs(w).max()) for w in first.values())
    n_noise = 0
    for name, got, want in leaf_pairs(port_steps[1], jax_run["final"]):
        if float(np.abs(first[name]).max()) < NOISE * G:
            n_noise += 1
            np.testing.assert_array_less(np.abs(got - want), 2.0 * 1.01 * lr_sum, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4, err_msg=name)
    assert n_noise < len(first) // 2
