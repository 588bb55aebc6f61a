"""Mixed-precision training in the port against the JAX package, on the CPU:
bf16 Adam moments (``train.adam_mu_dtype``, ``train.adam_nu_dtype``) and
bf16 weights with an f32 master (``train.param_dtype``).

- Adam, each branch the conf can select: ``mu`` bf16 alone (optax.adam's
  ``mu_dtype``), ``nu`` bf16 alone and both (the clone
  ``_scale_by_adam_cast``), bf16 weights with f32 moments and with bf16
  ones (``_with_f32_master``). 10 updates of the port's ``Optimizer`` (the
  kernel's plain version) against ``build_optimizer`` on the same numpy
  gradients, with a 4-step warm-up and ``grad_clip_mode = norm`` (the
  threshold inside the gradients' range, so that some updates clip):
  - against ``tx.update`` run op by op: ``count`` equal; bf16 moments and
    bf16 weights bitwise; the f32 moments within 8 float32 ulps of the
    tensor's largest entry (atol 1e-6 x max |x|: the clip's global norm sums
    in another order in each package); the master and f32 parameters within
    4 ulps (rtol 5e-7);
  - against the jitted ``tx.update`` (XLA contracts ``a * b + c`` to an FMA
    and keeps the bf16 ``b1 * mu`` of optax's branch in f32): norm-wise,
    relative to the JAX tensor, the moments within 1e-5 (measured: at most
    1.2e-7, the clone's bf16 moments bitwise) and the parameters'
    displacement from their start within 1e-5 (measured: at most 5.7e-7);
    optax's bf16 ``mu`` branch within 2e-2 for both (~5 bf16 epsilons;
    measured: 6.4e-3 and 2.8e-3; XLA skips the product's rounding on every
    update, the port rounds as the program says).
- The bf16 ``TorchDense`` against the JAX ``TorchDense`` with bf16 params,
  forward and ``jax.vjp``: the output within rtol 1e-5 norm-wise (the two
  GEMMs sum the same exact bf16 products in other orders); ``dx``, ``dW``
  and ``db`` bf16-rounded in both, so elementwise within one bf16 ulp
  (rtol 2^-7; their f32 values differ by rounding, which moves a bf16
  rounding across its boundary now and then: 3 of 14,400 entries of dx
  here) with all but 1% of the entries bitwise.
- A 2-layer, 16/32-wide GASFM (``_flagship_conf(small=True)``: the unfused
  path in both packages) and a 2-layer DPESFM, each with ``train.param_dtype
  = bf16`` and both moments bf16, three steps of
  ``TrainingSession.from_conf`` (``loss_and_grads`` + ``update``, then
  ``fused_step`` twice) against the JAX step of
  ``tests/test_train_components.py:482-534`` (XLA path) from the same init
  (the port's, carried into the JAX tree):
  - the losses per step, rtol 1e-5 (a bf16 rounding that flips between
    the packages moves one element by ~2^-8; measured: at most 2.7e-7);
  - the step-1 bf16 gradients norm-wise per leaf, within 4 bf16 epsilons
    (2^-6) of the leaf's norm (measured: GASFM at most 1.04 epsilons, most
    leaves bitwise; DPESFM bitwise); leaves whose gradient is 0 in exact
    arithmetic (max |g| below 1e-6 x the largest) are rounding noise in
    both packages and are held to 2^-6 of the largest leaf's norm instead;
  - the f32 master after step 1: Adam's first step moves every entry by
    lr times the sign of its gradient (for |g| >> eps), so the masters,
    which start from the same bf16 weights, differ by no entry more than
    2 lr, and agree within 1e-6 (|w| + lr) on all but 1% of the entries
    whose gradient is not noise (|g| at least 1e-6 x the largest); a noise
    entry (the zero gradients of ``tests/test_torch_port_train.py``, ~1e-10
    here, below Adam's eps) moves by a fraction of lr that the noise sets
    (measured: no non-noise entry beyond 1e-6 (|w| + lr));
  - every model parameter bf16 and equal to ``master.to(bf16)``.
- Weight files with bf16 leaves: the port writes the bytes the JAX
  package's ``save_params`` writes for the same weights (``|V2``), and the
  port loads the JAX package's file bitwise. A checkpoint round trip
  restores the master, the bf16 moments, the count and the weights bit for
  bit.
- The CLI: ``single-scene-optim`` on ``synth/optim_synth_gasfm.conf`` with
  the three keys bf16 writes the tree of the float32 run (which
  ``tests/test_torch_port_cli.py`` holds to the JAX CLI's; the JAX CLI's
  schema check refuses ``train.param_dtype``, so it has no bf16 run) and a
  weight file of bf16 leaves that loads back.
- ``Parameter3DPts``: shape, key, sigma, and its flax key both ways.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gasfm_tpu.config import ConfigFactory as JaxConfigFactory
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.losses import get_loss_func as jax_get_loss_func
from gasfm_tpu.models.convert import convert_reference_state_dict
from gasfm_tpu.train.state import MasterWeightState, apply_param_updates
from gasfm_tpu.train.state import build_optimizer as jax_build_optimizer
from gasfm_tpu.train.state import cast_params_for_training as jax_cast

from gasfm_tpu_torch.config import ConfigFactory
from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.models import get_model
from gasfm_tpu_torch.models.convert import params_from_jax, params_to_jax
from gasfm_tpu_torch.models.layers import Parameter3DPts, TorchDense
from gasfm_tpu_torch.train.loop import TrainingSession
from gasfm_tpu_torch.train.state import (Optimizer, load_params, restore_checkpoint,
                                         save_checkpoint, save_params)

BF16_EPS = 2.0 ** -8
BF16_KEYS = ["train.param_dtype=bf16", "train.adam_mu_dtype=bf16", "train.adam_nu_dtype=bf16"]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One PyTorch intra-op thread for this module's small models (see
    tests/test_torch_port_multi_scene.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# Adam: each branch against build_optimizer
# ---------------------------------------------------------------------------

SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
SCHEDULE = dict(lr=0.01, main_scheduler="exponential", lr_warmup_n_steps=4, exp_n_steps=20,
                exp_gamma_after_n_steps=0.1)
CLIP_TH = 3.0  # the gradients' global norms run from ~1.6 to ~7.7: some updates clip
BRANCHES = {
    "mu": dict(mu_dtype="bf16"),
    "nu": dict(nu_dtype="bf16"),
    "mu_nu": dict(mu_dtype="bf16", nu_dtype="bf16"),
    "master": dict(param_dtype="bf16"),
    "master_mu_nu": dict(param_dtype="bf16", mu_dtype="bf16", nu_dtype="bf16"),
}
KEYS = {"mu_dtype": "adam_mu_dtype", "nu_dtype": "adam_nu_dtype", "param_dtype": "param_dtype"}


def adam_runs(branch: str, jit: bool, steps: int = 10):
    """{name: (JAX, port)} after ``steps`` updates from the same numpy
    parameters and gradients: "p" (the master under bf16 weights, else the
    parameters), "model" (the model's parameters), "mu", "nu" (float32
    views), "count", and "p0" (the start)."""
    kw = BRANCHES[branch]
    extra = "".join(f', {KEYS[k]} = "{v}"' for k, v in kw.items())
    conf = JaxConfigFactory.parse_string(
        'train { lr = 0.01, lr_schedule { lr_warmup_n_steps = 4, main_scheduler = "exponential",'
        ' exp_n_steps = 20, exp_gamma_after_n_steps = 0.1 } %s }\n'
        'loss { grad_clip_mode = "norm", grad_clip_th = %s }' % (extra, CLIP_TH))
    master = kw.get("param_dtype") == "bf16"
    rng = np.random.default_rng(1)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * (0.3 + 0.2 * i)).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(steps)]
    gdt = jnp.bfloat16 if master else jnp.float32

    tx, _ = jax_build_optimizer(conf)
    jp = jax_cast(conf, {k: jnp.asarray(v) for k, v in p0.items()})
    st = tx.init(jp)
    update = jax.jit(tx.update) if jit else tx.update
    for g in grads:
        u, st = update({k: jnp.asarray(v).astype(gdt) for k, v in g.items()}, st, jp)
        jp = apply_param_updates(jp, u, st)
    inner = st.inner if isinstance(st, MasterWeightState) else st
    adam = next(x for x in jax.tree_util.tree_leaves(
        inner, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))

    params = [torch.nn.Parameter(torch.tensor(p0[k])) for k in SHAPES]
    if master:
        for p in params:
            p.data = p.data.bfloat16()
    opt = Optimizer(params, **SCHEDULE, grad_clip_mode="norm", grad_clip_th=CLIP_TH, **kw)
    for g in grads:
        opt.step([torch.tensor(g[k]).to(params[0].dtype) for k in SHAPES])
    buf = opt.buffers
    out = {"count": (int(adam.count), int(buf.count)), "p0": p0}
    for name, want, got in (("p", st.master if master else jp, buf.params), ("mu", adam.mu, buf.mu),
                            ("nu", adam.nu, buf.nu), ("model", jp, params)):
        out[name] = ({k: f32(want[k]) for k in SHAPES},
                     {k: t.detach().float().numpy() for k, t in zip(SHAPES, got)})
    out["bits"] = {name: ({k: np.asarray(want[k]).view(np.int16) for k in SHAPES},
                          {k: t.detach().view(torch.int16).numpy() for k, t in zip(SHAPES, got)})
                   for name, want, got, dt in (("mu", adam.mu, buf.mu, buf.mu[0].dtype),
                                               ("nu", adam.nu, buf.nu, buf.nu[0].dtype),
                                               ("model", jp, params, params[0].dtype))
                   if dt == torch.bfloat16}
    return out


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_adam_branch_matches_jax_op_by_op(branch):
    run = adam_runs(branch, jit=False)
    assert run["count"] == (10, 10)
    for name, (want, got) in run["bits"].items():
        for k in SHAPES:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}[{k}] bits")
    bf16 = set(run["bits"])
    for name in ("mu", "nu"):
        if name not in bf16:
            want, got = run[name]
            for k in SHAPES:
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-6 * np.abs(want[k]).max(),
                                           err_msg=f"{name}[{k}]")
    want, got = run["p"]
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-7, atol=0, err_msg=f"p[{k}]")


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_adam_branch_matches_jitted_jax(branch):
    run = adam_runs(branch, jit=True)
    assert run["count"] == (10, 10)
    optax_bf16_mu = branch == "mu"
    tol = 2e-2 if optax_bf16_mu else 1e-5
    for name in ("mu", "nu"):
        want, got = run[name]
        t = tol if (name == "mu" and optax_bf16_mu) else 1e-5
        for k in SHAPES:
            assert rel_norm(got[k], want[k]) <= t, (name, k, rel_norm(got[k], want[k]))
    want, got = run["p"]
    for k in SHAPES:
        p0 = run["p0"][k].astype(np.float64)
        start = p0 if "master" not in branch else f32(jnp.asarray(p0).astype(jnp.bfloat16))
        err = rel_norm(got[k] - start, want[k] - start)
        assert err <= tol, (k, err)


def test_master_wrapper_weights_are_the_bf16_master():
    """Both packages: the model's bf16 weights are their own master's
    rounding, and the two packages' agree within one bf16 rounding."""
    run = adam_runs("master_mu_nu", jit=True)
    (jm, pm), (jw, pw) = run["p"], run["model"]
    for k in SHAPES:
        np.testing.assert_array_equal(pw[k], f32(jnp.asarray(pm[k]).astype(jnp.bfloat16)))
        np.testing.assert_array_equal(jw[k], f32(jnp.asarray(jm[k]).astype(jnp.bfloat16)))
        np.testing.assert_allclose(pw[k], jw[k], rtol=BF16_EPS, atol=0)


# ---------------------------------------------------------------------------
# The bf16 TorchDense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
def test_bf16_torch_dense_matches_jax(bias):
    from gasfm_tpu.models.layers import TorchDense as JaxTorchDense

    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 48)).astype(np.float32)
    ct = rng.standard_normal((300, 40)).astype(np.float32)
    jmod = JaxTorchDense(40, use_bias=bias)
    params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16),
                                    jmod.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    want, vjp = jax.vjp(lambda p, xx: jmod.apply(p, xx), params, jnp.asarray(x))
    d_params, d_x = vjp(jnp.asarray(ct))

    mod = TorchDense(48, 40, bias=bias).to(torch.bfloat16)
    mod.load_state_dict(params_from_jax(params["params"]))
    assert mod.weight.dtype == torch.bfloat16
    xt = torch.tensor(x, requires_grad=True)
    got = mod(xt)
    got.backward(torch.tensor(ct))
    assert got.dtype == torch.float32 and xt.grad.dtype == torch.float32
    assert rel_norm(got.detach().numpy(), f32(want)) <= 1e-5
    pairs = [(xt.grad, d_x), (mod.weight.grad.t(), d_params["params"]["kernel"])]
    if bias:
        pairs.append((mod.bias.grad, d_params["params"]["bias"]))
    for g, w in pairs:
        g32, w32 = g.float().numpy(), f32(w)
        if g is not xt.grad:
            assert g.dtype == torch.bfloat16
        assert np.array_equal(g32, f32(jnp.asarray(g32).astype(jnp.bfloat16)))  # bf16 values
        np.testing.assert_allclose(g32, w32, rtol=2 * BF16_EPS, atol=0)  # one bf16 ulp
        assert (g32 != w32).mean() <= 0.01


# ---------------------------------------------------------------------------
# Sessions: 2-layer GASFM and DPESFM under bf16 weights and moments
# ---------------------------------------------------------------------------

DPESFM_CONF = """
model {
  type = "SetOfSet.SetOfSetNet"
  num_blocks = 1
  block_size = 2
  num_features = 16
  proj_feat_normalization = true
  add_skipconn_for_residual_blocks = true
  pos_emb_n_freq = 0
  view_head { enabled = true, n_hidden_layers = 2, rot_representation = "quat" }
  scenepoint_head { enabled = true, n_hidden_layers = 2 }
  depth_head { enabled = false }
}
dataset { calibrated = true }
loss {
  func = "ESFMLoss"
  infinity_pts_margin = 0.0001
  pts_grad_equalization_pre_perspective_divide = true
  normalize_grad_wrt_valid_projections_only = false
  hinge_loss = true
  hinge_loss_weight = 1
}
train { lr = 0.001, lr_schedule { lr_warmup_n_steps = 2, main_scheduler = "constant" } }
"""
NOISE = 1e-6


def model_conf(name: str):
    if name == "gasfm":
        from __graft_entry__ import _flagship_conf

        conf = _flagship_conf(small=True)
        conf.put("train.lr", 0.001)
    else:
        conf = JaxConfigFactory.parse_string(DPESFM_CONF)
    for kv in BF16_KEYS:
        key, value = kv.split("=")
        conf.put(key, value)
    return conf


@pytest.fixture(scope="module", params=["gasfm", "dpesfm"])
def session_runs(request):
    """Three steps in each package from the same init: JAX's losses, step-1
    gradients and master; the port's, and its session."""
    from gasfm_tpu.models import get_model as jax_get_model

    jconf = model_conf(request.param)
    data = jax_synthetic_scene(n_views=8, n_points=64, seed=0)
    jscene = jax_build_scene_graph(data.M, data.Ns, data.y)
    jmodel = jax_get_model(jconf)
    loss_func = jax_get_loss_func(jconf)
    # the port's init carried into the JAX tree (a JAX init costs ~25 s of tracing here)
    pconf = ConfigFactory.from_dict(jconf.to_dict())
    model = get_model(pconf, generator=torch.Generator().manual_seed(0))
    params32 = jax.tree_util.tree_map(jnp.asarray, convert_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jconf.get_string("model.type")))
    params = jax_cast(jconf, params32)
    tx, _ = jax_build_optimizer(jconf)
    st = tx.init(params)

    @jax.jit
    def step(p, s):
        def loss_fn(q):
            return loss_func(jmodel.apply(q, jscene.graph), jscene)

        loss, g = jax.value_and_grad(loss_fn)(p)
        u, s = tx.update(g, s, p)
        return apply_param_updates(p, u, s), s, loss, g

    want_losses, want_grads, want_master = [], None, None
    for i in range(3):
        params, st, loss, g = step(params, st)
        want_losses.append(float(loss))
        if i == 0:
            want_grads, want_master = g, st.master

    session = TrainingSession.from_conf(pconf, model, device="cpu")
    scene = build_scene_graph(data.M, data.Ns, data.y, device="cpu")
    loss, _, grads = session.loss_and_grads(scene)
    session.update(grads)
    got_losses = [float(loss)]
    got_master = [t.clone() for t in session.optimizer.buffers.params]
    for _ in range(2):
        got_losses.append(float(session.fused_step(scene)[0]))
    return dict(model_type=jconf.get_string("model.type"), session=session,
                want=(want_losses, want_grads, want_master),
                got=(got_losses, grads, got_master))


def port_tree(session, tensors, model_type):
    names = [k for k, p in session.model.named_parameters() if p.requires_grad]
    return convert_reference_state_dict(
        {k: t.detach().float().numpy() for k, t in zip(names, tensors)}, model_type)


def paired_leaves(run, which: int):
    want = jax.tree_util.tree_leaves_with_path(run["want"][which])
    got = jax.tree_util.tree_leaves_with_path(
        port_tree(run["session"], run["got"][which], run["model_type"]))
    assert [jax.tree_util.keystr(k) for k, _ in want] == \
        [jax.tree_util.keystr(k) for k, _ in got]
    return [(jax.tree_util.keystr(k), np.asarray(g), f32(w))
            for (k, w), (_, g) in zip(want, got)]


def test_session_losses_match_jax(session_runs):
    want, got = session_runs["want"][0], session_runs["got"][0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_session_step1_bf16_grads_match_jax(session_runs):
    grads = session_runs["got"][1]
    assert all(g.dtype == torch.bfloat16 for g in grads)
    pairs = paired_leaves(session_runs, 1)
    largest = max(np.abs(w).max() for _, _, w in pairs)
    top = max(np.linalg.norm(w) for _, _, w in pairs)
    for path, g, w in pairs:
        err = np.linalg.norm(g.astype(np.float64) - w)
        if np.abs(w).max() < NOISE * largest:
            assert err <= 4 * BF16_EPS * top, path
        else:
            assert err <= 4 * BF16_EPS * np.linalg.norm(w), (path, err / np.linalg.norm(w))


def test_session_step1_master_matches_jax(session_runs):
    lr = session_runs["session"].lr_at(0)
    grads = {path: w for path, _, w in paired_leaves(session_runs, 1)}
    largest = max(np.abs(w).max() for w in grads.values())
    moved = n = 0
    for path, g, w in paired_leaves(session_runs, 2):
        diff = np.abs(g.astype(np.float64) - w)
        assert diff.max() <= 2 * lr * (1 + 1e-5), path
        signal = np.abs(grads[path]) >= NOISE * largest
        moved += int((diff[signal] > 1e-6 * (np.abs(w[signal]) + lr)).sum())
        n += int(signal.sum())
    assert moved <= 0.01 * n, (moved, n)


def test_session_weights_are_the_bf16_master(session_runs):
    session = session_runs["session"]
    buf = session.optimizer.buffers
    assert buf.master and int(buf.count) == 3
    assert buf.mu[0].dtype == buf.nu[0].dtype == torch.bfloat16
    for p, m in zip(session.params, buf.params):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p, m.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Weight files and checkpoints
# ---------------------------------------------------------------------------

def test_bf16_weight_files_load_across_packages(session_runs, tmp_path):
    from gasfm_tpu.train.state import load_params as jax_load_params
    from gasfm_tpu.train.state import save_params as jax_save_params

    session = session_runs["session"]
    ours = str(tmp_path / "port.npz")
    save_params(ours, session.model)
    # the JAX package writes the same bytes for the same weights
    flat = {k: np.asarray(v) for k, v in params_to_jax(session.model.state_dict()).items()}
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = jnp.asarray(v.view(np.int16)).view(jnp.bfloat16)
    theirs = str(tmp_path / "jax.npz")
    jax_save_params(theirs, {"params": tree})
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.dtype("V2"), k
            assert a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), k
    # the JAX package's load_params takes the port's file into its template
    loaded = jax_load_params(ours, {"params": tree})
    for (path, got), (_, want) in zip(jax.tree_util.tree_leaves_with_path(loaded),
                                      jax.tree_util.tree_leaves_with_path({"params": tree})):
        assert got.view(np.int16).tobytes() == np.asarray(want).view(np.int16).tobytes(), path
    # the port loads the JAX package's file bitwise into a bf16 model
    model = get_model(ConfigFactory.from_dict(model_conf("gasfm" if "Graph" in session_runs[
        "model_type"] else "dpesfm").to_dict())).to(torch.bfloat16)
    load_params(theirs, model)
    for k, v in session.model.state_dict().items():
        assert model.state_dict()[k].dtype == torch.bfloat16
        assert torch.equal(model.state_dict()[k], v), k


def test_bf16_checkpoint_round_trip_is_bitwise(session_runs, tmp_path):
    session = session_runs["session"]
    buf = session.optimizer.buffers
    snap = lambda: ([t.clone() for t in buf.params], [t.clone() for t in buf.mu],
                    [t.clone() for t in buf.nu], buf.count.clone(),
                    [p.detach().clone() for p in session.params])
    save_checkpoint(str(tmp_path), session, 7)
    before = snap()
    scene = build_scene_graph(*_scene_arrays(), device="cpu")
    session.fused_step(scene)
    assert not torch.equal(buf.count, before[3])
    assert restore_checkpoint(str(tmp_path), session) == 7
    for a, b in zip(before, snap()):
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert buf.mu[0].dtype == torch.bfloat16 and buf.params[0].dtype == torch.float32


def _scene_arrays():
    data = jax_synthetic_scene(n_views=8, n_points=64, seed=0)
    return data.M, data.Ns, data.y


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_bf16_writes_the_jax_tree_and_bf16_weights(tmp_path):
    from test_torch_port_cli import port_cli, tree

    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.main import init_model

    conf = "synth/optim_synth_gasfm.conf"
    ext = ["train.n_epochs=3", "eval.eval_interval=2", "ba.print_out=false"]
    ours = port_cli(tmp_path / "bf16", conf, "e", ext + BF16_KEYS)
    f32_run = port_cli(tmp_path / "f32", conf, "e", ext)
    files = tree(ours)
    assert files == tree(f32_run)
    for f in ("final_train_errors_OPTIMIZATION.csv", "final_train_errors_OPTIMIZATION.xlsx",
              "code/exp.conf.json", "code/<package>",
              "tb/events.out.tfevents.<time>.<host>.<pid>.<n>",
              "OPTIMIZATION/synth0/models/final_model.npz",
              "OPTIMIZATION/synth0/predictions/final_predictions.npz",
              "OPTIMIZATION/synth0/plots/final_plots.html"):
        assert f in files, (f, sorted(files))
    weights = ours / "OPTIMIZATION" / "synth0" / "models" / "final_model.npz"
    with np.load(weights) as data:
        assert data.files and all(data[k].dtype == np.dtype("V2") for k in data.files)
    model, _ = init_model(load_config(conf, external_params=BF16_KEYS))
    model.to(torch.bfloat16)
    load_params(str(weights), model)
    assert all(torch.isfinite(p.float()).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# Parameter3DPts
# ---------------------------------------------------------------------------

def test_parameter_3d_pts_matches_jax():
    from gasfm_tpu.models.layers import Parameter3DPts as JaxParameter3DPts

    jm = JaxParameter3DPts(n_pts=11)
    jparams = jm.init(jax.random.PRNGKey(0))
    assert list(jparams["params"]) == ["pts_3d"]
    m = Parameter3DPts(11, generator=torch.Generator().manual_seed(0))
    assert m().shape == (3, 11) and list(m.state_dict()) == ["pts_3d"]
    assert 0 < float(m().abs().max()) < 1.0
    big = Parameter3DPts(20000, generator=torch.Generator().manual_seed(1))()
    assert abs(float(big.std()) - 0.1) < 0.002 and abs(float(big.mean())) < 0.002
    # the flax key, both ways
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    m.load_state_dict(carried, strict=True)
    np.testing.assert_array_equal(m().detach().numpy(), np.asarray(jm.apply(jparams)))
    back = params_to_jax(m.state_dict())
    assert list(back) == ["pts_3d"]
    np.testing.assert_array_equal(back["pts_3d"], np.asarray(jparams["params"]["pts_3d"]))
