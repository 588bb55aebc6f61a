"""The port's GASFM forward and ESFM loss against the JAX package.

- Weight carrying: ``params_from_jax`` maps a flax init of the JAX
  ``GraphAttnSfMNet`` onto the port with every key used (strict load), and
  the JAX package's reference-checkpoint converter maps the port's
  ``state_dict`` back onto the same flax tree, leaf for leaf.
- The slice as a whole: the configuration of tests/test_packed.py's merged
  model test (4 layers, 4 heads, n_feat_proj 32, narrow node widths, an
  8-view 600-point scene), so the JAX side runs its packed and merged Pallas
  kernels in interpret mode, and its loss goes through ``fused_esfm_terms``;
  and a second configuration for the remaining paths of those kernels
  (stateless, no init skip, global broadcasts, 6d heads). The port runs its
  kernels' plain versions (CPU tensors).
- The view head's decode for every rotation representation and projective
  normalization.

Tolerance for the forward and the loss: rtol 1e-3, atol 1e-4 x the output's
scale. Both sides are float32 but sum in different orders through four
layers of LayerNorms (the edge stream's flax-form variance E[x^2] - mean^2
amplifies rounding on edges whose features nearly coincide; the node-level
ones are flax-form on the JAX side, two-pass on the port's) and 48/40-wide
node MLPs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.config import ConfigFactory
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.losses import ESFMLoss as JaxESFMLoss
from gasfm_tpu.models.convert import convert_reference_state_dict
from gasfm_tpu.models.gasfm import GraphAttnSfMNet as JaxGraphAttnSfMNet
from gasfm_tpu.ops.segment import set_kernel_mode

from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.losses import ESFMLoss
from gasfm_tpu_torch.models.convert import params_from_jax
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.train.loop import TrainingSession

CONFIGS = {
    # tests/test_packed.py's merged-kernel model: the flagship's structure at
    # narrow node widths.
    "flagship_shape": dict(num_layers=4, n_heads=4, n_feat_proj=32, n_feat_scenepoint=24,
                           n_feat_view=40, n_feat_global=48, stateful_global_features=True,
                           add_skipconn_from_init_projfeat=True),
    # The other paths of the same kernels: stateless queries, no init skip
    # (an update without skip2), the global broadcasts, 2 heads, 6d rotations.
    "stateless_broadcast": dict(num_layers=2, n_heads=2, n_feat_proj=32, n_feat_scenepoint=24,
                                n_feat_view=40, n_feat_global=48,
                                stateful_global_features=False,
                                add_skipconn_from_init_projfeat=False,
                                global2view_and_global2scenepoint_enabled=True,
                                rot_representation="6d"),
}

LOSS_CONF = """
model { view_head { enabled = true }, scenepoint_head { enabled = true } }
loss {
  infinity_pts_margin = 0.0001
  pts_grad_equalization_pre_perspective_divide = true
  normalize_grad_wrt_valid_projections_only = true
  hinge_loss = true
  hinge_loss_weight = 1
}
"""


def run_jax(widths):
    """One JAX forward + loss with the packed/merged Pallas kernels in
    interpret mode (the environment of tests/test_packed.py)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GASFM_PACKED", "1")
    mp.setenv("GASFM_MERGED", "1")
    set_kernel_mode("interpret")
    try:
        data = jax_synthetic_scene(n_views=8, n_points=600, visibility=0.5, seed=9)
        scene = jax_build_scene_graph(data.M, data.Ns, data.y)
        model = JaxGraphAttnSfMNet(**widths)
        params = model.init(jax.random.PRNGKey(0), scene.graph)
        pred = model.apply(params, scene.graph)
        loss = JaxESFMLoss(ConfigFactory.parse_string(LOSS_CONF))(pred, scene)
        pred = {k: np.asarray(v) for k, v in pred.items()}
        params = jax.tree_util.tree_map(np.asarray, params)
        return widths, data, params, pred, float(loss)
    finally:
        set_kernel_mode("auto")
        mp.undo()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request):
    return run_jax(CONFIGS[request.param])


def port_model(widths, params):
    model = GraphAttnSfMNet(**widths)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def test_params_from_jax_uses_every_key_both_ways(jax_run):
    widths, _, params, _, _ = jax_run
    model = port_model(widths, params)  # strict: no port key missing, no flax leaf unused
    back = convert_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, "graph_attn_sfm.GraphAttnSfMNet")
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(k) for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (path, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=jax.tree_util.keystr(path))


def assert_close(got, want, name):
    want = np.asarray(want)
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3, atol=1e-4 * scale, err_msg=name)


def run_port(jax_result):
    """The port's forward + loss (plain versions, CPU) on the same scene with
    the JAX run's weights."""
    widths, data, params, _, _ = jax_result
    session = TrainingSession(port_model(widths, params), ESFMLoss(1e-4, True, 1.0), device="cpu")
    scene = build_scene_graph(data.M, data.Ns, data.y, device="cpu")
    pred = session.forward(scene)
    return scene, pred, float(session.loss(pred, scene))


@pytest.fixture(scope="module")
def port_run(jax_run):
    return run_port(jax_run)


def forward_pairs(jax_result, port_result):
    """[(name, port, JAX)] on real rows: Ps_norm, pts3D and the loss."""
    _, _, _, want, want_loss = jax_result
    scene, pred, got_loss = port_result
    m, n = scene.graph.num_cams, scene.graph.num_pts
    return [("Ps_norm", pred["Ps_norm"], want["Ps_norm"][:m]),
            ("pts3D", pred["pts3D"], want["pts3D"][:, :n]),
            ("loss", got_loss, want_loss)]


@pytest.mark.parametrize("key", ["Ps_norm", "pts3D"])
def test_forward_matches_jax(jax_run, port_run, key):
    (_, got, want), = [p for p in forward_pairs(jax_run, port_run) if p[0] == key]
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    assert_close(got, want, key)


def test_esfm_loss_matches_jax(jax_run, port_run):
    (_, got, want), = [p for p in forward_pairs(jax_run, port_run) if p[0] == "loss"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("calibrated,rep,norm", [
    (True, "quat", None), (True, "6d", None), (True, "svd", None),
    (False, "quat", None), (False, "quat", "Chirality"),
    (False, "quat", "Differentiable Chirality"), (False, "quat", "Frobenius"),
])
def test_view_head_decode_matches_jax(calibrated, rep, norm):
    from gasfm_tpu.models.heads import decode_view_outputs as jax_decode
    from gasfm_tpu.models.heads import view_head_out_channels

    from gasfm_tpu_torch.models.heads import decode_view_outputs

    x = np.random.default_rng(3).standard_normal(
        (6, view_head_out_channels(calibrated, rep))).astype(np.float32)
    want = np.asarray(jax_decode(jnp.asarray(x), calibrated, rep, norm))
    got = decode_view_outputs(torch.from_numpy(x), calibrated, rep, norm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
