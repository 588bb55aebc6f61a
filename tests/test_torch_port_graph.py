"""The port's view graph and synthetic scenes against the JAX package's.

The JAX package's build_view_graph pads each point window's edge run and
masks the padding; the port keeps the valid edges only, in the same
(point, camera) order. So the JAX graph's masked-in rows, in order, must
equal the port's rows exactly, and the port's CSR offsets and camera permutation must describe
the same edges. The synthetic generator is a copy: same seed, same arrays.
"""

import numpy as np
import pytest

from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_view_graph as jax_build_view_graph

from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.graph.view_graph import build_view_graph

SCENES = [
    dict(n_views=10, n_points=300, visibility=0.5, seed=0),
    dict(n_views=10, n_points=300, visibility=0.3, seed=3),
    dict(n_views=12, n_points=400, track_length_dist="powerlaw", seed=0),
    dict(n_views=12, n_points=400, track_length_dist="powerlaw", seed=5),
]


@pytest.mark.parametrize("kw", SCENES)
def test_synthetic_copy_matches_jax(kw):
    want = jax_synthetic_scene(**kw)
    got = generate_synthetic_scene(**kw)
    np.testing.assert_array_equal(got.M, want.M)
    np.testing.assert_array_equal(got.Ns, want.Ns)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.valid_pts, want.valid_pts)


@pytest.mark.parametrize("kw", SCENES)
def test_view_graph_matches_jax(kw):
    data = jax_synthetic_scene(**kw)
    jg = jax_build_view_graph(data.M, data.Ns)
    g = build_view_graph(data.M, data.Ns, device="cpu")
    mask = np.asarray(jg.edge_mask)
    m, n = data.y.shape[0], data.M.shape[1]
    assert (g.num_cams, g.num_pts, g.num_edges) == (m, n, int(mask.sum()))
    np.testing.assert_array_equal(g.cam_idx.numpy(), np.asarray(jg.cam_idx)[mask])
    np.testing.assert_array_equal(g.pt_idx.numpy(), np.asarray(jg.pt_idx)[mask])
    np.testing.assert_array_equal(g.uv.numpy(), np.asarray(jg.uv)[mask])
    np.testing.assert_array_equal(g.cam_valid.numpy(), np.asarray(jg.cam_valid)[:m])
    np.testing.assert_array_equal(g.pt_valid.numpy(), np.asarray(jg.pt_valid)[:n])
    # The same set of (camera, point, uv) edges, whatever the order.
    key = lambda c, p, uv: sorted(zip(c.tolist(), p.tolist(), map(tuple, uv.tolist())))  # noqa: E731
    assert key(g.cam_idx.numpy(), g.pt_idx.numpy(), g.uv.numpy()) == key(
        np.asarray(jg.cam_idx)[mask], np.asarray(jg.pt_idx)[mask], np.asarray(jg.uv)[mask])


@pytest.mark.parametrize("kw", SCENES)
def test_csr_offsets_and_camera_permutation_consistent(kw):
    data = generate_synthetic_scene(**kw)
    g = build_view_graph(data.M, data.Ns, device="cpu")
    cam, pt = g.cam_idx.numpy(), g.pt_idx.numpy()
    pt_ptr, cam_ptr, perm = g.pt_ptr.numpy(), g.cam_ptr.numpy(), g.cam_perm.numpy()
    E = g.num_edges
    assert pt_ptr[0] == 0 and pt_ptr[-1] == E and np.all(np.diff(pt_ptr) >= 0)
    assert cam_ptr[0] == 0 and cam_ptr[-1] == E and np.all(np.diff(cam_ptr) >= 0)
    for p in range(g.num_pts):
        seg = slice(pt_ptr[p], pt_ptr[p + 1])
        assert np.all(pt[seg] == p)
        assert np.all(np.diff(cam[seg]) > 0)  # (point, camera) order, no duplicates
    np.testing.assert_array_equal(np.sort(perm), np.arange(E))
    for c in range(g.num_cams):
        edges = perm[cam_ptr[c]:cam_ptr[c + 1]]
        assert np.all(cam[edges] == c)
        assert np.all(np.diff(pt[edges]) > 0)  # stable: point order within a camera
    np.testing.assert_array_equal(np.diff(cam_ptr), np.bincount(cam, minlength=g.num_cams))
