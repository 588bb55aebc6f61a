"""The port's data layer for multi-scene learning against the JAX package's,
on the CPU, from the same numpy seeds.

Bitwise (``np.testing.assert_array_equal``): view sampling
(``sample_indices``, ``sample_data``, ``get_subset`` and its
``subset_size <= n_cams`` assert), the rotational-homography augmentation
(with GT depths), outlier injection (the arrays; the ``None`` return after 5
tries; the ``>=`` feasibility edge, where the target equals the free
inliers), and an epoch of ``SceneLoader`` with shuffling, sampling and the
augmentation: the port's loader with ``num_workers`` 0 and 2 yields the JAX
loader's ``M``, ``Ns`` and ``y``. The prefetch pump: a consumer that breaks
early leaves no live thread, and a producer's error re-raises in the
consumer. The host half of the graph (``build_host_scene_graph`` +
``upload``): the same graph as the JAX package's layout gives the port
(edges, CSR offsets, camera permutation), its precomputed splits those the
kernels would build from the device offsets.
"""

import threading

import numpy as np
import pytest

from gasfm_tpu.data.augmentation import apply_rotational_homography_aug as jax_aug
from gasfm_tpu.data.dataset import SceneLoader as JaxSceneLoader
from gasfm_tpu.data.dataset import ScenesDataSet as JaxScenesDataSet
from gasfm_tpu.data.outliers import OutlierInjector as JaxOutlierInjector
from gasfm_tpu.data.outliers import inject_outliers as jax_inject_outliers
from gasfm_tpu.data.sampling import get_subset as jax_get_subset
from gasfm_tpu.data.sampling import sample_data as jax_sample_data
from gasfm_tpu.data.sampling import sample_indices as jax_sample_indices
from gasfm_tpu.data.scene import SceneData as JaxSceneData
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene

from gasfm_tpu_torch.data.augmentation import apply_rotational_homography_aug
from gasfm_tpu_torch.data.dataset import SceneLoader, ScenesDataSet, prefetch_iter
from gasfm_tpu_torch.data.outliers import OutlierInjector, inject_outliers
from gasfm_tpu_torch.data.sampling import get_subset, sample_data, sample_indices
from gasfm_tpu_torch.data.scene import SceneData


def jax_scene(seed=0, depths=False, n_views=14, n_points=120):
    data = jax_synthetic_scene(n_views=n_views, n_points=n_points, visibility=0.7, seed=seed,
                               calibrated=True)
    if depths:
        data = JaxSceneData(data.M, data.Ns, data.y, data.scene_name, calibrated=True,
                            store_depth_targets=True)
    return data


def port_of(j):
    return SceneData(j.M, j.Ns, j.y, j.scene_name, calibrated=j.calibrated,
                     store_depth_targets=j.store_depth_targets, depths=j.depths)


def assert_same_scene(got, want):
    for key in ("M", "Ns", "y", "valid_pts", "norm_M"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert got.scene_name == want.scene_name
    if want.depths is None:
        assert got.depths is None
    else:
        np.testing.assert_array_equal(got.depths, want.depths)


# -- sampling ---------------------------------------------------------------------------------


@pytest.mark.parametrize("N,k,adjacent", [(20, 1, False), (20, 0.3, True), (20, 0.3, False),
                                          (20, 7, True), (20, 7, False), (20, 25, False),
                                          (5, 1.5, True)])
def test_sample_indices_match_jax(N, k, adjacent):
    for seed in range(5):
        np.testing.assert_array_equal(
            sample_indices(N, k, adjacent, rng=np.random.default_rng(seed)),
            jax_sample_indices(N, k, adjacent, rng=np.random.default_rng(seed)))


@pytest.mark.parametrize("consecutive", [True, False])
def test_sample_data_matches_jax(consecutive):
    j = jax_scene(1, depths=True)
    p = port_of(j)
    for seed, k in ((0, 5), (1, 8), (2, 14)):
        want = jax_sample_data(j, k, consecutive, rng=np.random.default_rng(seed))
        got = sample_data(p, k, consecutive, rng=np.random.default_rng(seed))
        assert_same_scene(got, want)


def test_get_subset_matches_jax():
    j = jax_scene(2)
    p = port_of(j)
    for k in (1, 2, 5, 14):
        assert_same_scene(get_subset(p, k), jax_get_subset(j, k))


def test_get_subset_asserts_the_subset_fits():
    p = port_of(jax_scene(2))
    with pytest.raises(AssertionError, match="exceeds"):
        get_subset(p, p.num_views + 1)


# -- augmentation -----------------------------------------------------------------------------


@pytest.mark.parametrize("inplane,tilt", [(15.0, 20.0), (15.0, None), (None, 20.0), (None, None),
                                         (0.0, 30.0)])
def test_rotational_homography_aug_matches_jax(inplane, tilt):
    j = jax_scene(3, depths=True)
    p = port_of(j)
    for seed in range(3):
        want = jax_aug(j, inplane, tilt, rng=np.random.default_rng(seed))
        got = apply_rotational_homography_aug(p, inplane, tilt, rng=np.random.default_rng(seed))
        assert_same_scene(got, want)
        if inplane is None and tilt is None:
            assert got is p


# -- outliers ---------------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.3])
def test_inject_outliers_matches_jax(rate):
    j = jax_scene(4, n_views=12, n_points=200)
    p = port_of(j)
    for seed in range(3):
        want = jax_inject_outliers(j, rate, rng=np.random.default_rng(seed))
        got = inject_outliers(p, rate, rng=np.random.default_rng(seed))
        assert want is not None and got is not None
        assert_same_scene(got, want)
        changed = (got.M != p.M).reshape(p.num_views, 2, -1).any(axis=1)
        assert changed.sum() == round(rate * p.valid_pts.sum())  # the target rate, exactly


def test_inject_outliers_returns_none_after_five_tries(capsys):
    """A rate no partition reaches (most observations fixed as inliers):
    both packages retry 5 times and return None."""
    j = jax_scene(5, n_views=6, n_points=60)
    p = port_of(j)
    assert jax_inject_outliers(j, 0.9, rng=np.random.default_rng(0)) is None
    assert inject_outliers(p, 0.9, rng=np.random.default_rng(0)) is None
    assert capsys.readouterr().out.count("Retry outlier sampling") == 10


def _injectors(j, p, rate):
    def parts(d):
        rows, cols = np.nonzero(d.valid_pts)
        xs = d.M.reshape(d.num_views, 2, -1).transpose(0, 2, 1)
        return rows, cols, xs[rows, cols].astype(np.float64), d.num_views, d.num_points

    return (OutlierInjector(*parts(p), rate, rng=np.random.default_rng(0)),
            JaxOutlierInjector(*parts(j), rate, rng=np.random.default_rng(0)))


def test_outlier_feasibility_edge_takes_the_retry_path():
    """The target exactly equal to the free inliers (``needed ==
    n_free_inliers``): the ``>=`` check retries (a ``>`` would reach the
    margin's assert with a rate of 1) and, as the partition is the same at
    every try, returns None in both packages."""
    j = jax_scene(6, n_views=12, n_points=200)
    p = port_of(j)
    probe, _ = _injectors(j, p, 0.5)
    rate = probe.n_free_inliers / probe.nnz
    port, jax_inj = _injectors(j, p, rate)
    assert port.target_n_outliers == port.n_free_inliers
    assert port.select_outliers() is None
    assert jax_inj.select_outliers() is None


# -- the loader -------------------------------------------------------------------------------


def _datasets(n_scenes=5):
    scenes = [jax_scene(10 + i, n_views=12 + i) for i in range(n_scenes)]
    kw = dict(return_all=False, min_num_views_sampled=4, max_num_views_sampled=9,
              inplane_rot_aug_max_angle=15.0, tilt_rot_aug_max_angle=20.0)
    return (ScenesDataSet([port_of(s) for s in scenes], **kw),
            JaxScenesDataSet(scenes, **kw))


def _epochs(loader, n=2):
    out = []
    for _ in range(n):
        out.append([[(s.scene_name, s.M, s.Ns, s.y) for s in batch] for batch in loader])
    return out


@pytest.fixture(scope="module")
def jax_epochs():
    _, jds = _datasets()
    loader = JaxSceneLoader(jds, batch_size=2, shuffle=True, rng=np.random.default_rng(7))
    return _epochs(loader)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_scene_loader_epochs_match_jax_for_every_num_workers(jax_epochs, num_workers):
    pds, _ = _datasets()
    loader = SceneLoader(pds, batch_size=2, shuffle=True, rng=np.random.default_rng(7),
                         num_workers=num_workers)
    try:
        got = _epochs(loader)
    finally:
        loader.close()
    assert [len(e) for e in got] == [3, 3]  # 5 scenes in batches of 2
    for epoch_got, epoch_want in zip(got, jax_epochs):
        assert [[s[0] for s in b] for b in epoch_got] == [[s[0] for s in b] for b in epoch_want]
        for batch_got, batch_want in zip(epoch_got, epoch_want):
            for sg, sw in zip(batch_got, batch_want):
                for a, b in zip(sg[1:], sw[1:]):
                    np.testing.assert_array_equal(a, b)
    # the two epochs draw different orders or samples
    assert any(not np.array_equal(a[0][1], b[0][1]) for a, b in zip(got[0], got[1]))


def test_scene_loader_return_all_hands_back_the_same_objects():
    scenes = [port_of(jax_scene(20 + i)) for i in range(3)]
    loader = SceneLoader(ScenesDataSet(scenes, return_all=True), batch_size=2, prefetch=0)
    assert len(loader) == 2
    assert [s for b in loader for s in b] == scenes
    assert all(a is b for a, b in zip((s for b in loader for s in b), scenes))


# -- the prefetch pump ------------------------------------------------------------------------


def _live_pumps():
    return [t for t in threading.enumerate() if t.daemon and t.is_alive()
            and getattr(t, "_target", None) is not None
            and t._target.__qualname__.startswith("prefetch_iter")]


def test_prefetch_iter_early_break_leaves_no_live_thread():
    before = len(_live_pumps())
    taken = []
    for item in prefetch_iter(lambda: iter(range(1000)), depth=2):
        taken.append(item)
        if item == 3:
            break
    assert taken == [0, 1, 2, 3]
    assert len(_live_pumps()) == before


def test_prefetch_iter_reraises_the_producers_error():
    def source():
        yield 1
        raise ValueError("producer failed")

    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for item in prefetch_iter(source, depth=2):
            got.append(item)
    assert got == [1]
    assert not _live_pumps()


# -- the host half of the graph ---------------------------------------------------------------


def test_host_graph_upload_keeps_the_layout_and_the_kernels_splits():
    import torch

    from gasfm_tpu_torch.graph.view_graph import host_split_keys, split_segments

    j = jax_scene(30, depths=True, n_views=30, n_points=900)
    data = port_of(j)
    host = data.host_graph()
    assert data.host_graph() is host  # built once, kept with the scene
    scene = data.to_scene_graph(device="cpu")
    g = scene.graph
    rows, cols = np.nonzero(data.valid_pts)
    order = np.lexsort((rows, cols))
    np.testing.assert_array_equal(g.pt_idx.numpy(), cols[order])
    np.testing.assert_array_equal(g.cam_idx.numpy(), rows[order])
    np.testing.assert_array_equal(g.cam_perm.numpy(),
                                  np.argsort(rows[order], kind="stable"))
    np.testing.assert_array_equal(scene.gt_depths.numpy(), data.depths[rows[order], cols[order]])
    assert g.uv.dtype == torch.float32 and g.pt_ptr.dtype == torch.int32
    for side, ptr, chunks in (("pt", g.pt_ptr, g.pt_chunks), ("cam", g.cam_ptr, g.cam_chunks)):
        keys = host_split_keys()[side]
        assert len(keys) >= 2
        for rows_, above in keys + [(8, 8)]:  # (8, 8): built on demand from the host offsets
            got = chunks(rows_, above)
            want = split_segments(ptr.numpy(), rows_, "cpu", above)
            assert torch.equal(got.table, want.table), (side, rows_, above)
            assert got.n_long == want.n_long and got.n_chunks == want.n_chunks
