"""The port's ``.mat`` readers (``gasfm_tpu_torch/ba/io.py``) against the JAX
package's (``gasfm_tpu/ba/io.py``), on the ``.mat`` files that
``tests/test_ba_io.py`` writes, plus the predicted-cameras files of the two
``*_our_*`` readers and a MATLAB-sparse ``M``: every reader's output equal,
key by key, dtype and value (they share scipy's ``loadmat``; the port's
``M_to_xs`` is its own copy), and the shapes of ``tests/test_ba_io.py:29``
and ``:40``."""

import numpy as np
import pytest

from gasfm_tpu.ba import io as jax_io

from gasfm_tpu_torch.ba import io as ba_io

sio = pytest.importorskip("scipy.io")
sparse = pytest.importorskip("scipy.sparse")


@pytest.fixture()
def mat_scene(tmp_path):
    m, n = 3, 5
    rng = np.random.default_rng(0)
    data = {
        "Ps": rng.standard_normal((m, 3, 4)),
        "Points3D": rng.standard_normal((3, n)),
        "M": rng.standard_normal((2 * m, n)),
        "R_gt": rng.standard_normal((m, 3, 3)),
        "T_gt": rng.standard_normal((m, 3)),
        "K_gt": rng.standard_normal((m, 3, 3)),
    }
    path = str(tmp_path / "scene")
    sio.savemat(path + ".mat", data)
    (tmp_path / "cameras").mkdir()
    ours = {"pts3D": rng.standard_normal((4, n)), "Rs": rng.standard_normal((m, 3, 3)),
            "ts": rng.standard_normal((m, 3)), "Ks": rng.standard_normal((m, 3, 3)),
            "Ps": rng.standard_normal((m, 3, 4))}
    sio.savemat(str(tmp_path / "cameras" / "Final_Cameras.mat"), ours)
    sio.savemat(str(tmp_path / "cameras" / "Other.mat"), ours)
    sparse_path = str(tmp_path / "sparse")
    sio.savemat(sparse_path + ".mat", dict(data, M=sparse.csc_matrix(data["M"])))
    return path, sparse_path, str(tmp_path), data


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("reader", ["read_mat_files", "read_euc_gt_mat_files",
                                    "read_proj_gt_mat_files"])
def test_scene_readers_match_jax(mat_scene, reader):
    path, _, _, _ = mat_scene
    assert_same(getattr(ba_io, reader)(path), getattr(jax_io, reader)(path))


def test_read_mat_files_shapes(mat_scene):
    path, _, _, data = mat_scene
    out = ba_io.read_mat_files(path)
    assert out["Ps"].shape == (3, 3, 4) and out["Xs"].shape == (5, 3)
    assert out["xs"].shape == (3, 5, 2)
    np.testing.assert_array_equal(out["xs"][1, :, 0], data["M"][2])
    np.testing.assert_array_equal(out["xs"][1, :, 1], data["M"][3])


def test_euc_gt_reader_takes_sparse_m(mat_scene):
    path, sparse_path, _, _ = mat_scene
    out = ba_io.read_euc_gt_mat_files(sparse_path)
    assert {k: v.shape for k, v in out.items()} == {
        "Rs": (3, 3, 3), "ts": (3, 3), "Ks": (3, 3, 3), "xs": (3, 5, 2)}
    assert_same(out, jax_io.read_euc_gt_mat_files(sparse_path))
    assert_same(out, ba_io.read_euc_gt_mat_files(path))


@pytest.mark.parametrize("name", [None, "Other"])
@pytest.mark.parametrize("reader", ["read_euc_our_mat_files", "read_proj_our_mat_files"])
def test_prediction_readers_match_jax(mat_scene, reader, name):
    _, _, root, _ = mat_scene
    kw = {} if name is None else {"name": name}
    out = getattr(ba_io, reader)(root, **kw)
    assert out["Xs"].shape == (5, 3) and out["Xs"].dtype == np.float64
    assert_same(out, getattr(jax_io, reader)(root, **kw))
