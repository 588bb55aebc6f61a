"""The port's plain segment reductions against the JAX package's
(ops/segment.py, XLA path), including the empty-segment contract: sums are
0, ``segment_max`` gives the caller's ``neutral``, and softmax weights of
every edge are finite. Exact up to float32 summation order: rtol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gasfm_tpu.ops import segment as jseg

from gasfm_tpu_torch.ops import segment as seg

S = 12  # segments 9..11 get no edges


@pytest.fixture(autouse=True)
def _xla_path():
    jseg.set_kernel_mode("off")
    yield
    jseg.set_kernel_mode("auto")


def _draw(shape, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 9, size=shape[0]).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32), ids


@pytest.mark.parametrize("shape", [(50,), (50, 3)])
def test_segment_sum_max_softmax_gather_match_jax(shape):
    data, ids = _draw(shape, seed=len(shape))
    t, ti = torch.from_numpy(data), torch.from_numpy(ids)
    j, ji = jnp.asarray(data), jnp.asarray(ids)

    np.testing.assert_allclose(seg.segment_sum(t, ti, S).numpy(),
                               np.asarray(jseg.segment_sum(j, ji, S)), rtol=1e-6, atol=1e-6)
    for neutral in (float("-inf"), -7.0):
        got = seg.segment_max(t, ti, S, neutral=neutral).numpy()
        np.testing.assert_array_equal(got, np.asarray(jseg.segment_max(j, ji, S, neutral=neutral)))
        assert np.all(got[9:] == neutral)
    w = seg.segment_softmax(t, ti, S).numpy()
    np.testing.assert_allclose(w, np.asarray(jseg.segment_softmax(j, ji, S)), rtol=1e-6, atol=1e-7)
    assert np.all(np.isfinite(w))
    table = np.arange(S * 2, dtype=np.float32).reshape(S, 2)
    np.testing.assert_array_equal(
        seg.gather_segments(torch.from_numpy(table), ti).numpy(),
        np.asarray(jseg.gather_segments(jnp.asarray(table), ji, S)))
