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


def _attend_case(seed=5, E=60, S=12, H=2, C=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S - 3, size=E).astype(np.int32)  # the last 3 segments stay empty
    xl = rng.standard_normal((E, H * C)).astype(np.float32)
    xr = rng.standard_normal((S, H * C)).astype(np.float32)
    att = rng.standard_normal((H * C,)).astype(np.float32)
    g = rng.standard_normal((S, H * C)).astype(np.float32)
    mask = rng.random(E) < 0.8
    return ids, xl, xr, att, g, mask


class _ShiftSpy:
    """Wraps the port's softmax_shift to record whether its output could
    carry gradient."""

    def __init__(self, monkeypatch):
        from gasfm_tpu_torch.ops import gatv2

        self.requires_grad = []
        inner = gatv2.softmax_shift

        def spy(*args, **kwargs):
            m = inner(*args, **kwargs)
            self.requires_grad.append(m.requires_grad)
            return m

        monkeypatch.setattr(gatv2, "softmax_shift", spy)


def test_gatv2_attend_grads_match_jax_composite_and_shift_has_no_grad(monkeypatch):
    """The plain segment attention's gradients (through the detached max
    shift) against jax.vjp of the JAX package's composite gatv2_attend."""
    import jax

    from gasfm_tpu.ops.gatv2 import gatv2_attend as jax_attend

    from gasfm_tpu_torch.ops.gatv2 import gatv2_attend

    spy = _ShiftSpy(monkeypatch)
    ids, xl, xr, att, g, _ = _attend_case()
    S, H = xr.shape[0], 2
    C = xl.shape[1] // H
    _, vjp = jax.vjp(lambda a, b, c: jax_attend(a.reshape(-1, H, C), b.reshape(-1, H, C),
                                                c.reshape(H, C), jnp.asarray(ids), S),
                     jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(att))
    want = vjp(jnp.asarray(g).reshape(S, H, C))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xl, xr, att)]
    out = gatv2_attend(*leaves, torch.from_numpy(ids), S, H)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip(("xl", "xr", "att"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)
    assert spy.requires_grad == [False]  # the shift is outside the autograd graph


def test_gatv2_attend_pool_grads_match_jax_and_shift_has_no_grad(monkeypatch):
    """The single-segment pool's gradients against the JAX package's."""
    import jax

    from gasfm_tpu.ops.gatv2 import gatv2_attend_pool as jax_pool

    from gasfm_tpu_torch.ops.gatv2 import gatv2_attend_pool

    spy = _ShiftSpy(monkeypatch)
    _, xl, xr, att, g, mask = _attend_case(seed=6)
    H = 2
    C = xl.shape[1] // H
    _, vjp = jax.vjp(lambda a, b, c: jax_pool(a.reshape(-1, H, C), b.reshape(1, H, C),
                                              c.reshape(H, C), jnp.asarray(mask)),
                     jnp.asarray(xl), jnp.asarray(xr[:1]), jnp.asarray(att))
    want = vjp(jnp.asarray(g[:1]).reshape(1, H, C))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xl, xr[:1].copy(), att)]
    out = gatv2_attend_pool(*leaves, torch.from_numpy(mask), H)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g[:1]))
    for name, a, b in zip(("xl", "xr0", "att"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)
    assert spy.requires_grad == [False]
