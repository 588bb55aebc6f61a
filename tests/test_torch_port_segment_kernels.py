"""The port's segment-sum, row-gather and edge-combine kernels (their plain
PyTorch versions, which is what a CPU tensor runs) against the JAX
package's Pallas kernels in interpret mode, values and ``jax.vjp``
gradients, and ``core_errors_device`` (whose gathers those kernels serve)
against the JAX package's.

The scene is tests/test_kernel_dispatch.py's (9 views, 700 points,
visibility 0.35, seed 3: its points span several point windows, so the
windowed kernels walk more than one), with ten points and one camera
left unobserved, so both sides have empty segments. The JAX graph pads
edges and tables; both packages sort the valid edges by (point, camera), so
the JAX graph's real rows, in order, are the port's rows: inputs are drawn
per real edge with numpy and scattered into both layouts. A spy on the JAX
kernel module checks that each Pallas kernel was reached.

Tolerances: sums over a segment in float32, in another order (one-hot
matmuls against ``index_add_``): |err| <= 1e-5 x the reference's scale +
1e-4 x |ref|. Gathers and the edge combine's d pe move values without
arithmetic (or scale by 1/4): exact. ``our_repro``: rtol 1e-5 (a mean over
the edges in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.eval.metrics import core_errors_device as jax_core_errors
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.ops import edge_update as jax_edge_update
from gasfm_tpu.ops import segment as jseg
from gasfm_tpu.ops.pallas import fused_update as jax_fused_update
from gasfm_tpu.ops.pallas import segment_kernels as jax_segment_kernels

from gasfm_tpu_torch.eval.metrics import core_errors_device
from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.ops import segment as seg
from gasfm_tpu_torch.ops.kernels.fused_update import fused_edge_combine
from gasfm_tpu_torch.ops.kernels.segment_kernels import gather_rows, segment_sum

EMPTY_POINTS = range(100, 110)
EMPTY_CAMERA = 4
JAX_KERNEL = {  # (op, side) -> the Pallas kernel the JAX dispatch reaches
    ("sum", "point"): "windowed_segment_sum",
    ("sum", "camera"): "segment_sum_kernel",
    ("gather", "point"): "windowed_gather",
    ("gather", "camera"): "gather_rows_kernel",
}


@pytest.fixture(autouse=True)
def _interpret_mode():
    jseg.set_kernel_mode("interpret")
    yield
    jseg.set_kernel_mode("auto")


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of the JAX kernel entries (their custom_vjp
    backwards included: they look the names up in the module)."""
    calls = {}
    for mod, names in ((jax_segment_kernels, set(JAX_KERNEL.values())),
                       (jax_fused_update, {"fused_edge_combine"})):
        for name in names:
            def counted(*a, _fn=getattr(mod, name), _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, counted)
    return calls


def scene_data():
    data = jax_synthetic_scene(n_views=9, n_points=700, visibility=0.35, seed=3)
    M = data.M.copy()
    M[:, list(EMPTY_POINTS)] = 0.0
    M[2 * EMPTY_CAMERA:2 * EMPTY_CAMERA + 2] = 0.0
    data.M = M
    return data


@pytest.fixture(scope="module")
def scenes():
    data = scene_data()
    jscene = jax_build_scene_graph(data.M, data.Ns, data.y)
    pscene = build_scene_graph(data.M, data.Ns, data.y, device="cpu")
    jg, pg = jscene.graph, pscene.graph
    mask = np.asarray(jg.edge_mask)
    assert mask.sum() == pg.num_edges
    assert np.array_equal(np.asarray(jg.pt_idx)[mask], pg.pt_idx.numpy())
    assert np.array_equal(np.asarray(jg.cam_idx)[mask], pg.cam_idx.numpy())
    assert jg.pt_segment_windows() is not None  # the windowed kernels apply
    assert int(jg.num_pts) > 128  # several point windows
    assert (pg.pt_ptr[1:] == pg.pt_ptr[:-1])[list(EMPTY_POINTS)].all()
    assert pg.cam_ptr[EMPTY_CAMERA + 1] == pg.cam_ptr[EMPTY_CAMERA]
    return jscene, pscene, mask


class Draw:
    def __init__(self, scenes, seed):
        self.jscene, self.pscene, self.mask = scenes
        self.jg, self.pg = self.jscene.graph, self.pscene.graph
        self.rng = np.random.default_rng(seed)

    def edges(self, d):
        """(port (E, d), JAX (E_pad, d) with zero padding rows)."""
        real = self.rng.standard_normal((self.pg.num_edges, d)).astype(np.float32)
        padded = np.zeros((self.mask.shape[0], d), np.float32)
        padded[self.mask] = real
        return real, padded

    def table(self, side, d):
        """(port (S, d), JAX (S_pad, d) with zero padding rows)."""
        S, S_pad = ((self.pg.num_pts, self.jg.num_pts) if side == "point"
                    else (self.pg.num_cams, self.jg.num_cams))
        real = self.rng.standard_normal((S, d)).astype(np.float32)
        return real, np.pad(real, ((0, S_pad - S), (0, 0)))


def jax_ids(jg, side):
    if side == "point":
        return jg.pt_idx, jg.num_pts, jg.pt_segment_windows()
    return jg.cam_idx, jg.num_cams, None


def assert_close(got, want, name):
    want = np.asarray(want)
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def rows_of(side, draw):
    return draw.pg.num_pts if side == "point" else draw.pg.num_cams


@pytest.mark.parametrize("side", ["point", "camera"])
@pytest.mark.parametrize("D", [2, 32])
def test_segment_sum_matches_jax_kernels(scenes, spy, side, D):
    """Values and the gradient (the gather) against jax.vjp."""
    draw = Draw(scenes, seed=D)
    data, jdata = draw.edges(D)
    cot, jcot = draw.table(side, D)
    ids, S, window = jax_ids(draw.jg, side)
    want, vjp = jax.vjp(lambda x: jseg.segment_sum(x, ids, S, edge_mask=draw.jg.edge_mask,
                                                   indices_are_sorted=side == "point",
                                                   window=window), jnp.asarray(jdata))
    (want_d,) = vjp(jnp.asarray(jcot))
    x = torch.from_numpy(data).requires_grad_()
    got = segment_sum(x, draw.pg, side)
    (got_d,) = torch.autograd.grad(got, x, torch.from_numpy(cot))
    S_real = rows_of(side, draw)
    assert_close(got.detach().numpy(), np.asarray(want)[:S_real], "sum")
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d)[draw.mask])
    empty = list(EMPTY_POINTS) if side == "point" else [EMPTY_CAMERA]
    assert (got.detach()[empty] == 0).all()
    assert spy.get(JAX_KERNEL[("sum", side)], 0) >= 1
    assert spy.get(JAX_KERNEL[("gather", side)], 0) >= 1  # the sum's backward


@pytest.mark.parametrize("side", ["point", "camera"])
@pytest.mark.parametrize("D", [2, 32])
def test_gather_rows_matches_jax_kernels(scenes, spy, side, D):
    """Values (exact) and the gradient (the segment sum) against jax.vjp."""
    draw = Draw(scenes, seed=10 + D)
    table, jtable = draw.table(side, D)
    cot, jcot = draw.edges(D)
    ids, S, window = jax_ids(draw.jg, side)
    want, vjp = jax.vjp(lambda t: jseg.gather_segments(t, ids, S, window=window),
                        jnp.asarray(jtable))
    (want_d,) = vjp(jnp.asarray(jcot))
    t = torch.from_numpy(table).requires_grad_()
    got = gather_rows(t, draw.pg, side)
    (got_d,) = torch.autograd.grad(got, t, torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want)[draw.mask])
    assert_close(got_d.numpy(), np.asarray(want_d)[:rows_of(side, draw)], "d table")
    assert spy.get(JAX_KERNEL[("gather", side)], 0) >= 1
    assert spy.get(JAX_KERNEL[("sum", side)], 0) >= 1  # the gather's backward


@pytest.mark.parametrize("side", ["point", "camera"])
def test_segment_mean_matches_jax(scenes, side):
    """The dispatching mean (counts from the CSR offsets; empty segments
    give 0) against the JAX package's segment_mean through its kernels."""
    draw = Draw(scenes, seed=7)
    data, jdata = draw.edges(32)
    ids, S, window = jax_ids(draw.jg, side)
    want = jseg.segment_mean(jnp.asarray(jdata), ids, S, edge_mask=draw.jg.edge_mask,
                             indices_are_sorted=side == "point", window=window)
    for plain in (False, True):
        got = seg.segment_mean(torch.from_numpy(data), draw.pg, side, plain=plain)
        assert_close(got.numpy(), np.asarray(want)[:rows_of(side, draw)], f"plain={plain}")


@pytest.mark.parametrize("D", [2, 32])
def test_edge_combine_and_its_four_gradients_match_jax_kernel(scenes, spy, D):
    draw = Draw(scenes, seed=20 + D)
    pe, jpe = draw.edges(D)
    ps, jps = draw.table("point", D)
    pv, jpv = draw.table("camera", D)
    pg = draw.rng.standard_normal((1, D)).astype(np.float32)
    cot, jcot = draw.edges(D)
    want, vjp = jax.vjp(lambda a, b, c, d: jax_edge_update.edge_combine(a, b, c, d, draw.jg),
                        jnp.asarray(jpe), jnp.asarray(jps), jnp.asarray(jpv), jnp.asarray(pg))
    want_d = vjp(jnp.asarray(jcot))
    assert spy.get("fused_edge_combine", 0) >= 1
    leaves = [torch.from_numpy(a).requires_grad_() for a in (pe, ps, pv, pg)]
    got = fused_edge_combine(*leaves, draw.pg)
    got_d = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want)[draw.mask])
    np.testing.assert_array_equal(got_d[0].numpy(), np.asarray(want_d[0])[draw.mask])
    assert_close(got_d[1].numpy(), np.asarray(want_d[1])[:draw.pg.num_pts], "d ps")
    assert_close(got_d[2].numpy(), np.asarray(want_d[2])[:draw.pg.num_cams], "d pv")
    assert_close(got_d[3].numpy(), np.asarray(want_d[3]), "d pg")


def test_core_errors_device_matches_jax_through_the_plain_gather(scenes, spy):
    """Random predictions; the JAX side gathers through its Pallas kernels.
    The port's plain gather (plain=True) and its CPU dispatch agree exactly."""
    jscene, pscene, _ = scenes
    m, n = pscene.graph.num_cams, pscene.graph.num_pts
    rng = np.random.default_rng(1)
    Ps = rng.standard_normal((m, 3, 4)).astype(np.float32)
    Ps[:, :, 3] += np.array([0.0, 0.0, 4.0], np.float32)
    pts = np.concatenate([rng.standard_normal((3, n)), np.ones((1, n))]).astype(np.float32)
    jm, jn = jscene.graph.num_cams, jscene.graph.num_pts
    want = jax_core_errors(
        {"Ps_norm": jnp.asarray(np.concatenate([Ps, np.zeros((jm - m, 3, 4), np.float32)])),
         "pts3D": jnp.asarray(np.pad(pts, ((0, 0), (0, jn - n))))}, jscene)["our_repro"]
    assert spy.get("windowed_gather", 0) >= 1 and spy.get("gather_rows_kernel", 0) >= 1
    pred = {"Ps_norm": torch.from_numpy(Ps), "pts3D": torch.from_numpy(pts)}
    got = core_errors_device(pred, pscene, plain=True)["our_repro"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(core_errors_device(pred, pscene)["our_repro"]) == float(got)


@pytest.mark.parametrize("side", ["point", "camera"])
@pytest.mark.parametrize("D", [1, 2, 256])
def test_gather_rows_runs_its_plain_version_for_a_cpu_table(scenes, side, D):
    """A CPU table takes the plain version, with or without autograd: the
    rows ``table[ids]`` bitwise, in the graph's edge order, and the
    gradient the segment sum of the cotangent (a sum in another order:
    the module's tolerance)."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk

    draw = Draw(scenes, seed=30 + D)
    table = torch.from_numpy(draw.table(side, D)[0])
    ids = (draw.pg.pt_idx if side == "point" else draw.pg.cam_idx).long()
    launched = sk.gather_rows.launches
    got = gather_rows(table, draw.pg, side)
    assert got.shape == (draw.pg.num_edges, D) and torch.equal(got, table[ids])
    leaf = table.clone().requires_grad_()
    cot = torch.from_numpy(draw.edges(D)[0])
    (d,) = torch.autograd.grad(gather_rows(leaf, draw.pg, side), leaf, cot)
    assert_close(d.numpy(), seg.segment_sum(cot, ids, rows_of(side, draw)).numpy(), "d table")
    assert sk.gather_rows.launches == launched


def test_gather_rows_launcher_checks_its_operands_before_any_launch(scenes):
    """The launcher raises on an unknown side, a table of the wrong row
    count or of a width outside 1..256, and a table that is not a float32
    CUDA tensor; it never runs the plain version instead."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk

    pg = scenes[1].graph
    n, m = pg.num_pts, pg.num_cams
    with pytest.raises(ValueError, match="side must be one of"):
        sk.gather_rows(torch.zeros(n, 4), pg, "edge")
    with pytest.raises(ValueError, match=rf"expected \({m}, D\)"):
        sk.gather_rows_forward(torch.zeros(n, 4), pg, "camera")
    for width in (0, 257):
        with pytest.raises(ValueError, match="1 <= D <= 256"):
            sk.gather_rows_forward(torch.zeros(n, width), pg, "point")
    for bad in (torch.zeros(n, 4), torch.zeros(n, 4, dtype=torch.float64)):
        with pytest.raises(TypeError, match="float32 CUDA tensor"):
            sk.gather_rows_forward(bad, pg, "point")
