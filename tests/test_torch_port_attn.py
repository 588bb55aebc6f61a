"""The port's single-direction attention and segment max (their plain
PyTorch versions, which is what a CPU tensor runs) against the JAX
package's Pallas kernels in interpret mode.

- The attention against ``fused_attend_h`` (``ops/pallas/fused_attn.py``),
  reached through the JAX ``gatv2_attend``: the point side windowed, the
  camera side dense, with H = 1 and 4 at D = 32; values and ``jax.vjp``
  gradients of xl, xr and att. The port's composite form
  (``gatv2_attend_composite``, the camera direction above 1024 cameras)
  against the same.
- A hub point: on a 300-view scene one point is seen by every view, so its
  edges span several chunks of the JAX kernel (the graph built at chunk
  128) and several of the port's splits (``ATTEND_CHUNK`` edges); the
  attention and its gradients against ``fused_attend_h`` there, and the
  host-side split itself (``split_segments``, ``ViewGraph.pt_chunks`` and
  ``cam_chunks``, the latter over the camera permutation's rows): every
  segment short or long, the long ones in order and cut into chunks that
  tile their edges, empty segments and degrees L, L + 1, kL.
- The segment max against ``windowed_segment_max`` (point side) and
  ``segment_max_kernel`` (camera side), reached through the JAX
  ``segment_max``: D = 1, 4 and 8, the default neutral and a caller's;
  and the CSR ``csr_segment_softmax`` against the JAX ``segment_softmax``.

The scene is tests/test_torch_port_segment_kernels.py's (9 views, 700
points, ten points and one camera left unobserved, so both sides have empty
segments), with its inputs drawn per real edge with numpy and scattered
into both layouts. A spy on the JAX kernel modules checks that each Pallas
kernel was reached.

Tolerances. Attention: |err| <= 1e-5 x the reference's scale + 1e-4 x |ref|
(float32 softmax sums in another order: an online softmax over windows
against shifted exponentials summed by ``index_add_``), gradients the same
against their own scale. The max is exact: bitwise. The softmax: rtol 1e-5,
atol 1e-7.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.ops import gatv2 as jax_gatv2
from gasfm_tpu.ops import segment as jseg
from gasfm_tpu.ops.pallas import fused_attn as jax_fused_attn
from gasfm_tpu.ops.pallas import segment_kernels as jax_segment_kernels

from gasfm_tpu_torch.graph.view_graph import ViewGraph, build_scene_graph, split_segments
from gasfm_tpu_torch.ops.gatv2 import gatv2_attend_composite
from gasfm_tpu_torch.ops.kernels.fused_attn import ATTEND_CHUNK, fused_attend
from gasfm_tpu_torch.ops.kernels.segment_kernels import segment_max
from gasfm_tpu_torch.ops.segment import csr_segment_softmax

from test_torch_port_segment_kernels import (  # noqa: F401 (fixtures)
    EMPTY_CAMERA,
    EMPTY_POINTS,
    Draw,
    _interpret_mode,
    assert_close,
    jax_ids,
    rows_of,
    scenes,
)

JAX_MAX = {"point": "windowed_segment_max", "camera": "segment_max_kernel"}
HUB_SCENE = dict(n_views=300, n_points=400, track_length_dist="powerlaw", seed=0)
HUB = 7  # the point every view sees
HUB_CHUNK = 128  # the JAX graph's edge chunk: the hub's 300 edges span at least three
L = ATTEND_CHUNK  # the port's split length


@pytest.fixture
def spy(monkeypatch):
    calls = {}
    for mod, names in ((jax_fused_attn, ("fused_attend_h",)),
                       (jax_segment_kernels, tuple(JAX_MAX.values()))):
        for name in names:
            def counted(*a, _fn=getattr(mod, name), _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, counted)
    return calls


def empty_rows(side):
    return list(EMPTY_POINTS) if side == "point" else [EMPTY_CAMERA]


def attend_inputs(draw, side, heads, D=32):
    xl, jxl = draw.edges(D)
    xr, jxr = draw.table(side, D)
    att = draw.rng.standard_normal(D).astype(np.float32)
    cot, jcot = draw.table(side, D)
    return (xl, xr, att, cot), (jxl, jxr, att, jcot)


def jax_attend(draw, side, heads, jins):
    """JAX gatv2_attend (through fused_attend_h) and jax.vjp of it."""
    jxl, jxr, att, jcot = jins
    D = jxl.shape[1]
    C = D // heads
    ids, S, window = jax_ids(draw.jg, side)

    def fn(xl, xr, a):
        out = jax_gatv2.gatv2_attend(
            xl.reshape(-1, heads, C), xr.reshape(-1, heads, C), a.reshape(heads, C), ids, S,
            edge_mask=draw.jg.edge_mask, indices_are_sorted=side == "point", window=window)
        return out.reshape(-1, D)

    want, vjp = jax.vjp(fn, jnp.asarray(jxl), jnp.asarray(jxr), jnp.asarray(att))
    return np.asarray(want), [np.asarray(g) for g in vjp(jnp.asarray(jcot))]


@pytest.mark.parametrize("side", ["point", "camera"])
@pytest.mark.parametrize("heads", [1, 4])
def test_fused_attend_matches_jax_kernel(scenes, spy, side, heads):
    draw = Draw(scenes, seed=30 + heads)
    (xl, xr, att, cot), jins = attend_inputs(draw, side, heads)
    want, (want_dxl, want_dxr, want_datt) = jax_attend(draw, side, heads, jins)
    assert spy.get("fused_attend_h", 0) >= 1
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xl, xr, att)]
    got = fused_attend(*leaves, draw.pg, side, heads)
    dxl, dxr, datt = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    S = rows_of(side, draw)
    assert_close(got.detach().numpy(), want[:S], "out")
    assert (got.detach()[empty_rows(side)] == 0).all()
    assert_close(dxl.numpy(), want_dxl[draw.mask], "d xl")
    assert_close(dxr.numpy(), want_dxr[:S], "d xr")
    assert_close(datt.numpy(), want_datt, "d att")


@pytest.mark.parametrize("side", ["point", "camera"])
def test_composite_attention_matches_jax_kernel(scenes, spy, side):
    """The composite form the port runs for the cameras above 1024 (its
    gather, segment-max and segment-sum plain versions here) computes the
    kernel's function: values and gradients."""
    heads = 4
    draw = Draw(scenes, seed=40)
    (xl, xr, att, cot), jins = attend_inputs(draw, side, heads)
    want, (want_dxl, want_dxr, want_datt) = jax_attend(draw, side, heads, jins)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xl, xr, att)]
    got = gatv2_attend_composite(*leaves, draw.pg, side, heads)
    dxl, dxr, datt = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    S = rows_of(side, draw)
    assert_close(got.detach().numpy(), want[:S], "out")
    assert_close(dxl.numpy(), want_dxl[draw.mask], "d xl")
    assert_close(dxr.numpy(), want_dxr[:S], "d xr")
    assert_close(datt.numpy(), want_datt, "d att")


@pytest.mark.parametrize("side", ["point", "camera"])
@pytest.mark.parametrize("D", [1, 4, 8])
@pytest.mark.parametrize("neutral", [-np.inf, -7.5])
def test_segment_max_matches_jax_kernels_bitwise(scenes, spy, side, D, neutral):
    draw = Draw(scenes, seed=50 + D)
    data, jdata = draw.edges(D)
    ids, S, window = jax_ids(draw.jg, side)
    want = np.asarray(jseg.segment_max(jnp.asarray(jdata), ids, S, draw.jg.edge_mask,
                                       side == "point", neutral, window=window))
    assert spy.get(JAX_MAX[side], 0) >= 1
    got = segment_max(torch.from_numpy(data), draw.pg, side, neutral).numpy()
    np.testing.assert_array_equal(got, want[:rows_of(side, draw)])
    assert (got[empty_rows(side)] == neutral).all()


@pytest.mark.parametrize("side", ["point", "camera"])
def test_csr_segment_softmax_matches_jax(scenes, side):
    draw = Draw(scenes, seed=60)
    data, jdata = draw.edges(4)
    ids, S, window = jax_ids(draw.jg, side)
    want = np.asarray(jseg.segment_softmax(jnp.asarray(jdata), ids, S, draw.jg.edge_mask,
                                           side == "point", window=window))
    got = csr_segment_softmax(torch.from_numpy(data), draw.pg, side).numpy()
    np.testing.assert_allclose(got, want[draw.mask], rtol=1e-5, atol=1e-7)
    flat = csr_segment_softmax(torch.from_numpy(data[:, 0]), draw.pg, side).numpy()
    np.testing.assert_array_equal(flat, got[:, 0])


@pytest.mark.parametrize("side", ["point", "camera"])
def test_leaky_relu_derivative_at_zero_matches_jax(scenes, spy, side):
    """Exact zeros reach the LeakyReLU (a stateless layer's zero query bias
    over source rows that the ReLU prologue zeroed): its derivative there
    is 1 in the JAX package (``where(z >= 0, ...)``) and in the kernels,
    and so in the plain version. A tenth of the rows and every query are 0
    here; torch's own leaky_relu (slope at 0) would part from JAX by the
    whole softmax-gradient term of those rows."""
    heads = 4
    draw = Draw(scenes, seed=70)
    (xl, xr, att, cot), (jxl, jxr, jatt, jcot) = attend_inputs(draw, side, heads)
    zero = np.arange(xl.shape[0]) % 10 == 0
    xl[zero] = 0.0
    jxl[draw.mask] = xl
    xr[:] = 0.0
    jxr[:] = 0.0
    want, (want_dxl, want_dxr, want_datt) = jax_attend(draw, side, heads, (jxl, jxr, jatt, jcot))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xl, xr, att)]
    got = fused_attend(*leaves, draw.pg, side, heads)
    dxl, dxr, datt = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    S = rows_of(side, draw)
    assert_close(got.detach().numpy(), want[:S], "out")
    assert_close(dxl.numpy(), want_dxl[draw.mask], "d xl")
    assert_close(dxr.numpy(), want_dxr[:S], "d xr")
    assert_close(datt.numpy(), want_datt, "d att")


@pytest.fixture(scope="module")
def hub_scenes():
    """HUB_SCENE with point HUB observed in every view (~2.7k edges)."""
    data = jax_synthetic_scene(**HUB_SCENE)
    M = data.M.copy()
    M[:, HUB] = np.random.default_rng(5).uniform(400.0, 600.0, M.shape[0])
    jscene = jax_build_scene_graph(M, data.Ns, data.y, chunk=HUB_CHUNK)
    pscene = build_scene_graph(M, data.Ns, data.y, device="cpu")
    jg, pg = jscene.graph, pscene.graph
    mask = np.asarray(jg.edge_mask)
    assert mask.sum() == pg.num_edges
    assert np.array_equal(np.asarray(jg.pt_idx)[mask], pg.pt_idx.numpy())
    assert np.array_equal(np.asarray(jg.cam_idx)[mask], pg.cam_idx.numpy())
    assert jg.chunk == HUB_CHUNK and jg.pt_segment_windows() is not None
    return jscene, pscene, mask


@pytest.mark.parametrize("heads", [1, 4])
def test_fused_attend_hub_point_matches_jax_kernel(hub_scenes, spy, heads):
    draw = Draw(hub_scenes, seed=80 + heads)
    degree = int(draw.pg.pt_ptr[HUB + 1] - draw.pg.pt_ptr[HUB])
    assert degree == HUB_SCENE["n_views"]
    assert degree >= 2 * HUB_CHUNK and degree > 4 * L
    assert HUB in draw.pg.pt_chunks(L).long_seg
    (xl, xr, att, cot), jins = attend_inputs(draw, "point", heads)
    want, (want_dxl, want_dxr, want_datt) = jax_attend(draw, "point", heads, jins)
    assert spy.get("fused_attend_h", 0) >= 1
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xl, xr, att)]
    got = fused_attend(*leaves, draw.pg, "point", heads)
    dxl, dxr, datt = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    S = rows_of("point", draw)
    assert_close(got.detach().numpy(), want[:S], "out")
    assert_close(dxl.numpy(), want_dxl[draw.mask], "d xl")
    assert_close(dxr.numpy(), want_dxr[:S], "d xr")
    assert_close(datt.numpy(), want_datt, "d att")



def graph_of_degrees(degrees, side):
    """A port ViewGraph whose ``side`` segments have ``degrees`` edges: on
    the point side the edges run point by point, each on one of three
    cameras; on the camera side each edge has a point of its own and the
    cameras' edges come in a seeded shuffle, so ``cam_perm`` is not sorted."""
    deg = np.asarray(degrees, dtype=np.int64)
    ids = np.repeat(np.arange(deg.shape[0]), deg)
    E = ids.shape[0]
    if side == "point":
        pt_idx, cam_idx, n, m = ids, np.arange(E) % 3, deg.shape[0], 3
    else:
        pt_idx, cam_idx = np.arange(E), np.random.default_rng(3).permutation(ids)
        n, m = E, deg.shape[0]

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    def offsets(ids, S):
        return t(np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=S))]))

    return ViewGraph(uv=torch.zeros((E, 2)), cam_idx=t(cam_idx), pt_idx=t(pt_idx),
                     pt_ptr=offsets(pt_idx, n), cam_perm=t(np.argsort(cam_idx, kind="stable")),
                     cam_ptr=offsets(cam_idx, m), cam_valid=torch.ones(m, dtype=torch.bool),
                     pt_valid=torch.ones(n, dtype=torch.bool))


def side_chunks(graph, side):
    """(the side's split at L, its CSR offsets as numpy)."""
    if side == "point":
        return graph.pt_chunks(L), graph.pt_ptr.numpy()
    return graph.cam_chunks(L), graph.cam_ptr.numpy()


@pytest.mark.parametrize("side", ["point", "camera"])
@pytest.mark.parametrize("degrees", [
    [], [0, 0, 0], [1, 2, 3], [L - 1, L, L + 1], [0, 2 * L, 0, 3 * L + 5, L],
    [300, 0, L + 1, 7, 2 * L + 1, 2 * L, 0],
])
def test_split_segments_tiles_every_long_segment(degrees, side):
    deg = np.asarray(degrees, dtype=np.int64)
    graph = graph_of_degrees(degrees, side)
    sp, ptr = side_chunks(graph, side)
    np.testing.assert_array_equal(ptr, np.concatenate([[0], np.cumsum(deg)]))
    # every segment is short (at most L edges, empty ones too) or long, and
    # the long ones are listed once each, in order
    np.testing.assert_array_equal(sp.long_seg, np.flatnonzero(deg > L))
    assert sp.n_long == int((deg > L).sum())
    assert sp.n_chunks == int(sum(-(-d // L) for d in deg if d > L))
    assert sp.long_ptr[0] == 0 and sp.long_ptr[-1] == sp.n_chunks
    for i, s in enumerate(sp.long_seg):
        ks = np.arange(sp.long_ptr[i], sp.long_ptr[i + 1])
        assert (sp.chunk_seg[ks] == s).all()
        begin = sp.chunk_begin[ks]
        end = np.minimum(begin + L, ptr[s + 1])
        # the chunks tile the segment's CSR rows in order, each 1 to L of them
        assert begin[0] == ptr[s] and end[-1] == ptr[s + 1]
        np.testing.assert_array_equal(begin[1:], end[:-1])
        assert ((end - begin >= 1) & (end - begin <= L)).all()
        if side == "camera":  # the rows are cam_perm's entries: the camera's edges
            rows = graph.cam_perm.numpy()[ptr[s]:ptr[s + 1]]
            assert (graph.cam_idx.numpy()[rows] == s).all()
    want = np.concatenate([sp.chunk_seg, sp.chunk_begin, sp.long_seg, sp.long_ptr])
    np.testing.assert_array_equal(sp.table.numpy(), want)
    np.testing.assert_array_equal(sp.table.numpy(), split_segments(ptr, L).table.numpy())
    assert sp.table.dtype == torch.int32


@pytest.mark.parametrize("side", ["point", "camera"])
def test_pt_chunks_built_once_per_graph(scenes, side):
    graph = scenes[1].graph
    split, ptr = side_chunks(graph, side)
    assert side_chunks(graph, side)[0] is split
    np.testing.assert_array_equal(split.table.numpy(), split_segments(ptr, L).table.numpy())
    field = "pt_ptr" if side == "point" else "cam_ptr"
    other = dataclasses.replace(graph, **{field: getattr(graph, field).clone()})
    assert side_chunks(other, side)[0] is not split


@pytest.fixture(scope="module")
def powerlaw_graph():
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.tools.profile_forward import SCENES

    return generate_synthetic_scene(**SCENES["powerlaw"]).to_scene_graph(device="cpu").graph


@pytest.mark.parametrize("builder", ["hub_camera", "degrees", "empty", "tile_boundary",
                                     "hub_parts"])
def test_kernel_check_graphs_are_port_graphs(powerlaw_graph, builder):
    """The graphs that chip_smoke.py runs the dual core's backward and the
    layer step on (graph/check_graphs.py) keep the port's
    layout, edges by (point, camera) with both CSRs consistent, and have
    the segments they promise: a camera over every point; cameras of
    exactly L - 1, L, L + 1 and 2L edges and a point of 133; empty points
    and an empty camera; a point over four 32-edge tiles and E not a
    multiple of 32; a point over all of 4,500 cameras."""
    from gasfm_tpu_torch.graph import check_graphs as cg

    g = powerlaw_graph
    graph = {"hub_camera": lambda: cg.hub_camera_graph(g), "degrees": lambda: cg.degree_graph(g),
             "empty": lambda: cg.graph_with_empty_segments(g),
             "tile_boundary": lambda: cg.tile_boundary_graph("cpu"),
             "hub_parts": lambda: cg.hub_parts_graph("cpu")}[builder]()
    pt, cam = graph.pt_idx.long(), graph.cam_idx.long()
    n, m = graph.num_pts, graph.num_cams
    key = pt * m + cam
    assert (key[1:] > key[:-1]).all()  # point-major, each (point, camera) once
    np.testing.assert_array_equal(graph.pt_ptr.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(pt.numpy(), minlength=n))]))
    np.testing.assert_array_equal(graph.cam_ptr.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(cam.numpy(), minlength=m))]))
    perm = graph.cam_perm.long()
    assert (cam[perm][1:] >= cam[perm][:-1]).all()
    assert sorted(perm.tolist()) == list(range(graph.num_edges))
    pdeg = (graph.pt_ptr[1:] - graph.pt_ptr[:-1]).tolist()
    cdeg = (graph.cam_ptr[1:] - graph.cam_ptr[:-1]).tolist()
    assert graph.pt_valid.shape[0] == n and graph.cam_valid.shape[0] == m
    if builder == "hub_camera":
        assert m == g.num_cams + 1 and cdeg[-1] == n == g.num_pts
        assert graph.num_edges == g.num_edges + n
    elif builder == "degrees":
        assert cdeg[-4:] == [L - 1, L, L + 1, 2 * L] and pdeg[-1] == 133
        assert graph.num_edges == g.num_edges + 5 * L + 133
    elif builder == "hub_parts":
        assert m == 4500 and pdeg[0] == m and all(1 <= d <= 5 for d in pdeg[1:])
    elif builder == "empty":
        assert all(pdeg[p] == 0 for p in range(0, n, 50)) and cdeg[1] == 0
    else:
        assert pdeg[0] > 3 * 32 and cdeg[5] == 0 and 0 in pdeg
        assert graph.num_edges % 32 != 0
