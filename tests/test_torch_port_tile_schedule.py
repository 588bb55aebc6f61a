"""The schedule of the projection update's backward (#10) on the card, as a
plain float32 PyTorch model, against the JAX package's Pallas kernel
(``gasfm_tpu/ops/pallas/fused_proj_update.py`` ``_bwd_raw``, reached through
``packed_edge_update``'s VJP) in interpret mode.

The card's backward (``csrc/edge_tile.cuh`` ``proj_update_bwd_tile_kernel``)
cuts the edges into tiles of 32 (``TILE_ROWS``); a persistent block takes
the tiles block, block + grid, ... in turn, and for each tile computes du =
g / 4, [d en | d skip2] = du W per edge (the sum over W's rows in order),
and adds du^T [en | skip2] and the column sums of du to its d W and d b,
edge by edge in tile order. Each block writes one partial row; the column
sum (``csrc/common.cuh`` ``column_sum_kernel``) adds the rows in eight
interleaved groups, then the groups in order
(``test_torch_port_split_schedule.column_sum_model``). d ps and d pv are the segment
sum of g at scale 1/4 (its split-walk model,
``test_torch_port_split_schedule.split_sum_model``). The model here takes
the same order in float32, and is held against the JAX kernel, fed as
``tests/test_torch_port_depth.py``'s
``test_projection_update_matches_packed_edge_update`` feeds it, with skip2
and without, with the residual and without, at two grids: three blocks
(several tiles each, so the persistent order is held) and the card's cap of
3 x 132 (one tile per block).

Graphs: tests/test_torch_port_kernels.py's scene (1,705 edges: a ragged
last tile of 9) and a sub-tile graph (4 views, 12 points, 23 edges: fewer
than one tile, points 1 and 5 and camera 2 without edges). Tolerance as in
tests/test_torch_port_kernels.py: |err| <= 1e-5 x the reference's scale +
1e-4 x |ref| (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import WINDOW
from gasfm_tpu.graph.view_graph import build_view_graph as jax_build_view_graph
from gasfm_tpu.ops.pallas import fused_proj_update as jax_fused_proj_update
from gasfm_tpu.ops.pallas.packing import pack_edges, unpack_edges
from gasfm_tpu.ops.segment import set_kernel_mode

from gasfm_tpu_torch.graph.view_graph import build_view_graph
from gasfm_tpu_torch.ops.kernels.fused_proj_update import (TILE_BLOCKS_PER_SM, TILE_ROWS,
                                                           projection_update_plain)

from test_torch_port_kernels import Draw, assert_close, make_graphs, port_grads
from test_torch_port_split_schedule import column_sum_model, split_sum_model

H100_SMS = 132
F32 = torch.float32  # explicit: another test module may change the default dtype


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_kernel_mode("interpret")
    yield
    set_kernel_mode("auto")


def make_small_graphs():
    """A graph of fewer edges than one tile, with empty points and an empty
    camera: (JAX graph, port graph, JAX real-edge mask)."""
    data = jax_synthetic_scene(n_views=4, n_points=12, visibility=0.5, seed=3)
    M = data.M.copy()
    M[:, 5] = 0.0
    M[4:6] = 0.0  # camera 2
    jg = jax_build_view_graph(M, data.Ns)
    pg = build_view_graph(M, data.Ns, device="cpu")
    mask = np.asarray(jg.edge_mask)
    assert mask.sum() == pg.num_edges
    return jg, pg, mask


@pytest.fixture(scope="module")
def graphs():
    return {"scene": make_graphs(), "sub_tile": make_small_graphs()}


def proj_update_bwd_model(g, en, skip2, w, graph, grid):
    """#10 as the card schedules it: (d en, d skip2, d W, d b, d ps, d pv)."""
    E, De = g.shape
    a = en if skip2 is None else torch.cat([en, skip2], dim=1)
    d_in, K = en.shape[1], a.shape[1]
    du = g * 0.25
    o = torch.zeros(E, K, dtype=F32)
    for j in range(De):  # [d en | d skip2] = du W, the sum over j in order
        o = o + du[:, j:j + 1] * w[j:j + 1, :]
    tiles = -(-E // TILE_ROWS)
    pad = tiles * TILE_ROWS - E  # rows past E: du and a are zeros
    du_t = torch.cat([du, torch.zeros(pad, De, dtype=F32)]).view(tiles, TILE_ROWS, De)
    a_t = torch.cat([a, torch.zeros(pad, K, dtype=F32)]).view(tiles, TILE_ROWS, K)
    blocks = min(grid, tiles)
    rows = torch.zeros(blocks, De * K + De, dtype=F32)
    for b in range(blocks):
        dw, db = torch.zeros(De, K, dtype=F32), torch.zeros(De, dtype=F32)
        for t in range(b, tiles, blocks):  # the persistent order
            for r in range(TILE_ROWS):
                dw = dw + du_t[t, r][:, None] * a_t[t, r][None, :]
                db = db + du_t[t, r]
        rows[b] = torch.cat([dw.reshape(-1), db])
    sums = column_sum_model(rows)
    dps = split_sum_model(g, graph, "point") * 0.25
    dpv = split_sum_model(g, graph, "camera") * 0.25
    return (o[:, :d_in], None if skip2 is None else o[:, d_in:], sums[:De * K].view(De, K),
            sums[De * K:], dps, dpv)


@pytest.mark.parametrize("graph_name", ["scene", "sub_tile"])
@pytest.mark.parametrize("has_skip,has_res", [(True, True), (True, False), (False, True),
                                              (False, False)])
def test_tile_model_matches_packed_update_vjp(graphs, monkeypatch, graph_name, has_skip,
                                              has_res):
    """The model's six gradients (d res = g needs no kernel) against the JAX
    kernel's VJP, at three blocks and at the card's cap, and the plain
    version's (autograd through ``projection_update_plain``) against both."""
    calls = []

    def spy(*a, _fn=jax_fused_proj_update._bwd_raw, **k):
        calls.append(1)
        return _fn(*a, **k)

    monkeypatch.setattr(jax_fused_proj_update, "_bwd_raw", spy)
    jg, pg, mask = graphs[graph_name]
    E = pg.num_edges
    assert (E < TILE_ROWS) == (graph_name == "sub_tile") and E % TILE_ROWS != 0
    if graph_name == "sub_tile":
        pdeg, cdeg = pg.pt_ptr[1:] - pg.pt_ptr[:-1], pg.cam_ptr[1:] - pg.cam_ptr[:-1]
        assert (pdeg == 0).sum() >= 2 and (cdeg == 0).sum() == 1
    draw = Draw((jg, pg, mask), seed=31 + 2 * has_skip + has_res)
    De, d2, chunk = 32, 2, jg.chunk
    en, en_t = draw.edges(De)
    skip2, skip2_t = draw.edges(d2)
    res, res_t = draw.edges(De)
    w_e, w_uv = draw.arr(De, De, scale=0.3), draw.arr(d2, De, scale=0.3)
    b, pgl = draw.arr(De, scale=0.1), draw.arr(1, De)
    ps, ps_t = draw.pt_table(De)
    pv, pv_t = draw.cam_table(De)
    g = draw.arr(E, De)
    keys = tuple(k for k in ("en", "skip2", "res", "w_e", "b", "w_uv", "ps", "pv", "pg")
                 if (has_skip or k not in ("skip2", "w_uv")) and (has_res or k != "res"))
    vals = dict(en=en, skip2=skip2, res=res, w_e=w_e, b=b, w_uv=w_uv, ps=ps, pv=pv, pg=pgl)
    window = jg.pt_segment_windows()

    def f(*args):
        u = dict(zip(keys, args))
        out = jax_fused_proj_update.packed_edge_update(
            pack_edges(u["en"], chunk), pack_edges(u["skip2"], chunk) if has_skip else None,
            pack_edges(u["res"], chunk) if has_res else None, u["w_e"], u["b"], u.get("w_uv"),
            u["ps"], u["pv"], u["pg"], jg.pt_idx.reshape(-1, chunk),
            jg.cam_idx.reshape(-1, chunk), window.block, jg.num_pts, jg.num_cams, WINDOW,
            interpret=True, nlive=window.nlive)
        return unpack_edges(out, chunk)

    out, vjp = jax.vjp(f, *(jnp.asarray(vals[k]) for k in keys))
    g_pad = np.zeros(out.shape, np.float32)
    g_pad[mask] = g
    want = dict(zip(keys, map(np.asarray, vjp(jnp.asarray(g_pad)))))
    assert calls  # the JAX backward kernel was reached

    w = torch.from_numpy((np.concatenate([w_e, w_uv]) if has_skip else w_e).T.copy())
    g_t = torch.from_numpy(g)
    s2 = skip2_t if has_skip else None
    pairs = lambda got: ([("d en", got[0], want["en"][mask]),  # noqa: E731
                          ("d w_e", got[2][:, :De].T, want["w_e"]), ("d b", got[3], want["b"]),
                          ("d pg", got[3], want["pg"].reshape(-1)),
                          ("d ps", got[4], want["ps"][:pg.num_pts]),
                          ("d pv", got[5], want["pv"][:pg.num_cams])]
                         + ([("d skip2", got[1], want["skip2"][mask]),
                             ("d w_uv", got[2][:, De:].T, want["w_uv"])] if has_skip else []))
    for grid in (3, TILE_BLOCKS_PER_SM * H100_SMS):
        got = proj_update_bwd_model(g_t, en_t, s2, w, pg, grid)
        for name, a_, b_ in pairs(got):
            assert_close(a_, b_, f"{name}, grid {grid}")
    if has_res:
        assert_close(g, want["res"][mask], "d res = g")

    leaves = dict(en=en_t, w=w, b=torch.from_numpy(b), ps=ps_t, pv=pv_t,
                  pg=torch.from_numpy(pgl))
    if has_skip:
        leaves["skip2"] = skip2_t
    plain = port_grads(lambda **a: (projection_update_plain(
        a["en"], a.get("skip2"), None, a["w"], a["b"], a["ps"], a["pv"], a["pg"], pg),),
        leaves, (g,))
    model = proj_update_bwd_model(g_t, en_t, s2, w, pg, 3)
    assert_close(model[0], plain["en"], "d en against the plain version")
    assert_close(model[2], plain["w"], "d w against the plain version")
    assert_close(model[3], plain["b"], "d b against the plain version")
    assert_close(model[4], plain["ps"], "d ps against the plain version")
    assert_close(model[5], plain["pv"], "d pv against the plain version")


def test_tile_order_covers_every_edge_once(graphs):
    """The persistent order (tile = block, block + grid, ...) with the
    card's grid (at most 3 per SM, at least one tile per block) takes every
    tile once, every edge of the graph lies in exactly one tile, the last
    tile ragged; a graph of fewer edges than a tile is one block's one
    tile."""
    for name, (_, pg, _) in graphs.items():
        E = pg.num_edges
        tiles = -(-E // TILE_ROWS)
        for grid in (1, 3, 7, TILE_BLOCKS_PER_SM * H100_SMS):
            blocks = min(grid, tiles)
            order = [t for b in range(blocks) for t in range(b, tiles, blocks)]
            assert sorted(order) == list(range(tiles))
            edges = np.concatenate([np.arange(t * TILE_ROWS, min(E, (t + 1) * TILE_ROWS))
                                    for t in order])
            np.testing.assert_array_equal(np.sort(edges), np.arange(E))
        assert (tiles == 1) == (name == "sub_tile")
        assert E % TILE_ROWS == (E if name == "sub_tile" else 9)
