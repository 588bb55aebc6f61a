"""The edge-tile schedules of the frontend's forward (#3) and backward (#4)
and of the projection update's forward (#9) on the card, as plain float32
PyTorch models, against the JAX package's Pallas kernels in interpret mode.

#3 (``csrc/edge_tile.cuh``): per edge, en = relu(LN(e)) in the flax form
(var = E[x^2] - mean^2) or e under raw, then xl_p = en Wlp^T + blp and xl_c
= en Wlc^T + blc (the sum over k in order, then the bias). Two forms, chosen
by width (``front_narrow``):

- the narrow form (``frontend_fwd_narrow_kernel``, De <= 2 and Dp, Dc <=
  4, the first layer): a lane per edge, the LayerNorm's sums x0 + x1 and
  x0^2 + x1^2 in feature order, each square rounded;
- the tile form (``frontend_fwd_tile_kernel``, any widths <= 32): a row's
  32 features 4 per lane over 8 lanes, its sums in ``row_sum32``'s order
  (the lanes' butterfly xor 4, 2, 1, then (q0 + q2) + (q1 + q3) inside the
  lane), 32-edge tiles in the persistent order.

Both are held against the forward of the JAX package's ``fused_frontend``
(its ``_front_fwd_raw``, reached through ``gatv2_layer_frontend``, a spy
counting the calls): e_norm directly, xl_p and xl_c through the port's
plain dual core against its outputs; and against the plain prologue. The
grids of both forms (``front_fwd_grid``) write every edge exactly once.

#4 (``csrc/edge_tile.cuh``): per edge, dv = [d xl_p | d xl_c] [Wlp ; Wlc]
added to the cotangent of v (the sum over the rows of [Wlp ; Wlc] in
order), then the LayerNorm + ReLU backward (v = relu(LN(x)) recomputed from
x; under raw v = x and d x = dv); the weight gradients d Wlp = d xl_p^T v,
d Wlc = d xl_c^T v, d blp, d blc, d ln_scale, d ln_bias are summed per
block into one partial row (``FrontRow``: ``front_sums_len``,
``split_front_sums``), and the column sum (``column_sum_kernel``,
``test_torch_port_split_schedule.column_sum_model``) adds the rows. Two
forms:

- the tile form (``frontend_bwd_tile_kernel``, any widths <= 32): 32-edge
  tiles (``TILE_ROWS``), a persistent block taking the tiles block, block +
  grid, ... in turn; the linears' sums edge by edge in tile order, d
  ln_scale and d ln_bias per edge slot of the tile, the 32 slots merged in
  order at the end;
- the narrow form (``frontend_bwd_narrow_kernel``, De <= 2 and Dp, Dc <= 4,
  the first layer's widths): spans of eight 32-edge tiles
  (``FRONT_SPAN_ROWS``), a block taking the spans block, block + grid, ...,
  its warp w the span's tile w, lane r that tile's edge r; each lane sums
  its edges in order, then the lanes are summed by group_sum's butterfly
  (halves, then quarters, ...) and the warps in order.

Both are held against the VJP of the JAX package's ``fused_frontend`` (its
backward ``_front_bwd_raw``, reached through ``gatv2_layer_frontend``, a spy
counting the calls), fed as ``tests/test_torch_port_kernels.py``'s
``test_fused_frontend_grads_match_jax`` feeds it, at (De, Dq) = (2, 4) with
the LayerNorm (the first layer), (32, 32) with it and (32, 32) raw (the
depth head's widening layer), at two grids: three blocks (several tiles or
spans each, so the persistent order is held) and the card's cap of 3 x 132.
The cotangents of xl_p and xl_c that #4 takes from the dual core's backward
are autograd's through the port's plain dual core.

#9 (``proj_update_fwd_tile_kernel``): per edge e = ([en | skip2] W^T + c0 +
ps[pt] + pv[cam]) / 4 (+ res), c0 = b + pg, the sum over W's columns in
order, then c0, then the two gathered rows' sum; blocks take spans of two
32-edge tiles (``UPDATE_FWD_SPAN``) in the persistent order, each edge
written once. Held against ``packed_edge_update``
(its forward ``_fwd_raw``) with skip2 and the residual, bare, and with the
residual only.

Graphs: tests/test_torch_port_kernels.py's scene (1,705 edges: a ragged
last tile of 9) and tests/test_torch_port_tile_schedule.py's sub-tile graph
(23 edges, empty points and an empty camera). Tolerance as in
tests/test_torch_port_kernels.py: |err| <= 1e-5 x the reference's scale +
1e-4 x |ref| (float32 sums in another order); for the first layer's d e
with the LayerNorm the scale is at least 1, as there (over two features
the LayerNorm's d e is a near-zero difference of O(1) terms).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.graph.view_graph import WINDOW
from gasfm_tpu.ops.pallas import fused_dual_attn as jax_fused_dual_attn
from gasfm_tpu.ops.pallas import fused_proj_update as jax_fused_proj_update
from gasfm_tpu.ops.pallas.packing import pack_edges, unpack_edges
from gasfm_tpu.ops.segment import set_kernel_mode

from gasfm_tpu_torch.ops.gatv2 import layer_norm_relu
from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.kernels.fused_dual_attn import (FRONT_NARROW_DE, FRONT_NARROW_DQ,
                                                         FRONT_NARROW_THREADS, FRONT_SPAN_ROWS,
                                                         LN_EPS, front_fwd_grid, front_narrow,
                                                         front_sums_len,
                                                         frontend_prologue_plain,
                                                         fused_dual_attend_plain,
                                                         fused_frontend, split_front_sums)
from gasfm_tpu_torch.ops.kernels.fused_proj_update import (TILE_BLOCKS_PER_SM, TILE_ROWS,
                                                           UPDATE_FWD_BLOCKS_PER_SM,
                                                           UPDATE_FWD_SPAN,
                                                           projection_update_plain)

from test_torch_port_kernels import (FRONT_KEYS, HEADS, Draw, assert_close, frontend_params,
                                     jax_frontend_fn, make_graphs, padded_rows, port_grads)
from test_torch_port_split_schedule import column_sum_model
from test_torch_port_tile_schedule import H100_SMS, make_small_graphs

F32 = torch.float32  # explicit: another test module may change the default dtype
FRONT_SHAPES = [(2, 4, False), (32, 32, False), (32, 32, True)]


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_kernel_mode("interpret")
    yield
    set_kernel_mode("auto")


@pytest.fixture(scope="module")
def graphs():
    return {"scene": make_graphs(), "sub_tile": make_small_graphs()}


# ---------------------------------------------------------------------------
# #3, the frontend's forward
# ---------------------------------------------------------------------------


def row_sum32_model(x):
    """csrc/edge_tile.cuh's ``row_sum32`` of each row of x (E, 32): feature
    4 l + q on lane l's slot q; the lanes' butterfly xor 4, 2, 1 (as lane 0
    sums: l + (l + 4), then + (l + 2), then + (l + 1)), then (q0 + q2) +
    (q1 + q3)."""
    t = x.reshape(-1, 8, 4)
    t = t[:, :4] + t[:, 4:]
    t = t[:, :2] + t[:, 2:]
    t = t[:, 0] + t[:, 1]
    return (t[:, 0] + t[:, 2]) + (t[:, 1] + t[:, 3])


def frontend_fwd_model(e, lng, lnb, wlp, blp, wlc, blc, raw, eps=LN_EPS):
    """#3 as the card computes it: (en, xl_p, xl_c), en = e under raw; the
    form by width (``front_narrow``)."""
    E, De = e.shape
    if raw:
        v = e
    else:
        if front_narrow(De, wlp.shape[0], wlc.shape[0]):  # a lane per edge, feature order
            s1, s2 = torch.zeros(E, dtype=F32), torch.zeros(E, dtype=F32)
            for j in range(De):
                s1 = s1 + e[:, j]
                s2 = s2 + e[:, j] * e[:, j]
        else:  # row_sum32 over the row zero-padded to 32 features
            x = torch.cat([e, torch.zeros(E, 32 - De, dtype=F32)], 1)
            s1, s2 = row_sum32_model(x), row_sum32_model(x * x)
        inv = torch.tensor(1.0 / De, dtype=F32)
        mean = (s1 * inv)[:, None]
        var = (s2 * inv)[:, None] - mean * mean
        v = torch.relu((e - mean) * torch.rsqrt(var + eps) * lng + lnb)
    outs = []
    for w, b in ((wlp, blp), (wlc, blc)):
        acc = torch.zeros(E, w.shape[0], dtype=F32)
        for k in range(De):  # the sum over k in order, then the bias
            acc = acc + v[:, k:k + 1] * w[:, k][None, :]
        outs.append(acc + b)
    return (v, *outs)


@pytest.mark.parametrize("graph_name", ["scene", "sub_tile"])
@pytest.mark.parametrize("De,Dq,raw", FRONT_SHAPES)
def test_frontend_fwd_model_matches_fused_frontend(graphs, monkeypatch, graph_name, De, Dq, raw):
    """The model's e_norm, and the dual core's outputs from its xl_p and
    xl_c, against the JAX kernel's forward; its three outputs against the
    plain prologue."""
    calls = []

    def spy(*a, _fn=jax_fused_dual_attn._front_fwd_raw, **k):
        calls.append(1)
        return _fn(*a, **k)

    monkeypatch.setattr(jax_fused_dual_attn, "_front_fwd_raw", spy)
    jg, pg, mask = graphs[graph_name]
    draw = Draw((jg, pg, mask), seed=71 + De + raw)
    e, e_t = draw.ln_edges(De)
    p = frontend_params(draw, De, Dq)
    en, out_p, out_c = jax_frontend_fn(jg, Dq, raw)(
        *([jnp.asarray(e)] + [jnp.asarray(p[k]) for k in FRONT_KEYS]))
    assert calls  # the JAX forward kernel was reached
    t = {k: torch.from_numpy(v) for k, v in p.items() if not k.endswith("_t")}
    prm = (t["lng"], t["lnb"], t["wlp"].T.contiguous(), t["blp"], t["wlc"].T.contiguous(),
           t["blc"])
    got = frontend_fwd_model(e_t, *prm, raw)
    got_p, got_c = fused_dual_attend_plain(got[1], got[2], p["xr_p_t"], p["xr_c_t"],
                                           t["att_p"].reshape(-1), t["att_c"].reshape(-1), pg,
                                           HEADS)
    assert_close(got[0], np.asarray(en)[mask], "e_norm")
    assert_close(got_p, np.asarray(out_p).reshape(-1, Dq)[:pg.num_pts], "out_pt")
    assert_close(got_c, np.asarray(out_c).reshape(-1, Dq)[:pg.num_cams], "out_cam")
    plain = frontend_prologue_plain(e_t, *prm, eps=LN_EPS, raw_prologue=raw)
    for name, a_, b_ in zip(("en", "xl_p", "xl_c"), got, plain):
        assert_close(a_, b_, f"{name} against the plain version")


@pytest.mark.parametrize("De,Dq", [(2, 4), (1, 3), (32, 32), (4, 4), (3, 5)])
def test_frontend_fwd_grids_write_every_edge_once(graphs, monkeypatch, De, Dq):
    """``front_fwd_grid`` on the card's 132 SMs: the narrow form's blocks of
    FRONT_NARROW_THREADS lanes, a lane per edge, the last block ragged; the
    tile form's persistent blocks taking the 32-edge tiles block, block +
    grid, ..., the last tile ragged. Either writes every edge exactly once,
    on both graphs and on edge counts around a block's and a tile's."""
    monkeypatch.setattr(kb, "sm_count", lambda index: H100_SMS)
    narrow = front_narrow(De, Dq, Dq)
    assert narrow == (De <= FRONT_NARROW_DE and Dq <= FRONT_NARROW_DQ)
    counts = [g[1].num_edges for g in graphs.values()] + [1, 31, 32, 33, 255, 256, 257,
                                                          TILE_ROWS * TILE_BLOCKS_PER_SM *
                                                          H100_SMS + 5]
    for E in counts:
        grid = front_fwd_grid(torch.device("cpu"), E, De, Dq, Dq)
        written = np.zeros(E, np.int64)
        if narrow:
            assert grid == -(-E // FRONT_NARROW_THREADS)
            for b in range(grid):
                lanes = b * FRONT_NARROW_THREADS + np.arange(FRONT_NARROW_THREADS)
                np.add.at(written, lanes[lanes < E], 1)
        else:
            tiles = -(-E // TILE_ROWS)
            assert grid == min(tiles, TILE_BLOCKS_PER_SM * H100_SMS)
            for b in range(grid):
                for t in range(b, tiles, grid):
                    rows = t * TILE_ROWS + np.arange(TILE_ROWS)
                    np.add.at(written, rows[rows < E], 1)
        assert (written == 1).all(), (E, grid)


# ---------------------------------------------------------------------------
# #4, the frontend's backward
# ---------------------------------------------------------------------------


def front_edge_terms(e, den, dxl_p, dxl_c, lng, lnb, wlp, wlc, raw, eps=LN_EPS):
    """Per edge: (d x (E, De), v (E, De), dy * xhat, dy (E, De)), dy the
    cotangent through the ReLU (zeros under raw)."""
    E, De = e.shape
    dx = torch.cat([dxl_p, dxl_c], dim=1)
    wf = torch.cat([wlp, wlc], dim=0)
    dv = torch.zeros(E, De, dtype=F32) if den is None else den.clone()
    for k in range(wf.shape[0]):  # the sum over the rows of [Wlp ; Wlc] in order
        dv = dv + dx[:, k:k + 1] * wf[k:k + 1, :]
    if raw:
        zeros = torch.zeros(E, De, dtype=F32)
        return dv, e, zeros, zeros
    mean = e.sum(1, keepdim=True) / De
    var = (e * e).sum(1, keepdim=True) / De - mean * mean  # flax form
    rstd = torch.rsqrt(var + eps)
    xhat = (e - mean) * rstd
    y = xhat * lng + lnb
    dy = torch.where(y > 0, dv, torch.zeros_like(dv))
    dxh = dy * lng
    m1 = dxh.sum(1, keepdim=True) / De
    m2 = (dxh * xhat).sum(1, keepdim=True) / De
    return rstd * (dxh - m1 - xhat * m2), torch.relu(y), dy * xhat, dy


def butterfly_sum(rows):
    """Lane 0's group_sum over 32 lanes (dim 0): halves, then quarters, ..."""
    while rows.shape[0] > 1:
        half = rows.shape[0] // 2
        rows = rows[:half] + rows[half:]
    return rows[0]


def frontend_bwd_model(e, den, dxl_p, dxl_c, lng, lnb, wlp, wlc, raw, grid):
    """#4 as the card schedules it: (d e, d ln_scale, d ln_bias, d wlp,
    d blp, d wlc, d blc), the LayerNorm's None under raw."""
    E, De = e.shape
    Dp, Dc = wlp.shape[0], wlc.shape[0]
    de, v, dgs, dbs = front_edge_terms(e, den, dxl_p, dxl_c, lng, lnb, wlp, wlc, raw)
    # per edge: the partial row's entries it adds (FrontRow order)
    terms = torch.cat([(dxl_p[:, :, None] * v[:, None, :]).reshape(E, -1), dxl_p,
                       (dxl_c[:, :, None] * v[:, None, :]).reshape(E, -1), dxl_c, dgs, dbs], 1)
    L = terms.shape[1]
    assert L == front_sums_len(De, Dp, Dc)
    narrow = De <= FRONT_NARROW_DE and max(Dp, Dc) <= FRONT_NARROW_DQ
    unit = FRONT_SPAN_ROWS if narrow else TILE_ROWS
    units = -(-E // unit)
    padded = torch.cat([terms, torch.zeros(units * unit - E, L, dtype=F32)]).view(units, unit, L)
    blocks = max(1, min(grid, units))
    rows = torch.zeros(blocks, L, dtype=F32)
    for b in range(blocks):
        mine = range(b, units, blocks)  # the persistent order
        if narrow:  # lane sums over the block's spans, then the lanes, then the warps
            lanes = torch.zeros(unit, L, dtype=F32)
            for s in mine:
                lanes = lanes + padded[s]
            warps = [butterfly_sum(w) for w in lanes.view(unit // 32, 32, L)]
            total = torch.zeros(L, dtype=F32)
            for w in warps:
                total = total + w
            rows[b] = total
        else:  # the linears edge by edge in tile order, the LayerNorm per edge slot
            lin, slots = torch.zeros(L - 2 * De, dtype=F32), torch.zeros(unit, 2 * De, dtype=F32)
            for t in mine:
                for r in range(unit):
                    lin = lin + padded[t, r, :L - 2 * De]
                slots = slots + padded[t, :, L - 2 * De:]
            ln = torch.zeros(2 * De, dtype=F32)
            for r in range(unit):
                ln = ln + slots[r]
            rows[b] = torch.cat([lin, ln])
    dwlp, dblp, dwlc, dblc, dg, db = split_front_sums(column_sum_model(rows), De, Dp, Dc)
    if raw:
        dg = db = None
    return de, dg, db, dwlp, dblp, dwlc, dblc


@pytest.mark.parametrize("graph_name", ["scene", "sub_tile"])
@pytest.mark.parametrize("De,Dq,raw", FRONT_SHAPES)
def test_frontend_bwd_model_matches_fused_frontend_vjp(graphs, monkeypatch, graph_name, De, Dq,
                                                       raw):
    """The model's d e and six weight gradients against the JAX kernel's VJP,
    at three blocks and at the card's cap, and against autograd through the
    plain version."""
    calls = []

    def spy(*a, _fn=jax_fused_dual_attn._front_bwd_raw, **k):
        calls.append(1)
        return _fn(*a, **k)

    monkeypatch.setattr(jax_fused_dual_attn, "_front_bwd_raw", spy)
    jg, pg, mask = graphs[graph_name]
    E = pg.num_edges
    draw = Draw((jg, pg, mask), seed=41 + De + raw)
    e, e_t = draw.ln_edges(De)
    p = frontend_params(draw, De, Dq)
    g_en, g_p, g_c = draw.arr(E, De), draw.arr(pg.num_pts, Dq), draw.arr(pg.num_cams, Dq)
    outs, vjp = jax.vjp(jax_frontend_fn(jg, Dq, raw),
                        *([jnp.asarray(e)] + [jnp.asarray(p[k]) for k in FRONT_KEYS]))
    g_en_pad = np.zeros(outs[0].shape, np.float32)
    g_en_pad[mask] = g_en
    cots = (g_en_pad, padded_rows(g_p, jg.num_pts).reshape(outs[1].shape),
            padded_rows(g_c, jg.num_cams).reshape(outs[2].shape))
    want = dict(zip(("e",) + FRONT_KEYS, map(np.asarray, vjp(tuple(map(jnp.asarray, cots))))))
    assert calls  # the JAX backward kernel was reached

    t = {k: torch.from_numpy(v) for k, v in p.items() if not k.endswith("_t")}
    lng, lnb, wlp, wlc = t["lng"], t["lnb"], t["wlp"].T.contiguous(), t["wlc"].T.contiguous()
    # d xl_p, d xl_c: the dual core's backward, autograd through its plain version
    with torch.enable_grad():
        en = e_t if raw else layer_norm_relu(e_t, lng, lnb, LN_EPS)
        xl = [torch.nn.functional.linear(en, w, t[b]).detach().requires_grad_()
              for w, b in ((wlp, "blp"), (wlc, "blc"))]
        out_p, out_c = fused_dual_attend_plain(xl[0], xl[1], p["xr_p_t"], p["xr_c_t"],
                                               t["att_p"].reshape(-1), t["att_c"].reshape(-1),
                                               pg, HEADS)
        dxl_p, dxl_c = torch.autograd.grad((out_p, out_c), xl,
                                           (torch.from_numpy(g_p), torch.from_numpy(g_c)))
    g_en_t = torch.from_numpy(g_en)
    pairs = lambda got: ([  # noqa: E731
        # under raw e_norm is e itself: its cotangent reaches d e outside #4
        ("d e", got[0] + g_en_t if raw else got[0], want["e"][mask]),
        ("d wlp", got[3].T, want["wlp"]), ("d blp", got[4], want["blp"]),
        ("d wlc", got[5].T, want["wlc"]), ("d blc", got[6], want["blc"])]
        + ([] if raw else [("d ln_scale", got[1], want["lng"]),
                           ("d ln_bias", got[2], want["lnb"])]))

    def check(name, a_, b_):
        if name == "d e" and De == 2 and not raw:
            np.testing.assert_allclose(np.asarray(a_), b_, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            assert_close(a_, b_, name)

    for grid in (3, TILE_BLOCKS_PER_SM * H100_SMS):
        got = frontend_bwd_model(e_t, None if raw else g_en_t, dxl_p, dxl_c, lng, lnb, wlp, wlc,
                                 raw, grid)
        for name, a_, b_ in pairs(got):
            check(f"{name}, grid {grid}", a_, b_)

    leaves = dict(e=e_t, wlp=wlp, blp=t["blp"], wlc=wlc, blc=t["blc"], xr_p=p["xr_p_t"],
                  xr_c=p["xr_c_t"], att_p=t["att_p"].reshape(-1), att_c=t["att_c"].reshape(-1))
    if not raw:
        leaves.update(ln_scale=lng, ln_bias=lnb)
    plain = port_grads(lambda **a: fused_frontend(
        a["e"], a.get("ln_scale"), a.get("ln_bias"), a["wlp"], a["blp"], a["wlc"], a["blc"],
        a["xr_p"], a["xr_c"], a["att_p"], a["att_c"], pg, HEADS, eps=LN_EPS, raw_prologue=raw),
        leaves, (g_en, g_p, g_c))
    model = frontend_bwd_model(e_t, None if raw else g_en_t, dxl_p, dxl_c, lng, lnb, wlp, wlc,
                               raw, 3)
    check("d e against the plain version", model[0] + g_en_t if raw else model[0],
          plain["e"])
    for i, k in ((3, "wlp"), (4, "blp"), (5, "wlc"), (6, "blc")) + (
            () if raw else ((1, "ln_scale"), (2, "ln_bias"))):
        assert_close(model[i], plain[k], f"d {k} against the plain version")


@pytest.mark.parametrize("De,Dp,Dc", [(2, 4, 4), (32, 32, 32), (5, 3, 6)])
def test_frontend_bwd_partial_row_splits_into_the_weight_gradients(De, Dp, Dc):
    """The frontend's backward writes its weight gradients as one row per
    block (``FrontRow``, csrc/edge_tile.cuh: d wlp (Dp, De), d blp, d wlc
    (Dc, De), d blc, d ln_scale, d ln_bias) and sums the rows;
    ``split_front_sums`` hands back each gradient from a row built by hand in
    that order, as views of it."""
    gen = torch.Generator().manual_seed(De * Dp + Dc)
    want = [torch.randn(shape, generator=gen) for shape in
            ((Dp, De), (Dp,), (Dc, De), (Dc,), (De,), (De,))]
    row = torch.cat([t.reshape(-1) for t in want])
    assert row.numel() == front_sums_len(De, Dp, Dc)
    got = split_front_sums(row, De, Dp, Dc)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.data_ptr() >= row.data_ptr()
    assert got[2][Dc - 1, De - 1] == row[Dp * De + Dp + Dc * De - 1]


def test_narrow_spans_cover_every_edge_once(graphs):
    """The narrow form's spans (FRONT_SPAN_ROWS edges, eight 32-edge tiles,
    a warp each) in the persistent order with the card's grid take every
    edge once; a graph of fewer edges than a span is one block's one span,
    whose first warp alone has edges."""
    assert FRONT_SPAN_ROWS == 8 * TILE_ROWS
    for name, (_, pg, _) in graphs.items():
        E = pg.num_edges
        spans = -(-E // FRONT_SPAN_ROWS)
        for grid in (1, 3, 7, TILE_BLOCKS_PER_SM * H100_SMS):
            blocks = min(grid, spans)
            edges = [(s * 8 + w) * TILE_ROWS + lane for b in range(blocks)
                     for s in range(b, spans, blocks) for w in range(8) for lane in range(32)]
            edges = np.array([x for x in edges if x < E])
            np.testing.assert_array_equal(np.sort(edges), np.arange(E))
        assert (spans == 1) == (name == "sub_tile")


# ---------------------------------------------------------------------------
# #9, the projection update's forward
# ---------------------------------------------------------------------------


def proj_update_fwd_model(en, skip2, res, w, b, pg, ps, pv, graph, grid):
    """#9 as the card schedules it: e (E, De), each span written once in the
    persistent order."""
    E, De = en.shape[0], w.shape[0]
    a = en if skip2 is None else torch.cat([en, skip2], dim=1)
    c0 = b + pg.reshape(-1)
    spans = -(-E // UPDATE_FWD_SPAN)
    blocks = max(1, min(grid, spans))
    out = torch.full((E, De), float("nan"), dtype=F32)
    written = torch.zeros(E, dtype=torch.int64)
    gathered = ps[graph.pt_idx.long()] + pv[graph.cam_idx.long()]
    for blk in range(blocks):
        for t in range(blk, spans, blocks):
            rows = slice(t * UPDATE_FWD_SPAN, min(E, (t + 1) * UPDATE_FWD_SPAN))
            acc = torch.zeros(rows.stop - rows.start, De, dtype=F32)
            for k in range(a.shape[1]):  # the sum over W's columns in order
                acc = acc + a[rows, k:k + 1] * w[:, k][None, :]
            x = ((acc + c0) + gathered[rows]) * 0.25
            out[rows] = x if res is None else x + res[rows]
            written[rows] += 1
    assert bool((written == 1).all())
    return out


@pytest.mark.parametrize("graph_name", ["scene", "sub_tile"])
@pytest.mark.parametrize("has_skip,has_res", [(True, True), (False, False), (False, True)])
def test_proj_update_fwd_model_matches_packed_edge_update(graphs, monkeypatch, graph_name,
                                                          has_skip, has_res):
    """The model's e against the JAX kernel's forward, at three blocks and at
    the card's cap of the forward's grid, and against the plain version."""
    calls = []

    def spy(*a, _fn=jax_fused_proj_update._fwd_raw, **k):
        calls.append(1)
        return _fn(*a, **k)

    monkeypatch.setattr(jax_fused_proj_update, "_fwd_raw", spy)
    jg, pg, mask = graphs[graph_name]
    draw = Draw((jg, pg, mask), seed=61 + 2 * has_skip + has_res)
    De, d2, chunk = 32, 2, jg.chunk
    en, en_t = draw.edges(De)
    skip2, skip2_t = draw.edges(d2)
    res, res_t = draw.edges(De)
    w_e, w_uv = draw.arr(De, De, scale=0.3), draw.arr(d2, De, scale=0.3)
    b, pgl = draw.arr(De, scale=0.1), draw.arr(1, De)
    ps, ps_t = draw.pt_table(De)
    pv, pv_t = draw.cam_table(De)
    window = jg.pt_segment_windows()
    out = jax_fused_proj_update.packed_edge_update(
        pack_edges(jnp.asarray(en), chunk),
        pack_edges(jnp.asarray(skip2), chunk) if has_skip else None,
        pack_edges(jnp.asarray(res), chunk) if has_res else None, jnp.asarray(w_e),
        jnp.asarray(b), jnp.asarray(w_uv) if has_skip else None, jnp.asarray(ps),
        jnp.asarray(pv), jnp.asarray(pgl), jg.pt_idx.reshape(-1, chunk),
        jg.cam_idx.reshape(-1, chunk), window.block, jg.num_pts, jg.num_cams, WINDOW,
        interpret=True, nlive=window.nlive)
    want = np.asarray(unpack_edges(out, chunk))[mask]
    assert calls  # the JAX forward kernel was reached

    w = torch.from_numpy((np.concatenate([w_e, w_uv]) if has_skip else w_e).T.copy())
    args = (en_t, skip2_t if has_skip else None, res_t if has_res else None, w,
            torch.from_numpy(b), torch.from_numpy(pgl), ps_t, pv_t, pg)
    for grid in (3, UPDATE_FWD_BLOCKS_PER_SM * H100_SMS):
        assert_close(proj_update_fwd_model(*args, grid), want, f"e, grid {grid}")
    plain = projection_update_plain(args[0], args[1], args[2], w, args[4], ps_t, pv_t, args[5],
                                    pg)
    assert_close(proj_update_fwd_model(*args, 3), plain, "e against the plain version")
